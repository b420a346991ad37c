"""The decode kernel's split order (flash-decoding) on the CPU.

``decode_attention_plain`` deals a slot's table into splits of
``decode_split_pages`` entries, runs the page recurrence in each and
combines the splits in order; the CUDA kernel repeats that order bit for
bit (``tests/test_torch_cuda.py``) and the reference backend runs the plain
version. Here the plain version is held against the JAX package's Pallas
``decode_attention`` (interpret mode), at the JAX tests' own atol 2e-5
(``tests/test_paged_decode.py``), and against the page-sequential order it
replaced (one split covering the table), at rel-Linf 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops

from repro_torch.kernels import decode_attention as DA

from test_torch_support import rel_linf


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(seed, *, B, Hkv, g, hd, ps, pps, lengths, per_head=False,
          holes=()):
    """Pages of each slot scattered over the pool, its table filled as far
    as its length reaches (-1 past it, and at ``holes``)."""
    rng = np.random.default_rng(seed)
    NP = B * pps + 2
    q = rng.standard_normal((B, Hkv, g, hd)).astype(np.float32)
    k = rng.integers(-127, 128, (NP, ps, Hkv, hd)).astype(np.int8)
    v = rng.integers(-127, 128, (NP, ps, Hkv, hd)).astype(np.int8)
    shape = (Hkv,) if per_head else (NP, ps, Hkv)
    ks = rng.uniform(0.01, 0.05, shape).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, shape).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    ids = rng.permutation(NP)
    pt = -np.ones((B, pps), np.int32)
    for b in range(B):
        for j in range(-(-int(lengths[b]) // ps)):
            pt[b, j] = ids[b * pps + j]
    for b, j in holes:
        pt[b, j] = -1
    return q, k, v, pt, lengths, ks, vs


# name: geometry, lengths (mid-page ends, a slot of length 0 and short
# slots whose later splits are empty), per-head scales, -1 holes, softcap
CASES = {
    "mid_page_per_token": dict(B=3, Hkv=2, g=2, hd=8, ps=4, pps=6,
                               lengths=[22, 9, 0], holes=[(0, 2)]),
    "per_head_softcap": dict(B=3, Hkv=2, g=3, hd=16, ps=4, pps=7,
                             lengths=[13, 27, 1], per_head=True,
                             softcap=30.0),
    "two_pages_a_split": dict(B=3, Hkv=1, g=2, hd=8, ps=4, pps=40,
                              lengths=[157, 30, 0], holes=[(0, 5)]),
    "hd256_ps128": dict(B=2, Hkv=1, g=2, hd=256, ps=128, pps=3,
                        lengths=[300, 129]),
    "decode_path_geometry": dict(B=4, Hkv=2, g=7, hd=64, ps=16, pps=8,
                                 lengths=[96, 8, 45, 0], holes=[(2, 1)]),
}


def _both(name, p_scale=None, per_head=None):
    kw = dict(CASES[name])
    softcap = kw.pop("softcap", None)
    if per_head is not None:
        kw["per_head"] = per_head
    q, k, v, pt, lengths, ks, vs = _case(len(name), **kw)
    per_head = kw.get("per_head", False)
    scale = 1.0 / np.sqrt(q.shape[-1])
    jax_kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                  per_head=per_head, scale=float(scale), softcap=softcap)
    torch_kw = dict(k_scale=_t(ks), v_scale=_t(vs), per_head=per_head,
                    scale=float(scale), softcap=softcap)
    if p_scale is not None:
        jax_kw["p_scale"] = jnp.asarray(np.float32(p_scale))
        torch_kw["p_scale"] = torch.tensor(np.float32(p_scale))
    want = np.asarray(ops.decode_attention(
        *map(jnp.asarray, (q, k, v, pt, lengths)), **jax_kw))
    args = tuple(map(_t, (q, k, v, pt, lengths)))
    got = DA.decode_attention_plain(*args, **torch_kw)
    sequential = DA.decode_attention_plain(*args, split_pages=pt.shape[1],
                                           **torch_kw)
    return want, got, sequential, lengths


@pytest.mark.parametrize("name", list(CASES))
def test_split_order_matches_pallas(name):
    want, got, sequential, lengths = _both(name)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert rel_linf(sequential.numpy(), got.numpy()) <= 1e-6
    for b in np.nonzero(lengths == 0)[0]:
        assert bool((got[b] == 0).all())


@pytest.mark.parametrize("name", ["mid_page_per_token", "two_pages_a_split",
                                  "decode_path_geometry"])
@pytest.mark.parametrize("per_head", [False, True])
def test_split_order_p_scale_matches_pallas(name, per_head):
    """The two-pass uint8 softmax: the splits' m and l combine into the
    exact ones before the codes are taken."""
    want, got, sequential, lengths = _both(name, p_scale=0.9 / 255,
                                           per_head=per_head)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert rel_linf(sequential.numpy(), got.numpy()) <= 1e-6
    for b in np.nonzero(lengths == 0)[0]:
        assert bool((got[b] == 0).all())


@pytest.mark.parametrize("pps,split,splits", [(0, 1, 1), (1, 1, 1),
                                              (8, 1, 8), (32, 1, 32),
                                              (33, 2, 17), (256, 8, 32),
                                              (2048, 64, 32)])
def test_split_rule(pps, split, splits):
    """P from the table's width alone: at most 32 splits, so 8 pages (the
    qwen2 decode paths) take one a block and 4096 tokens on pages of 16
    take 8."""
    assert DA.decode_split_pages(pps) == split
    assert DA.decode_splits(pps, split) == splits


def test_one_split_is_the_page_sequential_order():
    """With every entry in one split the combine is the identity: the
    recurrence of the kernel before the split, element for element."""
    q, k, v, pt, lengths, ks, vs = _case(3, B=3, Hkv=2, g=2, hd=8, ps=4,
                                         pps=5, lengths=[17, 4, 9])
    args = tuple(map(_t, (q, k, v, pt, lengths)))
    kw = dict(k_scale=_t(ks), v_scale=_t(vs), per_head=False)
    one = DA.decode_attention_plain(*args, split_pages=5, **kw)
    wide = DA.decode_attention_plain(*args, split_pages=64, **kw)
    per_page = DA.decode_attention_plain(*args, **kw)
    assert one.equal(wide)
    assert DA.decode_split_pages(5) == 1 and not one.equal(per_page)
    assert rel_linf(one.numpy(), per_page.numpy()) <= 1e-6
