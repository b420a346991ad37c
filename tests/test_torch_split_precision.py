"""The arithmetic of the tensor-core kernels, on the CPU.

``csrc/flash_attention.cu`` runs its products on the tensor cores: for
bfloat16 / float16 inputs Q.K^T in 16-bit with float32 sums and P.V as
P_hi.V + P_lo.V (P split into two 16-bit values); for float32 both products
as 3xTF32 (a = a_hi + a_lo, each rounded to 10 mantissa bits to nearest,
ties away, a.b = a_hi b_hi + a_hi b_lo + a_lo b_hi). The card cannot be
asked here, so a plain-torch model of that arithmetic is held to the 2e-4
budget against ``flash_attention_plain`` and the JAX kernel (interpret
mode) at the card tests' shapes and masks, and one seeded row shows why P
is split: a single 16-bit rounding of P breaks the budget there.

Then the reference ``quant_bmm`` past 1024 keys: the uint8-softmax P.V over
2048 keys equals the JAX package's, and the float32-chunk route that
``int_matmul`` takes on CUDA is exact at worst-case uint8 x int8 codes.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.models import layers as JL

from repro_torch.core import quantize as Q
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as L

from test_torch_cuda import FLOAT_ATTN_SHAPES, FLOAT_MASKS

TOL = 2e-4                # the JAX test's budget (tests/test_kernels.py)
F32 = torch.float32


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round float32 to 10 mantissa bits, to nearest,
    ties away from zero (adding half a unit to the magnitude's bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(F32)


def dot_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products with float32 sums (each TF32 x TF32
    product is exact in float32)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def pv_split16(p: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    """P.V with P = P_hi + P_lo, two 16-bit values, into one float32 sum."""
    hi = p.to(dtype).to(F32)
    lo = (p - hi).to(dtype).to(F32)
    return lo @ v + hi @ v


def pv_single16(p: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    """P.V with P rounded once to 16 bits (what the split avoids)."""
    return p.to(dtype).to(F32) @ v


def kernel_model(q, k, v, *, dtype, pv=None, causal=False, window=None,
                 softcap=None, scale=None, bq=512, bk=512) -> torch.Tensor:
    """The float kernel's contract (``flash_attention_plain``'s blockwise
    online softmax, block skipping and masks) with the kernel's product
    arithmetic for inputs of ``dtype``; q, k, v hold values of that dtype
    as float32. Returns float32 (the kernel's result before its cast)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    bq, bk = FA._fit_blocks(Sq, Sk, bq, bk)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    wide = dtype == F32
    if pv is None:
        pv = (lambda p, vb: dot_3xtf32(p, vb)) if wide else \
            (lambda p, vb: pv_split16(p, vb, dtype))
    qs = (q * scale if wide else q).reshape(B, Hkv, g, Sq, D)
    kf, vf = k[:, :, None], v[:, :, None]
    m = torch.full((B, Hkv, g, Sq, 1), FA.NEG_INF, dtype=F32)
    l = torch.zeros((B, Hkv, g, Sq, 1), dtype=F32)
    acc = torch.zeros((B, Hkv, g, Sq, D), dtype=F32)
    for k_lo in range(0, Sk, bk):
        r0, r1 = FA.run_rows(Sq, bq, k_lo, bk, causal, window)
        if r0 == r1:
            continue
        qb = qs[:, :, :, r0:r1]
        kb = kf[:, :, :, k_lo:k_lo + bk].transpose(-1, -2)
        s = dot_3xtf32(qb, kb) if wide else (qb @ kb) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        qpos = torch.arange(r0, r1)[:, None]
        kpos = torch.arange(k_lo, k_lo + bk)[None, :]
        keep = torch.ones((r1 - r0, bk), dtype=torch.bool)
        if causal:
            keep = kpos <= qpos
        if window is not None:
            keep = keep & (kpos > qpos - window)
        s = torch.where(keep, s, FA.NEG_INF)
        m_prev = m[..., r0:r1, :]
        m_new = torch.maximum(m_prev, torch.amax(s, dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m_prev - m_new)
        l[..., r0:r1, :] = l[..., r0:r1, :] * alpha + p.sum(-1, keepdim=True)
        acc[..., r0:r1, :] = (acc[..., r0:r1, :] * alpha
                              + pv(p, vf[:, :, :, k_lo:k_lo + bk]))
        m[..., r0:r1, :] = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, Sq, D)


def _inputs(shape, dtype, seed):
    """Seeded numpy q, k, v rounded to ``dtype``, as float32 tensors."""
    B, Hq, Hkv, Sq, Sk, d = shape
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(dtype).to(F32)
                 for s in ((B, Hq, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d)))


def _excess(out, want) -> float:
    """How far |out - want| goes past 2e-4 + 2e-4 |want| (<= 0: within)."""
    return float(((out - want).abs() - TOL - TOL * want.abs()).max())


@pytest.mark.parametrize("shape", FLOAT_ATTN_SHAPES)
@pytest.mark.parametrize("mask", sorted(FLOAT_MASKS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_arithmetic_within_budget_of_plain(shape, mask, dtype):
    B, Hq, Hkv, Sq, Sk, d, bq, bk = shape
    q, k, v = _inputs((B, Hq, Hkv, Sq, Sk, d), dtype, seed=Sq + d)
    kw = dict(FLOAT_MASKS[mask], bq=bq, bk=bk)
    got = kernel_model(q, k, v, dtype=dtype, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(got).all()
    assert _excess(got, want) <= 0


@pytest.mark.parametrize("shape", FLOAT_ATTN_SHAPES[:4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_arithmetic_within_budget_of_jax(shape, dtype):
    """Against the Pallas kernel in interpret mode, on the same values (as
    float32: the JAX kernel computes in float32 whatever its input type)."""
    B, Hq, Hkv, Sq, Sk, d, bq, bk = shape
    q, k, v = _inputs((B, Hq, Hkv, Sq, Sk, d), dtype, seed=Sq + d + 1)
    for mask in ("causal", "window", "softcap"):
        kw = dict(FLOAT_MASKS[mask], bq=bq, bk=bk)
        got = kernel_model(q, k, v, dtype=dtype, **kw)
        want = np.asarray(jfa.flash_attention(
            *(jnp.asarray(t.numpy()) for t in (q, k, v)), interpret=True,
            **kw))
        assert _excess(got, _t(want)) <= 0, mask


def test_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 4, 3.0], dtype=F32)
    np.testing.assert_array_equal(
        tf32(x).numpy(), np.array([1.0 + one_ulp, -(1.0 + one_ulp), 1.0,
                                   3.0], dtype=np.float32))


def _cancelling_row(dtype, seed=3):
    """Two keys with nearly equal scores and opposite values: causal row 1
    sees both, and its output 4 (p0 - p1) / (p0 + p1) v cancels near 0."""
    rng = np.random.default_rng(seed)
    d = 64
    q = rng.standard_normal((1, 1, 2, d)).astype(np.float32)
    k = rng.standard_normal((1, 1, 2, d)).astype(np.float32)
    k[0, 0, 1] = k[0, 0, 0] + 0.05 * rng.standard_normal(d)
    v = np.zeros((1, 1, 2, d), np.float32)
    v[0, 0, 0] = 8.0 * np.sign(rng.standard_normal(d))
    v[0, 0, 1] = -v[0, 0, 0]
    return tuple(torch.from_numpy(x).to(dtype).to(F32) for x in (q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_one_16bit_rounding_of_p_breaks_the_budget(dtype):
    """On a row whose output cancels near 0 the budget is the absolute
    2e-4. One 16-bit rounding of P misses it by far (2^-9 of 8 for
    bfloat16); P_hi + P_lo keeps it."""
    q, k, v = _cancelling_row(dtype)
    kw = dict(causal=True, bq=2, bk=2)
    want = FA.flash_attention_plain(q, k, v, **kw)
    assert float(want[0, 0, 1].abs().max()) < 0.5       # it cancels
    split = kernel_model(q, k, v, dtype=dtype, **kw)
    single = kernel_model(q, k, v, dtype=dtype, **kw,
                          pv=lambda p, vb: pv_single16(p, vb, dtype))
    assert _excess(split, want) <= 0
    assert _excess(single, want) > 0


def test_single_tf32_breaks_the_budget():
    """Why float32 takes three TF32 products: one keeps 10 bits, and its
    scores alone move the output past 2e-4 at d = 128."""
    q, k, v = _inputs((1, 2, 2, 128, 128, 128), F32, seed=9)
    kw = dict(causal=True, bq=64, bk=64)
    want = FA.flash_attention_plain(q, k, v, **kw)
    qs = q / math.sqrt(128)
    one = kernel_model(tf32(qs), tf32(k), tf32(v), dtype=F32, scale=1.0,
                       pv=lambda p, vb: tf32(p) @ vb, **kw)
    three = kernel_model(q, k, v, dtype=F32, **kw)
    assert _excess(three, want) <= 0
    assert _excess(one, want) > 0


# ---------------------------------------------------------------------------
# the reference quant_bmm past 1024 keys
# ---------------------------------------------------------------------------


def test_uint8_softmax_pv_over_2048_keys_matches_jax():
    """The uint8-softmax P.V of the reference core (quant_bmm with
    unsigned_a) over 2048 keys, once refused past 1024, equals the JAX
    package's int32 product."""
    rng = np.random.default_rng(17)
    s = rng.standard_normal((1, 2, 8, 2048)).astype(np.float32) * 3
    e = np.exp(s - s.max(-1, keepdims=True))
    p = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    v = rng.standard_normal((1, 2, 2048, 64)).astype(np.float32)
    for p_scale, v_scale in ((None, None), (0.004, 0.03)):
        ours = L.quant_bmm(_t(p), _t(v),
                           None if p_scale is None else torch.tensor(p_scale),
                           None if v_scale is None else torch.tensor(v_scale),
                           unsigned_a=True)
        ref = JL.quant_bmm(jnp.asarray(p), jnp.asarray(v),
                           None if p_scale is None else jnp.float32(p_scale),
                           None if v_scale is None else jnp.float32(v_scale),
                           unsigned_a=True)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_exact_float_k_follows_the_code_ranges():
    assert Q.exact_float_k(torch.int8, torch.int8) == 1024
    assert Q.exact_float_k(torch.uint8, torch.int8) == 514
    assert Q.exact_float_k(torch.int8, torch.uint8) == 514
    assert 514 * 255 * 128 <= 2 ** 24 < 515 * 255 * 128
    with pytest.raises(TypeError):
        Q.exact_float_k(torch.int32, torch.int8)


@pytest.mark.parametrize("K", [514, 2048, 3001])
def test_float_chunk_route_is_exact_at_worst_case_codes(K):
    """The float32-chunk route int_matmul takes on CUDA, run here on CPU
    tensors: uint8 codes at 0 and 255 against int8 codes at -128 and 127
    (every product at most 32640, partial sums past 2**24 in a 1024-term
    chunk) equal an int32 matmul bit for bit."""
    rng = np.random.default_rng(K)
    a = rng.choice(np.array([0, 255, 255, 254], np.uint8), (3, 4, K))
    a[0, 0] = 255
    b = rng.choice(np.array([-128, 127, -128, -127], np.int8), (3, K, 5))
    b[0, :, 0] = -128
    got = Q.float_chunk_matmul(_t(a), _t(b))
    want = torch.matmul(_t(a).to(torch.int32), _t(b).to(torch.int32))
    assert got.dtype == torch.int32
    assert got.equal(want)
    assert int(want[0, 0, 0]) == -255 * 128 * K
