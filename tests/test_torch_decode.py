"""Port parity for the decode slice: reduced qwen2-0.5b (rope, GQA with QKV
bias, GLU) served over dense and paged KV caches by both packages on the
same numpy inputs, plus the decode kernel's plain version against the
Pallas kernel (interpret mode), the cache writes and reads, the page pool
and slot scheduler, and the engine's own guarantees (paging, preemption,
cancel, churn)."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.plan import LayerPlan as JaxLayerPlan
from repro.core.plan import PrecisionPlan as JaxPlan
from repro.kernels import ops
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.quant import ptq as jptq
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from repro.serve.scheduler import PagePool as JaxPagePool
from repro.serve.scheduler import SlotScheduler as JaxScheduler

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core.calibration import synthetic_calibration_batches
from repro_torch.core.plan import LayerPlan, PrecisionPlan
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels.backend import get_backend
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.quant import ptq
from repro_torch.serve import (PagePool, Request, Runtime, ServeEngine,
                               SlotScheduler)

from test_torch_support import GOLDEN, jax_to_numpy, rel_linf, to_jax_batches

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = [[2, 17, 9], [5, 40], [11, 3, 7, 1], [23, 8]]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _head_plan(cls, plan):
    """chip_smoke.py's decode_head_path plan: every KV cache int8_per_head,
    softmax='uint8' on the float-qkv layers."""
    return cls(tuple(
        lp.with_kv("int8_per_head") if lp.qkv.quantized else
        lp.with_kv("int8_per_head").with_dataflow(softmax="uint8")
        for lp in plan.layers), plan.float_dtype)


@pytest.fixture(scope="module")
def qw():
    """Reduced qwen2 in both packages: JAX float params carried into the
    port, and the golden plan and its decode-head variant quantized by JAX
    (calibrated on the same numpy batches) and carried across."""
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    cfg = get_config("qwen2-0.5b").reduced()
    jfp = JaxPlan.full_float(jcfg.num_layers, "float32")
    fp = PrecisionPlan.full_float(cfg.num_layers, "float32")
    jfloat_plan, float_plan = JT.build_plan(jcfg, jfp), T.build_plan(cfg, fp)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, jfp)
    params = params_from_numpy(jax_to_numpy(jparams), float_plan, "cpu")
    batches = synthetic_calibration_batches(cfg, num_batches=2, batch_size=2,
                                            seq_len=16, seed=0)
    out = {"jcfg": jcfg, "cfg": cfg, "jfloat_plan": jfloat_plan,
           "float_plan": float_plan, "jparams": jparams, "params": params,
           "batches": batches}
    golden, jgolden = PrecisionPlan.load(GOLDEN), JaxPlan.load(GOLDEN)
    for name, plan, jplan in (
            ("golden", golden, jgolden),
            ("head", _head_plan(PrecisionPlan, golden),
             _head_plan(JaxPlan, jgolden))):
        jstats = jptq.capture_stats(jparams, to_jax_batches(batches), jcfg,
                                    jfloat_plan, precision=jplan)
        jq, jqplan = jptq.apply_plan(jparams, jcfg, jplan, jstats,
                                     float_plan=jfloat_plan)
        qplan = T.build_plan(cfg, plan)
        out[name] = {"plan": plan, "jplan": jplan, "jstats": jstats,
                     "jq": jq, "jqplan": jqplan, "qplan": qplan,
                     "q": params_from_numpy(jax_to_numpy(jq), qplan, "cpu")}
    return out


# ---------------------------------------------------------------------------
# the decode kernel: plain version against the Pallas kernel
# ---------------------------------------------------------------------------


def _case(seed, *, B=3, Hkv=2, g=2, hd=8, ps=4, pps=3, per_head=False,
          lengths=None, scramble=False, hole=False):
    rng = np.random.default_rng(seed)
    NP = B * pps + 2
    q = rng.standard_normal((B, Hkv, g, hd)).astype(np.float32)
    k = rng.integers(-127, 128, (NP, ps, Hkv, hd)).astype(np.int8)
    v = rng.integers(-127, 128, (NP, ps, Hkv, hd)).astype(np.int8)
    shape = (Hkv,) if per_head else (NP, ps, Hkv)
    ks = rng.uniform(0.01, 0.05, shape).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, shape).astype(np.float32)
    lengths = np.asarray(lengths if lengths is not None
                         else [5, ps * pps, 1][:B], np.int32)
    ids = rng.permutation(NP) if scramble else np.arange(NP)
    pt = -np.ones((B, pps), np.int32)
    for b in range(B):
        for j in range(-(-int(lengths[b]) // ps)):
            pt[b, j] = ids[b * pps + j]
    if hole:
        pt[1, 1] = -1
    return q, k, v, pt, lengths, ks, vs


KERNEL_CASES = {
    "per_token": dict(),
    "per_token_softcap": dict(softcap=30.0),
    "per_head": dict(per_head=True),
    "inactive_slot": dict(lengths=[5, 0, 1]),
    "unallocated_page": dict(hole=True),
    "out_of_order_table": dict(scramble=True, per_head=True),
    "gqa7_hd64_ps16": dict(B=4, g=7, hd=64, ps=16, pps=3,
                           lengths=[40, 48, 1, 17], scramble=True),
}


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_plain_matches_pallas(name):
    kw = dict(KERNEL_CASES[name])
    softcap = kw.pop("softcap", None)
    q, k, v, pt, lengths, ks, vs = _case(len(name), **kw)
    per_head = kw.get("per_head", False)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
        jnp.asarray(lengths), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), per_head=per_head, scale=float(scale),
        softcap=softcap)
    got = DA.decode_attention(_t(q), _t(k), _t(v), _t(pt), _t(lengths),
                              k_scale=_t(ks), v_scale=_t(vs),
                              per_head=per_head, scale=float(scale),
                              softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    for b in np.nonzero(lengths == 0)[0]:
        assert bool((got[b] == 0).all())


@pytest.mark.parametrize("per_head", [False, True])
def test_plain_p_scale_matches_pallas(per_head):
    """The two-pass uint8 softmax. With one-hot values (token t carries dim
    t at unit scale) the output is the code of each probability times
    p_scale, so the codes themselves are compared: within one, on at most
    0.5% of them. With random values the float output is held to 5e-3."""
    B, Hkv, g, hd, ps, pps = 3, 2, 3, 64, 16, 4
    q, k, v, pt, lengths, ks, vs = _case(
        7, B=B, Hkv=Hkv, g=g, hd=hd, ps=ps, pps=pps, per_head=per_head,
        lengths=[64, 37, 9], scramble=True)
    p_scale = np.float32(0.6 / 255)
    onehot = np.zeros_like(v)
    for b in range(B):
        for j in range(pps):
            if pt[b, j] >= 0:
                for t in range(ps):
                    onehot[pt[b, j], t, :, j * ps + t] = 1
    ones = np.ones_like(vs)
    for vals, vsc in ((onehot, ones), (v, vs)):
        args = (q, k, vals, pt, lengths)
        want = np.asarray(ops.decode_attention(
            *map(jnp.asarray, args), k_scale=jnp.asarray(ks),
            v_scale=jnp.asarray(vsc), per_head=per_head,
            p_scale=jnp.asarray(p_scale)))
        got = DA.decode_attention(*map(_t, args), k_scale=_t(ks),
                                  v_scale=_t(vsc), per_head=per_head,
                                  p_scale=torch.tensor(p_scale)).numpy()
        if vals is onehot:
            codes = np.round(got / p_scale)
            diff = np.abs(codes - np.round(want / p_scale))
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
            assert codes.max() > 100          # the codes span the range
        else:
            assert rel_linf(want, got) <= 5e-3


@pytest.mark.parametrize("per_head", [False, True])
def test_plain_skips_out_of_range_pages(per_head):
    """A page id at or past num_pages is skipped like -1, as the kernel
    skips it."""
    q, k, v, pt, lengths, ks, vs = _case(11, per_head=per_head,
                                         lengths=[12, 9, 3])
    NP = k.shape[0]
    bad = pt.copy()
    bad[0, 1], bad[2, 0] = NP, NP + 7
    holes = np.where(bad >= NP, -1, bad)
    kw = dict(k_scale=_t(ks), v_scale=_t(vs), per_head=per_head)
    got = DA.decode_attention(_t(q), _t(k), _t(v), _t(bad), _t(lengths),
                              **kw)
    want = DA.decode_attention(_t(q), _t(k), _t(v), _t(holes), _t(lengths),
                               **kw)
    assert got.equal(want)
    assert bool((got[2] == 0).all())        # its one page skipped


@pytest.mark.parametrize("n", [1, 5, 16, 33])
def test_tree_sum_adds_halves(n):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (3, n)).astype(np.float32))
    got = DA.tree_sum(x)
    assert torch.allclose(got, x.sum(-1), rtol=1e-5, atol=1e-6)
    if n == 16:
        h = x[:, :8] + x[:, 8:]
        h = h[:, :4] + h[:, 4:]
        h = h[:, :2] + h[:, 2:]
        assert got.equal(h[:, 0] + h[:, 1])


def test_paged_operands_fold_and_decline():
    B, Hq, Hkv, hd = 2, 4, 2, 8
    q = torch.randn(B, 1, Hq, hd)
    cache = {"pages_k": torch.zeros((4, 4, Hkv, hd), dtype=torch.int8),
             "pages_v": torch.zeros((4, 4, Hkv, hd), dtype=torch.int8),
             "pages_ks": torch.ones((4, 4, Hkv)),
             "pages_vs": torch.ones((4, 4, Hkv))}
    pages = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    ops_ = DA.paged_operands(q, cache, pages,
                             positions=torch.tensor([[3], [6]]),
                             active=torch.tensor([True, False]))
    assert ops_["q"].shape == (B, Hkv, 2, hd)
    assert ops_["q"][1, 1, 0].equal(q[1, 0, 2])     # head h*g + i
    assert ops_["lengths"].tolist() == [4, 0]
    assert not ops_["per_head"]
    per_head = {k: v for k, v in cache.items() if not k.endswith("s")}
    assert DA.paged_operands(q, per_head, pages, positions=torch.zeros(
        (B, 1), dtype=torch.int32), active=None) is None  # no static scale
    floats = {k: v.float() for k, v in per_head.items()}
    assert DA.paged_operands(q, floats, pages, positions=torch.zeros(
        (B, 1), dtype=torch.int32), active=None) is None
    assert DA.paged_operands(q.expand(B, 2, Hq, hd), cache, pages,
                             positions=torch.zeros(2, dtype=torch.int32),
                             active=None) is None         # S > 1


def test_fused_claims_int8_pages_and_runs_plain_on_cpu():
    q, k, v, pt, lengths, ks, vs = _case(3)
    B, Hkv, g, hd = q.shape
    cache = {"pages_k": _t(k), "pages_v": _t(v), "pages_ks": _t(ks),
             "pages_vs": _t(vs)}
    qq = _t(q).reshape(B, 1, Hkv * g, hd)
    pos = _t(lengths - 1).reshape(B, 1)
    kw = dict(positions=pos, active=_t(lengths > 0), scale=0.3)
    kernels.reset_launches()
    out = get_backend("fused").decode_attention(qq, cache, _t(pt), **kw)
    want = DA.decode_attention_plain(_t(q), _t(k), _t(v), _t(pt),
                                     _t(lengths), k_scale=_t(ks),
                                     v_scale=_t(vs), per_head=False,
                                     scale=0.3)
    assert out.equal(want.reshape(B, 1, Hkv * g, hd))
    assert kernels.launch_counts()["decode_attention"] == 0   # plain on CPU
    for name in ("reference", "auto"):      # the same plain version
        assert get_backend(name).decode_attention(qq, cache, _t(pt),
                                                  **kw).equal(out)
    assert kernels.launch_counts()["decode_attention"] == 0
    floats = {"pages_k": _t(k).float(), "pages_v": _t(v).float()}
    for name in ("fused", "reference", "auto"):     # gather path
        assert get_backend(name).decode_attention(qq, floats, _t(pt),
                                                  **kw) is None


# ---------------------------------------------------------------------------
# rope, caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches(per_row):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 2, 64)).astype(np.float32)
    pos = (rng.integers(0, 4000, (3, 4)) if per_row
           else np.arange(4) + 1000).astype(np.int32)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = L.apply_rope(_t(x), _t(pos), 1e6).numpy()
    assert rel_linf(want, got) <= 1e-6
    np.testing.assert_allclose(
        L.rope_frequencies(64, 1e6).numpy(),
        np.asarray(JL.rope_frequencies(64, 1e6)), rtol=1e-6)


def _writes(rng, B, H, hd):
    """Three per-row steps (one inactive row, one position past the
    allocated pages) and a uniform prefill of two tokens."""
    steps = []
    for step in range(3):
        pos = np.array([step, 5 + step, 11 + step], np.int32)[:B, None]
        active = np.array([True, step != 1, True])[:B]
        steps.append((rng.standard_normal((B, 1, H, hd)).astype(np.float32),
                      pos, active))
    steps.append((rng.standard_normal((B, 2, H, hd)).astype(np.float32),
                  np.array([3, 4], np.int32), None))
    return steps


@pytest.mark.parametrize("scheme", ["float", "int8_per_token",
                                    "int8_per_head"])
def test_paged_cache_matches_jax(qw, scheme):
    """Writes and the gathering read equal the JAX package's: pages and
    positions exactly, float pages bit for bit, per-token scales within an
    ulp and codes within one (XLA's reciprocal rewrite, ROADMAP Faults)."""
    cfg = qw["cfg"]
    B, H, hd, ps = 3, cfg.num_kv_heads, cfg.head_dim, 4
    kind = cfg.layer_kinds()[0]
    jc = JT._layer_cache(qw["jcfg"], kind, B, 16, jnp.float32, page_size=ps,
                         num_pages=9, kv_scheme=scheme)
    with torch.inference_mode():
        tc = T._layer_cache(cfg, kind, B, 16, torch.float32, "cpu",
                            page_size=ps, num_pages=9, kv_scheme=scheme)
    pages = np.array([[4, 0, -1], [8, 2, 6], [1, 3, 5]], np.int32)
    sc = {"k": np.array([0.02, 0.03], np.float32),
          "v": np.array([0.04, 0.01], np.float32)}
    jsc = ({k: jnp.asarray(v) for k, v in sc.items()}
           if scheme == "int8_per_head" else None)
    tsc = ({k: _t(v) for k, v in sc.items()}
           if scheme == "int8_per_head" else None)
    rng = np.random.default_rng(11)
    with torch.inference_mode():
        for val, pos, act in _writes(rng, B, H, hd):
            new = {"k": val, "v": val * 0.5}
            jc = jax.jit(JL._paged_cache_write)(
                jc, {k: jnp.asarray(x) for k, x in new.items()},
                jnp.asarray(pos), None if act is None else jnp.asarray(act),
                jnp.asarray(pages), jsc)
            tc = L._paged_cache_write(
                tc, {k: _t(x) for k, x in new.items()}, _t(pos),
                None if act is None else _t(act), _t(pages), tsc)
        for key, leaf in jc.items():
            want, got = np.asarray(leaf), tc[key].numpy()
            assert got.dtype == want.dtype, key
            if key in ("pages_ks", "pages_vs"):
                np.testing.assert_array_max_ulp(got, want, maxulp=1)
            elif got.dtype == np.int8:
                assert np.abs(got.astype(int) - want).max() <= 1, key
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)
        (jk, jv), jpos = JL._paged_cache_read(jc, jnp.asarray(pages),
                                              ("k", "v"), jnp.float32, jsc)
        (tk, tv), tpos = L._paged_cache_read(tc, _t(pages), ("k", "v"),
                                             torch.float32, tsc)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for want, got in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=0.06 if scheme != "float" else 0)


def test_paged_write_drops_never_wrap():
    """A write to an unallocated page (-1) or an inactive row is dropped:
    the pool's last row, where a -1 index would land, stays untouched."""
    cache = {"pages_k": torch.zeros((2, 2, 1, 4)),
             "pages_v": torch.zeros((2, 2, 1, 4)),
             "pages_pos": torch.full((2, 2), -1, dtype=torch.int32),
             "pos": torch.zeros(2, dtype=torch.int32)}
    new = {"k": torch.ones((2, 1, 1, 4)), "v": torch.ones((2, 1, 1, 4))}
    out = L._paged_cache_write(cache, new, torch.tensor([[0], [3]]),
                               torch.tensor([True, False]),
                               torch.tensor([[-1, -1], [0, 1]]))
    assert not out["pages_k"].any() and (out["pages_pos"] == -1).all()
    assert out["pos"].tolist() == [1, 0]


def test_dense_cache_write_matches_jax(qw):
    cfg = qw["cfg"]
    B, H, hd, W = 3, cfg.num_kv_heads, cfg.head_dim, 6
    kind = cfg.layer_kinds()[0]
    jc = JT._layer_cache(qw["jcfg"], kind, B, W, jnp.float32)
    with torch.inference_mode():
        tc = T._layer_cache(cfg, kind, B, W, torch.float32, "cpu")
        rng = np.random.default_rng(2)
        for val, pos, act in _writes(rng, B, H, hd):
            jc = JL._cache_write(jc, {"k": jnp.asarray(val)},
                                 jnp.asarray(pos),
                                 None if act is None else jnp.asarray(act))
            tc = L._cache_write(tc, {"k": _t(val)}, _t(pos),
                                None if act is None else _t(act))
    for key in ("k", "k_pos", "pos"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]),
                                      err_msg=key)


def test_cache_geometry_and_bytes_match_jax(qw):
    cfg, jcfg = qw["cfg"], qw["jcfg"]
    n = cfg.num_layers
    for kw in ({}, {"page_size": 8},
               {"page_size": 8, "kv_schemes": ("int8_per_token",) * n},
               {"page_size": 4, "num_pages": 5,
                "kv_schemes": ("int8_per_head",) * n}):
        jcaches = JT.init_caches(jcfg, qw["jfloat_plan"], 3, 32,
                                 jnp.float32, **kw)
        caches = T.init_caches(cfg, qw["float_plan"], 3, 32, device="cpu",
                               **kw)
        assert T.cache_bytes(caches) == JT.cache_bytes(jcaches)
        assert T.kv_geometry(caches) == JT.kv_geometry(jcaches)
        if "page_size" in kw:
            # one page's bytes over every layer's paged tensors. The JAX
            # PagePool.bytes_per_page divides each leaf by its leading axis,
            # which for its scan-stacked caches is the layer axis, not the
            # page axis (ROADMAP Faults), so it is not compared here
            paged = sum(t.numel() * t.element_size() for c in caches
                        for k, t in c.items() if k.startswith("pages_"))
            pages = caches[0]["pages_pos"].shape[0]
            assert PagePool(pages, 4, 3, 8).bytes_per_page(caches) * pages \
                == paged


def test_init_caches_refuses_a_scheme_change_inside_a_group(qw):
    cfg = qw["cfg"]
    schemes = ("int8_per_token",) + ("float",) * (cfg.num_layers - 1)
    with pytest.raises(ValueError, match="inside execution group"):
        T.init_caches(cfg, qw["float_plan"], 2, 16, page_size=4,
                      kv_schemes=schemes, device="cpu")


# ---------------------------------------------------------------------------
# model, PTQ and plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan_name", ["float", "golden"])
def test_forward_matches_jax(qw, plan_name):
    batch = qw["batches"][0]
    if plan_name == "float":
        params, plan, jparams, jplan = (qw["params"], qw["float_plan"],
                                        qw["jparams"], qw["jfloat_plan"])
    else:
        g = qw["golden"]
        params, plan, jparams, jplan = g["q"], g["qplan"], g["jq"], \
            g["jqplan"]
    with torch.inference_mode():
        got = T.forward(params, {"tokens": _t(batch["tokens"])}, qw["cfg"],
                        plan)
    want, _ = JT.forward(jparams, to_jax_batches([batch])[0], qw["jcfg"],
                         jplan, compute_dtype=jnp.float32)
    assert rel_linf(np.asarray(want), got.numpy()) <= \
        (1e-5 if plan_name == "float" else 5e-3)


@pytest.mark.parametrize("paged", [None, "float", "int8_per_token"])
def test_decode_steps_match_jax(qw, paged):
    """Five continuous-batching steps of the float model: the port's logits
    against the JAX package's, per-row positions with an idle slot."""
    cfg, jcfg = qw["cfg"], qw["jcfg"]
    kw = ({} if paged is None else
          {"page_size": 4, "kv_schemes": (paged,) * cfg.num_layers})
    jcaches = JT.init_caches(jcfg, qw["jfloat_plan"], 2, 16, jnp.float32,
                             **kw)
    caches = T.init_caches(cfg, qw["float_plan"], 2, 16, device="cpu", **kw)
    pages = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    tokens = np.random.default_rng(1).integers(1, cfg.vocab_size, (5, 2, 1))
    for t in range(5):
        pos = np.array([t, max(t - 1, 0)], np.int32)
        active = np.array([True, t > 0])
        pg = pages if paged else None
        jl, jcaches = JT.decode_step(
            qw["jparams"], jnp.asarray(tokens[t], jnp.int32), jcaches,
            jnp.asarray(pos), jcfg, qw["jfloat_plan"],
            active=jnp.asarray(active), compute_dtype=jnp.float32,
            pages=None if pg is None else jnp.asarray(pg))
        with torch.inference_mode():
            tl, caches = T.decode_step(
                qw["params"], _t(tokens[t].astype(np.int32)), caches,
                _t(pos), cfg, qw["float_plan"], active=_t(active),
                pages=None if pg is None else _t(pg))
        assert rel_linf(np.asarray(jl)[active], tl.numpy()[active]) <= 1e-5


def test_capture_stats_matches_jax_per_head(qw):
    g = qw["head"]
    stats = ptq.capture_stats(qw["params"], qw["batches"], qw["cfg"],
                              qw["float_plan"], precision=g["plan"])
    assert set(stats) == set(g["jstats"])
    for layer, sites in stats.items():
        assert set(sites) == set(g["jstats"][layer])
        assert isinstance(sites["k_cache"], list)
        for site, amax in sites.items():
            np.testing.assert_allclose(amax, g["jstats"][layer][site],
                                       rtol=1e-5, err_msg=f"{layer}/{site}")


@pytest.mark.parametrize("plan_name", ["golden", "head"])
def test_apply_plan_leaves_equal_jax(qw, plan_name):
    """The port's own PTQ from JAX's stats equals the JAX-quantized tree
    carried across: GLU weights, QKV biases, kc/vc_scale and p_scale."""
    g = qw[plan_name]
    q, qplan = ptq.apply_plan(qw["params"], qw["cfg"], g["plan"],
                              g["jstats"], float_plan=qw["float_plan"])
    assert qplan == g["qplan"]
    for i, (mine, ref) in enumerate(zip(q["layers"], g["q"]["layers"])):
        assert set(mine["attn"]) == set(ref["attn"]), i
        assert set(mine["ffn"]) == {"wg", "wu", "wd"}
        assert "b" in mine["attn"]["wq"] and "b" in ref["attn"]["wk"]
        for grp in ("attn", "ffn"):
            for key, leaf in ref[grp].items():
                got = mine[grp][key]
                pairs = ([(got["w"], leaf["w"])] + [
                    (got[x], leaf[x]) for x in ("b", "xs") if x in leaf]
                    if isinstance(leaf, dict) else [(got, leaf)])
                for a, b in pairs:
                    if isinstance(b, QuantizedTensor):
                        assert a.values.equal(b.values), (i, key)
                        a, b = a.scale, b.scale
                    np.testing.assert_allclose(a.numpy(), b.numpy(),
                                               rtol=1e-6, err_msg=key)
        if plan_name == "head":
            # per-head static KV scales; the uint8 p_scale of the float-qkv
            # layers, the symmetric bmm p_scale of the int8-qkv ones
            assert mine["attn"]["kc_scale"].shape == (qw["cfg"]
                                                      .num_kv_heads,)
            assert "p_scale" in mine["attn"]


def test_apply_plan_needs_kv_stats(qw):
    plan = qw["head"]["plan"]
    stats = {k: {s: v for s, v in sites.items() if s != "k_cache"}
             for k, sites in qw["head"]["jstats"].items()}
    with pytest.raises(ValueError, match="k_cache"):
        ptq.apply_plan(qw["params"], qw["cfg"], plan, stats)


def test_plan_v2_helpers_match_jax():
    kinds = ("float", "int8_per_head", "int8_per_token", "float")
    plan = PrecisionPlan(tuple(LayerPlan().with_kv(kv) for kv in kinds),
                         "float32")
    jplan = JaxPlan(tuple(JaxLayerPlan().with_kv(kv) for kv in kinds),
                    "float32")
    assert plan.kv_schemes == jplan.kv_schemes == kinds
    assert plan.num_quant_kv == jplan.num_quant_kv == 2
    assert plan.to_dict()["schema_version"] == 2
    assert plan.fingerprint() == jplan.fingerprint()
    # a layer that quantizes only its KV cache may take the uint8 softmax
    LayerPlan(kv_cache="int8_per_head", softmax="uint8")
    with pytest.raises(ValueError, match="uint8"):
        LayerPlan(softmax="uint8")
    with pytest.raises(ValueError):
        LayerPlan().with_kv("int4")


def test_decode_head_fingerprint_matches_jax_and_chip_smoke():
    golden, jgolden = PrecisionPlan.load(GOLDEN), JaxPlan.load(GOLDEN)
    ours = _head_plan(PrecisionPlan,
                      PrecisionPlan(golden.layers * 6, golden.float_dtype))
    want = _head_plan(JaxPlan, JaxPlan(jgolden.layers * 6,
                                       jgolden.float_dtype))
    assert ours.fingerprint() == want.fingerprint()
    assert ours.to_dict()["schema_version"] == 3
    text = (ROOT / "chip_smoke.py").read_text()
    m = re.search(r'HEAD_FINGERPRINT = \("(\w+)"\s*"(\w+)"\)', text)
    assert m.group(1) + m.group(2) == want.fingerprint()


# ---------------------------------------------------------------------------
# serving: against the JAX engine, and the engine's own guarantees
# ---------------------------------------------------------------------------


def _serve_jax(qw, params, plan, temperature=0.0, **kw):
    eng = JaxEngine(qw["jcfg"], params, plan, batch_slots=2, max_len=64,
                    **kw)
    for i, p in enumerate(PROMPTS):
        eng.submit(JaxRequest(uid=i, prompt=list(p), max_tokens=6,
                              temperature=temperature))
    return {r.uid: r.output for r in eng.run()}


def _serve(qw, params, plan, prompts=PROMPTS, max_tokens=6, slots=2,
           temperature=0.0, record=None, **kw):
    eng = ServeEngine(qw["cfg"], params, plan, batch_slots=slots, max_len=64,
                      device="cpu", **kw)
    if record is not None:
        step = eng._decode

        def rec(params, caches, tokens, pos, active, pages=None):
            out, caches = step(params, caches, tokens, pos, active, pages)
            record.append(out[torch.from_numpy(active)].clone())  # live rows
            return out, caches
        eng._decode = rec
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=list(p), max_tokens=max_tokens,
                           temperature=temperature))
    return {r.uid: r.output for r in eng.run()}, eng


ENGINE_CASES = {
    "float_dense": dict(),
    "int8_per_token": dict(page_size=8, kv_cache="int8_per_token"),
    "golden_int8_per_token": dict(plan="golden", page_size=8,
                                  kv_cache="int8_per_token"),
    "calibrated_int8_per_head": dict(plan="head", page_size=8),
}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_matches_jax_engine(qw, name):
    """Reference backends of both packages, the same carried weights, the
    same KV scheme: the same tokens."""
    kw = dict(ENGINE_CASES[name])
    plan_name = kw.pop("plan", None)
    if plan_name is None:
        args = (qw["params"], qw["float_plan"])
        jargs = (qw["jparams"], qw["jfloat_plan"])
    else:
        g = qw[plan_name]
        args, jargs = (g["q"], g["qplan"]), (g["jq"], g["jqplan"])
        kw["precision"] = g["plan"]
    jkw = dict(kw)
    if "precision" in jkw:
        jkw["precision"] = qw[plan_name]["jplan"]
    ours, eng = _serve(qw, *args, **kw)
    assert ours == _serve_jax(qw, *jargs, **jkw)
    assert eng.kv_pages_in_use == 0


def test_temperature_sampling_matches_jax(qw):
    """The engine samples with its numpy generator, as the JAX engine does:
    seeded alike and fed the same logits, it draws the same tokens."""
    ours, _ = _serve(qw, qw["params"], qw["float_plan"], temperature=0.8)
    assert ours == _serve_jax(qw, qw["jparams"], qw["jfloat_plan"],
                              temperature=0.8)


def test_paged_float_equals_dense_bit_for_bit(qw):
    dense_logits, paged_logits = [], []
    dense, _ = _serve(qw, qw["params"], qw["float_plan"],
                      record=dense_logits)
    paged, eng = _serve(qw, qw["params"], qw["float_plan"], page_size=8,
                        record=paged_logits)
    assert paged == dense
    assert all(a.equal(b) for a, b in zip(dense_logits, paged_logits))
    assert eng.kv_pages_in_use == 0


@pytest.mark.parametrize("plan_name", ["golden", "head"])
def test_fused_equals_reference(qw, plan_name):
    """On the CPU the fused backend runs every kernel's plain version; it
    gives the reference's tokens and logits exactly, and the decode step
    goes through the backend (the plain version, so no launch)."""
    g = qw[plan_name]
    kw = dict(page_size=8, precision=g["plan"])
    if plan_name == "golden":
        kw["kv_cache"] = "int8_per_token"
    logits = [[], []]
    ref, _ = _serve(qw, g["q"], g["qplan"], record=logits[0], **kw)
    fused, _ = _serve(qw, g["q"], g["qplan"], record=logits[1],
                      backend="fused", **kw)
    assert fused == ref
    assert all(a.equal(b) for a, b in zip(*logits))


def test_preemption_under_pool_pressure_preserves_outputs(qw):
    args = (qw["params"], qw["float_plan"])
    roomy, _ = _serve(qw, *args, max_tokens=8, page_size=4)
    tight, eng = _serve(qw, *args, max_tokens=8, page_size=4, pool_pages=4)
    assert tight == roomy
    assert eng.stats["preemptions"] > 0 and eng.kv_pages_in_use == 0


def test_single_oversized_request_raises(qw):
    eng = ServeEngine(qw["cfg"], qw["params"], qw["float_plan"],
                      batch_slots=1, max_len=64, page_size=4, pool_pages=2,
                      device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_tokens=10))
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        eng.run()


def test_pool_grows_on_demand_and_frees(qw):
    eng = ServeEngine(qw["cfg"], qw["params"], qw["float_plan"],
                      batch_slots=2, max_len=64, page_size=4, device="cpu")
    eng.submit(Request(uid=0, prompt=[3, 5, 9], max_tokens=7))
    seen = []
    while eng.sched.busy:
        eng.step()
        seen.append(eng.kv_pages_in_use)
    assert seen[0] == 1 and max(seen) == 2 and seen[-1] == 0
    assert len(eng.sched.freed_pages) == 3        # pending invalidation
    eng.step()
    assert eng.sched.freed_pages == []
    assert (eng.caches[0]["pages_pos"] == -1).all()


def test_cancel_mid_generation_frees_pages(qw):
    eng = ServeEngine(qw["cfg"], qw["params"], qw["float_plan"],
                      batch_slots=2, max_len=64, page_size=4,
                      kv_cache="int8_per_token", device="cpu")
    victim = Request(uid=0, prompt=[3, 5, 9, 2, 8], max_tokens=20)
    eng.submit(victim)
    for _ in range(6):
        eng.step()
    held = eng.kv_pages_in_use
    assert held > 0
    assert eng.sched.cancel(victim) == "active"
    assert eng.kv_pages_in_use == 0 and len(eng.sched.freed_pages) == held
    eng.step()
    assert eng.sched.freed_pages == [] and eng.sched.evicted == 1


def test_no_cross_slot_aliasing_under_churn(qw):
    """Requests admitted into recycled slots and pages reproduce their solo
    outputs exactly, through cancellations and new arrivals."""
    cfg = qw["cfg"]
    args = (qw["params"], qw["float_plan"])
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(2, 8)))
               .tolist() for _ in range(10)]
    kw = dict(page_size=4, kv_cache="int8_per_token", max_tokens=5)
    solo = {i: _serve(qw, *args, prompts=[p], **kw)[0][0]
            for i, p in enumerate(prompts)}
    eng = ServeEngine(cfg, *args, batch_slots=3, max_len=64, page_size=4,
                      kv_cache="int8_per_token", device="cpu")
    reqs = [Request(uid=i, prompt=list(p), max_tokens=5)
            for i, p in enumerate(prompts)]
    for r in reqs[:6]:
        eng.submit(r)
    done, cancelled, tick = [], set(), 0
    while eng.sched.busy or any(r.uid not in cancelled and not r.done
                                for r in reqs):
        done.extend(eng.step())
        tick += 1
        if tick == 3:
            for r in reqs[4:6]:
                if not r.done and eng.sched.cancel(r):
                    cancelled.add(r.uid)
            for r in reqs[6:]:
                eng.submit(r)
        assert tick < 500, "engine did not drain"
    assert cancelled and len(done) == 10 - len(cancelled)
    for r in done:
        assert r.output == solo[r.uid], f"uid{r.uid} diverged in churn"


def test_engine_validates(qw):
    cfg, args = qw["cfg"], (qw["params"], qw["float_plan"])
    with pytest.raises(ValueError, match="page_size"):
        ServeEngine(cfg, *args, kv_cache="int8_per_token", device="cpu")
    bert = get_config("bert-base").reduced()
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(bert, *args, device="cpu")
    eng = ServeEngine(cfg, *args, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request(uid=0, prompt=[]))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(uid=0, prompt=[1, 2], max_tokens=7))
    # a plan that quantizes its KV cache implies the paged layout
    eng = ServeEngine(cfg, qw["head"]["q"], qw["head"]["qplan"],
                      precision=qw["head"]["plan"], device="cpu")
    assert eng.page_size == 16 and T.kv_geometry(eng.caches)[0] == \
        "int8_per_head"


def test_runtime_keys_decode_per_cache_geometry(qw):
    cfg = qw["cfg"]
    rt = Runtime(cfg, qw["float_plan"], device="cpu")
    for kw in ({"page_size": 8}, {"page_size": 8, "kv_schemes":
                                  ("int8_per_token",) * cfg.num_layers},
               {"page_size": 8}):
        rt.decode_fn(qw["params"], T.init_caches(
            cfg, qw["float_plan"], 2, 16, device="cpu", **kw))
    assert rt.stats["executables"] == 2 and rt.stats["buckets"] == []
    caches = T.init_caches(cfg, qw["float_plan"], 2, 16, device="cpu")
    logits, caches = rt.decode(qw["params"], caches, np.ones((2, 1), np.int32),
                               np.zeros(2, np.int32), np.array([True, False]))
    assert logits.shape == (2, cfg.vocab_size)
    assert caches[0]["pos"].tolist() == [1, 0] and rt.stats["calls"] == 1


def test_page_pool_and_scheduler_match_jax():
    """The same random sequence of grow / release / admit operations leaves
    the port's page table, free list and failure count equal to JAX's."""
    pool, jpool = PagePool(6, 2, 3, 3), JaxPagePool(6, 2, 3, 3)
    sched, jsched = SlotScheduler(3, pool=pool), JaxScheduler(3, pool=jpool)
    rng = np.random.default_rng(9)
    for uid in range(5):
        sched.submit(uid)
        jsched.submit(uid)
    for _ in range(60):
        op, s = int(rng.integers(0, 3)), int(rng.integers(0, 3))
        if op == 0:
            assert sched.admit() == jsched.admit()
        elif op == 1 and sched.active[s] is not None:
            n = int(rng.integers(1, 7))
            assert pool.ensure(s, n) == jpool.ensure(s, n)
        elif op == 2 and sched.active[s] is not None:
            sched.release(s)
            jsched.release(s)
        np.testing.assert_array_equal(pool.table, jpool.table)
        assert list(pool.free) == list(jpool.free)
        assert sched.freed_pages == jsched.freed_pages
        assert pool.alloc_failures == jpool.alloc_failures
    with pytest.raises(ValueError, match="pages_per_slot"):
        pool.ensure(0, 7)
    assert sched.cancel("nobody") is None
