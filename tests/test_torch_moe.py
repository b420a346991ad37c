"""Port parity for the MoE slice: reduced mixtral-8x22b (4 layers, d_model
64, 4 experts top-2, d_ff_expert 32, sliding window 8) under the golden v4
plan in both packages, on the same numpy inputs. The routed expert GEMM's
plain version is held to the JAX package's ``ops.quant_expert_gemm`` (its
Pallas ``quant_linear`` in interpret mode), the dispatch and combine to
``_dispatch_one`` / ``_combine_one``, ``moe_block``, the per-expert stats
and PTQ leaves, the ring decode of local layers and, for the slice as a
whole, the engine's tokens to the JAX engine's."""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.plan import PrecisionPlan as JaxPlan
from repro.core.quantize import quantize as jax_quantize
from repro.core.quantize import quantize_per_token as jax_quantize_per_token
from repro.kernels import ops
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.quant import ptq as jptq
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core.calibration import synthetic_calibration_batches
from repro_torch.core.plan import PrecisionPlan
from repro_torch.core.quantize import (QuantizedTensor, quantize,
                                       quantize_per_token)
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.backend import get_backend
from repro_torch.kernels.expert_gemm import (quant_expert_gemm,
                                             quant_expert_gemm_plain)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.quant import ptq
from repro_torch.serve import Request, Runtime, ServeEngine

from test_torch_support import (GOLDEN_V4, jax_to_numpy, rel_linf,
                                to_jax_batches)

ROOT = Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.fixture(scope="module")
def mx():
    """Reduced mixtral in both packages: JAX float params carried into the
    port, and the golden v4 plan calibrated by JAX on the same numpy batches,
    quantized by JAX and carried across."""
    jcfg = jax_get_config("mixtral-8x22b").reduced()
    cfg = get_config("mixtral-8x22b").reduced()
    jfp = JaxPlan.full_float(jcfg.num_layers, "float32")
    fp = PrecisionPlan.full_float(cfg.num_layers, "float32")
    jfloat_plan, float_plan = JT.build_plan(jcfg, jfp), T.build_plan(cfg, fp)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, jfp)
    params = params_from_numpy(jax_to_numpy(jparams), float_plan, "cpu")
    batches = synthetic_calibration_batches(cfg, num_batches=2, batch_size=2,
                                            seq_len=16, seed=0)
    plan, jplan = PrecisionPlan.load(GOLDEN_V4), JaxPlan.load(GOLDEN_V4)
    jstats = jptq.capture_stats(jparams, to_jax_batches(batches), jcfg,
                                jfloat_plan, precision=jplan)
    jq, jqplan = jptq.apply_plan(jparams, jcfg, jplan, jstats,
                                 float_plan=jfloat_plan)
    qplan = T.build_plan(cfg, plan)
    return {"jcfg": jcfg, "cfg": cfg, "jfloat_plan": jfloat_plan,
            "float_plan": float_plan, "jparams": jparams, "params": params,
            "batches": batches, "plan": plan, "jplan": jplan,
            "jstats": jstats, "jq": jq, "jqplan": jqplan, "qplan": qplan,
            "q": params_from_numpy(jax_to_numpy(jq), qplan, "cpu")}


# ---------------------------------------------------------------------------
# the routed expert GEMM: plain version against the JAX package's op
# ---------------------------------------------------------------------------


GEMM_SHAPES = {"G1_C3": (1, 4, 3, 64, 32), "G2_ragged": (2, 4, 5, 36, 70)}


def _gemm_case(shape, mode, seed=0):
    G, E, C, D, F = shape
    rng = np.random.default_rng(seed + D)
    xe = rng.standard_normal((G, E, C, D)).astype(np.float32)
    wq = jptq.quantize_weight(
        jnp.asarray(rng.standard_normal((E, D, F)).astype(np.float32)))
    amax = np.abs(xe).max(axis=(0, 2, 3)).astype(np.float32)
    xs = {"scalar": np.float32(amax.max() / 127),
          "per_expert": (amax / 127).reshape(E, 1, 1),
          "per_token": None}[mode]
    return xe, wq, xs


@pytest.mark.parametrize("shape", list(GEMM_SHAPES))
@pytest.mark.parametrize("mode", ["scalar", "per_expert", "per_token"])
def test_plain_matches_pallas(shape, mode):
    """Static scales: codes equal the JAX package's and outputs are bit for
    bit its op's (both dequantize as acc * (xs * ws)). Per-token: JAX's
    jitted amax / 127 is a multiply by the reciprocal (ROADMAP Faults), so
    scales are within an ulp and codes within one; rows whose codes agree
    are within 1e-6 relative."""
    xe, wq, xs = _gemm_case(GEMM_SHAPES[shape], mode)
    want = np.asarray(ops.quant_expert_gemm(
        jnp.asarray(xe), wq.values, wq.scale,
        None if xs is None else jnp.asarray(xs)))
    got = quant_expert_gemm_plain(_t(xe), _t(wq.values), _t(wq.scale),
                                  None if xs is None else _t(xs)).numpy()
    assert got.shape == want.shape == xe.shape[:-1] + (wq.values.shape[-1],)
    if xs is not None:
        codes = quantize(_t(xe), _t(xs)).numpy()
        np.testing.assert_array_equal(
            codes, np.asarray(jax_quantize(jnp.asarray(xe), jnp.asarray(xs))))
        np.testing.assert_array_equal(got, want)
        return
    jq = jax.jit(jax_quantize_per_token)(jnp.asarray(xe))
    tq = quantize_per_token(_t(xe))
    np.testing.assert_array_max_ulp(tq.scale.numpy(), np.asarray(jq.scale),
                                    maxulp=1)
    diff = np.abs(tq.values.numpy().astype(int) - np.asarray(jq.values))
    assert diff.max() <= 1
    same = ~(diff > 0).any(axis=-1)                     # (G, E, C) rows
    assert same.any()
    assert rel_linf(want[same], got[same]) <= 1e-6


def test_wrapper_and_backends_run_the_plain_version_on_cpu():
    """On CPU tensors the wrapper and both backends' expert GEMM run the
    plain version exactly and launch nothing; a float stack declines."""
    xe, wq, xs = _gemm_case(GEMM_SHAPES["G2_ragged"], "per_expert")
    args = (_t(xe), _t(wq.values), _t(wq.scale))
    want = quant_expert_gemm_plain(*args, _t(xs))
    kernels.reset_launches()
    assert quant_expert_gemm(*args, _t(xs)).equal(want)
    w = QuantizedTensor(args[1], args[2])
    for name in ("reference", "fused", "auto"):
        b = get_backend(name)
        assert b.expert_gemm(args[0], w, _t(xs)).equal(want)
        assert b.expert_gemm(args[0], w, None).equal(
            quant_expert_gemm_plain(*args))
        assert b.expert_gemm(args[0], torch.zeros(4, 36, 70), None) is None
    assert kernels.launch_counts()["quant_expert_gemm"] == 0
    assert kernels.expert_gemm.per_token_launches == 0


def test_plain_refuses_a_wrong_scale_count():
    xe, wq, _ = _gemm_case(GEMM_SHAPES["G1_C3"], "scalar")
    with pytest.raises(ValueError, match="xs has 3 values"):
        quant_expert_gemm_plain(_t(xe), _t(wq.values), _t(wq.scale),
                                torch.ones(3))


# ---------------------------------------------------------------------------
# dispatch and combine
# ---------------------------------------------------------------------------


def _route_case(name):
    rng = np.random.default_rng(len(name))
    if name == "random":
        T_, D, E, K, C = 16, 8, 4, 2, 5
        logits = rng.standard_normal((T_, E)).astype(np.float32)
    elif name == "capacity_overflow":      # every token picks experts 0, 1
        T_, D, E, K, C = 8, 4, 4, 2, 3
        logits = np.tile(np.array([[4.0, 2.0, -4.0, -4.0]], np.float32),
                         (T_, 1))
    elif name == "zero_padding":           # buffers mostly unfilled
        T_, D, E, K, C = 4, 4, 4, 1, 8
        logits = (np.eye(E, dtype=np.float32)[np.arange(T_) % E] * 3.0)
    else:                                  # exact all-way ties
        T_, D, E, K, C = 6, 4, 4, 2, 4
        logits = np.zeros((T_, E), np.float32)
    xt = (rng.standard_normal((T_, D)) + 1.0).astype(np.float32)
    return xt, logits, E, K, C


@pytest.mark.parametrize("name", ["random", "capacity_overflow",
                                  "zero_padding", "exact_ties"])
def test_dispatch_and_combine_match_jax(name):
    """xe, the sorted tokens, keep and the slots equal JAX's exactly (ties
    go to the lower expert, as lax.top_k sends them); gates and the combine
    within 1e-6."""
    xt, logits, E, K, C = _route_case(name)
    want = JL._dispatch_one(jnp.asarray(xt), jnp.asarray(logits), E, K, C)
    got = L._dispatch_one(_t(xt), _t(logits), E, K, C)
    for key, w, g in zip(("xe", "st", "sg", "keep", "slot"), want, got):
        if key == "sg":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=key)
    T_, D = xt.shape
    ye = np.random.default_rng(7).standard_normal((E, C, D)).astype(
        np.float32)
    y_want = JL._combine_one(jnp.asarray(ye), *want[1:], T_, D, jnp.float32)
    y_got = L._combine_one(_t(ye), *got[1:], T_, D, torch.float32)
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), rtol=1e-6,
                               atol=1e-6)
    if name == "capacity_overflow":
        # C tokens survive on each of the two chosen experts; a dropped
        # assignment contributes nothing and keeps its gate
        se, keep = got[4] // C, got[3]
        assert int((keep & (se == 0)).sum()) == C == int(
            (keep & (se == 1)).sum()) and int(keep.sum()) == 2 * C
    if name == "exact_ties":
        assert set((got[4] // C)[got[3]].tolist()) <= {0, 1}


def test_dropped_routings_count_live_drops():
    """No drop when each expert can hold every token; with every token on
    experts 0 and 1 and C = 2, the six later tokens lose both routings,
    and over the live tokens {0, 5, 6} only 5's and 6's count."""
    T_, D, E, K = 8, 4, 4, 2
    xt = _t(np.ones((T_, D), np.float32))
    logits = _t(np.random.default_rng(5).standard_normal((T_, E))
                .astype(np.float32))
    _, st, _, keep, _ = L._dispatch_one(xt, logits, E, K, T_)
    assert int(L.dropped_routings(keep, st)) == 0
    skew = torch.tensor([[3.0, 2.0, 0.0, -1.0]]).repeat(T_, 1)
    _, st, _, keep, _ = L._dispatch_one(xt, skew, E, K, 2)
    assert int(L.dropped_routings(keep, st)) == 12
    live = torch.zeros(T_, dtype=torch.bool)
    live[[0, 5, 6]] = True
    assert int(L.dropped_routings(keep, st, live)) == 4
    assert int(L.dropped_routings(keep, st, torch.zeros(T_, dtype=torch.bool))
               ) == 0


def test_combine_sums_each_token_in_expert_order():
    """Three contributions per token (K = 3) whose float sum depends on the
    order: the combine adds them in ascending expert order, as JAX's
    scatter-add does, and so matches it bit for bit."""
    T_, D, E, K, C = 4, 2, 4, 3, 4
    logits = np.random.default_rng(3).standard_normal((T_, E)).astype(
        np.float32)
    xt = np.ones((T_, D), np.float32)
    want = JL._dispatch_one(jnp.asarray(xt), jnp.asarray(logits), E, K, C)
    got = L._dispatch_one(_t(xt), _t(logits), E, K, C)
    ye = np.array([1e8, 1.0, -1e8, 3.0], np.float32)[:, None, None] * \
        np.ones((E, C, D), np.float32)
    y_want = JL._combine_one(jnp.asarray(ye), *want[1:], T_, D, jnp.float32)
    y_got = L._combine_one(_t(ye), *got[1:], T_, D, torch.float32)
    np.testing.assert_array_equal(y_got.numpy(), np.asarray(y_want))


def test_per_expert_amax_matches_jax():
    xt, logits, E, K, C = _route_case("random")
    xe = JL._dispatch_one(jnp.asarray(xt), jnp.asarray(logits), E, K, C)[0]
    jobs, obs = {}, {}
    JL.observe_per_expert(jobs, "expert_in", xe[None])
    L.observe_per_expert(obs, "expert_in", _t(np.asarray(xe))[None])
    assert obs["expert_in"].shape == (E,)
    np.testing.assert_array_equal(obs["expert_in"].numpy(),
                                  np.asarray(jobs["expert_in"]))


# ---------------------------------------------------------------------------
# moe_block, the model and the ring decode
# ---------------------------------------------------------------------------


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return _t(tree)


def _moe_params(jcfg, seed):
    jp = JL.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, _tensors(jax_to_numpy(jp))


@pytest.mark.parametrize("shared", [False, True])
def test_float_moe_block_matches_jax(mx, shared):
    """A float MoE FFN, with and without a shared expert (num_shared=1 in
    both packages): within 1e-5 relative (float32 sums in another order)."""
    jcfg, cfg = mx["jcfg"], mx["cfg"]
    if shared:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, num_shared=1))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_shared=1))
    jp, p = _moe_params(jcfg, 3)
    assert ("shared" in p) == shared
    x = np.random.default_rng(5).standard_normal((2, 5, cfg.d_model)).astype(
        np.float32)
    want = JL.moe_block(jnp.asarray(x), jp, jcfg)
    got = L.moe_block(_t(x), p, cfg)
    assert rel_linf(np.asarray(want), got.numpy()) <= 1e-5


@pytest.mark.parametrize("layer", [0, 1])
def test_int8_moe_block_matches_jax(mx, layer):
    """The golden v4 expert stacks carried from JAX (layer 0 static
    per-expert scales, layer 1 per-token): the port's reference path (the
    kernel's plain version, acc * (xs * ws)) against JAX's eager reference
    einsum ((acc * xs) * ws), within 1e-5 relative."""
    p = mx["q"]["layers"][layer]["ffn"]
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                mx["jq"]["groups"][layer]["layers"][0])["ffn"]
    x = np.random.default_rng(6).standard_normal((2, 4, 64)).astype(
        np.float32)
    want = JL.moe_block(jnp.asarray(x), jp, mx["jcfg"])
    got = L.moe_block(_t(x), p, mx["cfg"])
    assert rel_linf(np.asarray(want), got.numpy()) <= 1e-5


@pytest.mark.parametrize("plan_name", ["float", "golden_v4"])
def test_forward_matches_jax(mx, plan_name):
    batch = mx["batches"][0]
    if plan_name == "float":
        args = (mx["params"], mx["float_plan"])
        jargs = (mx["jparams"], mx["jfloat_plan"])
    else:
        args, jargs = (mx["q"], mx["qplan"]), (mx["jq"], mx["jqplan"])
    with torch.inference_mode():
        got = T.forward(args[0], {"tokens": _t(batch["tokens"])}, mx["cfg"],
                        args[1])
    want, _ = JT.forward(jargs[0], to_jax_batches([batch])[0], mx["jcfg"],
                         jargs[1], compute_dtype=jnp.float32)
    assert rel_linf(np.asarray(want), got.numpy()) <= \
        (1e-5 if plan_name == "float" else 5e-3)


def test_ring_decode_past_the_window_matches_jax(mx):
    """mixtral's ring caches: twelve one-token steps through a window of 4
    (capacity factor 16, so no token drops) match the full forward within
    2e-3, as in the JAX package's own test, and JAX's decode steps within
    1e-5; the rings hold min(window, max_len) positions."""
    jcfg = mx["jcfg"].replace(sliding_window=4, moe=dataclasses.replace(
        mx["jcfg"].moe, capacity_factor=16.0))
    cfg = mx["cfg"].replace(sliding_window=4, moe=dataclasses.replace(
        mx["cfg"].moe, capacity_factor=16.0))
    B, S = 1, 12
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    with torch.inference_mode():
        full = T.forward(mx["params"], {"tokens": _t(toks)}, cfg,
                         mx["float_plan"], chunk=None)
        caches = T.init_caches(cfg, mx["float_plan"], B, S, device="cpu")
        assert caches[0]["k"].shape[1] == 4
        jcaches = JT.init_caches(jcfg, mx["jfloat_plan"], B, S, jnp.float32)
        outs = []
        for t in range(S):
            lg, caches = T.decode_step(mx["params"], _t(toks[:, t:t + 1]),
                                       caches, t, cfg, mx["float_plan"])
            jlg, jcaches = JT.decode_step(
                mx["jparams"], jnp.asarray(toks[:, t:t + 1]), jcaches, t,
                jcfg, mx["jfloat_plan"], compute_dtype=jnp.float32)
            assert rel_linf(np.asarray(jlg), lg.numpy()) <= 1e-5
            outs.append(lg[:, 0])
    assert rel_linf(full.numpy(), torch.stack(outs, 1).numpy()) < 2e-3


def test_local_layers_keep_rings_when_paged(mx):
    """A paging engine's caches on an all-local arch: dense rings of
    min(window, max_len) positions in every layer, the bytes and geometry
    of the JAX package's."""
    n = mx["cfg"].num_layers
    kw = dict(page_size=16, kv_schemes=("int8_per_token",) + ("float",)
              * (n - 1))
    for max_len in (6, 32):
        caches = T.init_caches(mx["cfg"], mx["qplan"], 4, max_len,
                               device="cpu", **kw)
        jcaches = JT.init_caches(mx["jcfg"], mx["jqplan"], 4, max_len,
                                 jnp.float32, **kw)
        assert all(set(c) == {"k", "v", "k_pos", "pos"} for c in caches)
        assert caches[0]["k"].shape[1] == min(8, max_len)
        assert T.cache_bytes(caches) == JT.cache_bytes(jcaches)
        assert T.kv_geometry(caches) == JT.kv_geometry(jcaches)


# ---------------------------------------------------------------------------
# calibration and PTQ
# ---------------------------------------------------------------------------


def test_capture_stats_matches_jax(mx):
    """Per-expert (E,) vectors at expert_in / expert_hidden, as lists like
    JAX's, equal JAX's within 1e-6 relative in layer 0; deeper layers and
    every scalar site within 1e-5 (float32 sums in another order compound
    through the layers: 1.3e-6 at layer 2's expert_hidden)."""
    stats = ptq.capture_stats(mx["params"], mx["batches"], mx["cfg"],
                              mx["float_plan"], precision=mx["plan"])
    jstats = mx["jstats"]
    assert set(stats) == set(jstats)
    E = mx["cfg"].moe.num_experts
    for layer, sites in stats.items():
        assert set(sites) == set(jstats[layer])
        for site in ("expert_in", "expert_hidden"):
            assert isinstance(sites[site], list) and len(sites[site]) == E
            np.testing.assert_allclose(
                sites[site], jstats[layer][site],
                rtol=1e-6 if layer == "layer0" else 1e-5,
                err_msg=f"{layer}/{site}")
        for site, amax in sites.items():
            np.testing.assert_allclose(amax, jstats[layer][site], rtol=1e-5,
                                       err_msg=f"{layer}/{site}")


def test_missing_expert_stats_is_actionable(mx):
    stats = {k: {s: v for s, v in sites.items() if s != "expert_in"}
             for k, sites in mx["jstats"].items()}
    with pytest.raises(ValueError, match="expert_in.*capture_stats"):
        ptq.apply_plan(mx["params"], mx["cfg"], mx["plan"], stats,
                       float_plan=mx["float_plan"])


def _leaves(tree, prefix=""):
    if isinstance(tree, QuantizedTensor):
        yield prefix + "/values", tree.values
        yield prefix + "/scale", tree.scale
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_apply_plan_leaves_equal_jax(mx):
    """The port's PTQ from JAX's stats equals the JAX-quantized tree carried
    across: every int8 code equal, every scale ((E, 1, F) weight scales,
    (E, 1, 1) expert xs, the attention scales) within one ulp, float leaves
    equal. The expert stacks unstack only the scan axis."""
    q, qplan = ptq.apply_plan(mx["params"], mx["cfg"], mx["plan"],
                              mx["jstats"], float_plan=mx["float_plan"])
    assert qplan == mx["qplan"]
    got, want = dict(_leaves(q)), dict(_leaves(mx["q"]))
    assert set(got) == set(want)
    for key, leaf in want.items():
        if leaf is None:
            assert got[key] is None, key
        elif leaf.dtype == torch.int8:
            assert got[key].equal(leaf), key
        else:
            assert got[key].shape == leaf.shape, key
            np.testing.assert_array_max_ulp(got[key].numpy(), leaf.numpy(),
                                            maxulp=1)
    E, D, F = 4, mx["cfg"].d_model, mx["cfg"].moe.d_ff_expert
    for i in (0, 1, 3):
        ffn = q["layers"][i]["ffn"]
        assert ffn["wg"]["w"].values.shape == (E, D, F)
        assert ffn["wg"]["w"].scale.shape == (E, 1, F)
        assert ffn["wd"]["w"].scale.shape == (E, 1, D)
        assert ("xs" in ffn["wg"]) == (i != 1)
        if i != 1:
            assert ffn["wg"]["xs"].shape == ffn["wd"]["xs"].shape == (E, 1, 1)
    assert torch.is_tensor(q["layers"][2]["ffn"]["wg"]["w"])     # float


def test_golden_v4_fingerprint_matches_jax_and_chip_smoke(mx):
    assert mx["plan"].fingerprint() == mx["jplan"].fingerprint()
    text = (ROOT / "chip_smoke.py").read_text()
    m = re.search(r'MOE_FINGERPRINT = \("(\w+)"\s*"(\w+)"\)', text)
    assert m.group(1) + m.group(2) == mx["jplan"].fingerprint()


# ---------------------------------------------------------------------------
# serving: against the JAX engine
# ---------------------------------------------------------------------------


def _prompts(cfg, n=5, length=5):
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size, length).tolist()
            for _ in range(n)]


@pytest.fixture(scope="module")
def jax_served(mx):
    eng = JaxEngine(mx["jcfg"], mx["jq"], mx["jqplan"], batch_slots=4,
                    max_len=32, precision=mx["jplan"])
    for i, p in enumerate(_prompts(mx["cfg"])):
        eng.submit(JaxRequest(uid=i, prompt=p, max_tokens=5))
    out = {r.uid: r.output for r in eng.run()}
    return out, eng.kv_cache_bytes, JT.kv_geometry(eng.caches)


def _serve(mx, backend, record=None):
    eng = ServeEngine(mx["cfg"], mx["q"], mx["qplan"], batch_slots=4,
                      max_len=32, backend=backend, precision=mx["plan"],
                      device="cpu")
    if record is not None:
        step = eng._decode

        def rec(*a):
            out, caches = step(*a)
            record.append(out.clone())
            return out, caches
        eng._decode = rec
    for i, p in enumerate(_prompts(mx["cfg"])):
        eng.submit(Request(uid=i, prompt=p, max_tokens=5))
    return {r.uid: r.output for r in eng.run()}, eng


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_engine_matches_jax_engine(mx, jax_served, backend):
    """Golden v4 on reduced mixtral, 4 slots, max_len 32: the tokens of the
    JAX engine; its cache bytes (33,344: float rings, since every layer is
    local) and geometry; a page pool built for the plan's int8 KV and empty
    at the end."""
    want, want_bytes, want_geometry = jax_served
    got, eng = _serve(mx, backend)
    assert got == want
    assert eng.kv_cache_bytes == want_bytes == 33344
    assert T.kv_geometry(eng.caches) == want_geometry
    assert eng.pool is not None and eng.kv_pages_in_use == 0


def test_fused_equals_reference_on_cpu(mx):
    """On CPU tensors the fused backend runs every kernel's plain version:
    the reference's tokens and logits exactly, and no launch."""
    logits = [[], []]
    kernels.reset_launches()
    ref, _ = _serve(mx, "reference", logits[0])
    fused, _ = _serve(mx, "fused", logits[1])
    assert fused == ref
    assert all(a.equal(b) for a, b in zip(*logits))
    assert not any(kernels.launch_counts().values())


def test_moe_runtime_runs_unbucketed(mx):
    """Padding would take expert capacity and move real rows' routing, so an
    MoE runtime runs each request shape as it is (a dense one buckets)."""
    rt = Runtime(mx["cfg"], mx["qplan"], precision=mx["plan"], device="cpu")
    assert not rt.bucketed
    assert Runtime(get_config("qwen2-0.5b").reduced(), (),
                   device="cpu").bucketed
    toks = np.random.default_rng(2).integers(1, 128, (3, 5), dtype=np.int32)
    out = rt.encode(mx["q"], {"tokens": toks})
    assert rt.stats["buckets"] == [(3, 5)] and rt.stats["padded_tokens"] == 0
    with torch.inference_mode():
        want = T.forward(mx["q"], {"tokens": _t(toks)}, mx["cfg"],
                         mx["qplan"], return_hidden=True)
    np.testing.assert_array_equal(out, want.numpy())
