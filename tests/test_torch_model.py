"""Port parity: the encoder building blocks, the transformer module, PTQ
and the parameter carry-across (repro_torch.models / quant / interop
against repro's), at reduced bert-base under the golden plan."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import transformer as JT

from repro_torch.core.plan import PrecisionPlan
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.addnorm_quant import row_sum
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.quant import ptq

from test_torch_support import GOLDEN, bert_slice, rel_linf, to_jax_batches


@pytest.fixture(scope="module")
def s():
    return bert_slice(GOLDEN)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _leaves(tree, prefix=""):
    if isinstance(tree, QuantizedTensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norms_match(kind):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 96)) * 3 + 1).astype(np.float32)
    p = {"scale": (1 + rng.standard_normal(96) * 0.1).astype(np.float32),
         "bias": (rng.standard_normal(96) * 0.1).astype(np.float32)}
    ours = L.norm(_t(x), {k: _t(v) for k, v in p.items()}, kind)
    ref = JL.norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                  kind)
    assert rel_linf(np.asarray(ref), ours.numpy()) <= 1e-6


@pytest.mark.parametrize("D", [64, 96, 768, 1000])
def test_row_sum_is_a_sum(D):
    x = torch.randn(4, D, generator=torch.Generator().manual_seed(D))
    np.testing.assert_allclose(row_sum(x).numpy(),
                               x.double().sum(-1, keepdim=True).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_band_mask_matches():
    q = np.arange(6, dtype=np.int32)
    k = np.array([[0, 1, 2, -1, -1, -1], [0, 1, 2, 3, 4, 5]], np.int32)
    for spec, jspec in ((L.MaskSpec(causal=False), JL.MaskSpec(causal=False)),
                        (L.MaskSpec(causal=True, window=3),
                         JL.MaskSpec(causal=True, window=3))):
        ours = L.band_mask(_t(q)[None], _t(k), spec)
        ref = JL.band_mask(jnp.asarray(q)[None], jnp.asarray(k), jspec)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("chunk", [None, 4])
def test_attention_core_matches(quant, chunk):
    rng = np.random.default_rng(1)
    B, S, H, d = 2, 8, 4, 16
    q, k, v = (rng.standard_normal((B, S, H, d)).astype(np.float32)
               for _ in range(3))
    pos = np.where(np.arange(S)[None] < np.array([[8], [5]]),
                   np.arange(S)[None], -1).astype(np.int32)
    scales = None
    if quant:
        scales = {"q": 0.01, "k": 0.03, "p": 1 / 127, "v": 0.03}
    spec, jspec = L.MaskSpec(causal=False), JL.MaskSpec(causal=False)
    ours = L.attention_core(
        _t(q), _t(k), _t(v), _t(pos), _t(pos), spec, scale=0.25,
        quant=L.AttnQuant(enabled=quant),
        scales=None if scales is None else
        {n: torch.tensor(x, dtype=torch.float32) for n, x in scales.items()},
        chunk=chunk)
    ref = JL.attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), jspec, scale=0.25,
        quant=JL.AttnQuant(enabled=quant),
        scales=None if scales is None else
        {n: jnp.float32(x) for n, x in scales.items()}, chunk=chunk)
    assert rel_linf(np.asarray(ref), ours.numpy()) <= (5e-3 if quant
                                                       else 1e-5)


@pytest.mark.parametrize("unsigned", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_quant_bmm_matches(unsigned, static):
    rng = np.random.default_rng(2)
    a = np.abs(rng.standard_normal((2, 3, 5, 16))).astype(np.float32)
    b = rng.standard_normal((2, 3, 16, 7)).astype(np.float32)
    sa, sb = (0.02, 0.03) if static else (None, None)
    ours = L.quant_bmm(_t(a), _t(b),
                       None if sa is None else torch.tensor(sa),
                       None if sb is None else torch.tensor(sb),
                       unsigned_a=unsigned)
    ref = JL.quant_bmm(jnp.asarray(a), jnp.asarray(b),
                       None if sa is None else jnp.float32(sa),
                       None if sb is None else jnp.float32(sb),
                       unsigned_a=unsigned)
    assert rel_linf(np.asarray(ref), ours.numpy()) <= 1e-6


def test_quant_bmm_refuses_inexact_contraction():
    """Past 1024 terms, where it once refused, the contraction is exact:
    int_matmul's float32 chunks follow the codes' ranges (514 terms for
    uint8 x int8), so a 1025-key P.V equals the JAX package's."""
    rng = np.random.default_rng(5)
    a = np.abs(rng.standard_normal((1, 2, 1025))).astype(np.float32)
    b = rng.standard_normal((1, 1025, 2)).astype(np.float32)
    for unsigned in (False, True):
        ours = L.quant_bmm(_t(a), _t(b), torch.tensor(0.1),
                           torch.tensor(0.1), unsigned_a=unsigned)
        ref = JL.quant_bmm(jnp.asarray(a), jnp.asarray(b), jnp.float32(0.1),
                           jnp.float32(0.1), unsigned_a=unsigned)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# transformer, PTQ and carry-across
# ---------------------------------------------------------------------------


def test_init_params_structure_and_seed():
    from repro_torch.configs import get_config
    cfg = get_config("bert-base").reduced()
    a = T.init_params(cfg, seed=3, head=("cls", 5), device="cpu")
    b = T.init_params(cfg, seed=3, head=("cls", 5), device="cpu")
    assert len(a["layers"]) == cfg.num_layers
    assert set(a) == {"embed", "layers", "final_norm", "lm_head", "head"}
    assert a["layers"][0]["attn"]["wq"]["w"].shape == (cfg.d_model,
                                                       cfg.q_dim)
    assert a["head"]["out"]["w"].shape == (cfg.d_model, 5)
    assert all(x.equal(y) for (_, x), (_, y) in zip(_leaves(a), _leaves(b)))
    c = T.init_params(cfg, seed=4, device="cpu")
    assert not a["embed"]["tok"].equal(c["embed"]["tok"])


def test_carry_across_unstacks_groups(s):
    n = s["cfg"].num_layers
    assert len(s["params"]["layers"]) == n
    jw = np.asarray(s["jparams"]["groups"][0]["layers"][0]["attn"]["wq"]["w"])
    for i in range(n):
        np.testing.assert_array_equal(
            s["params"]["layers"][i]["attn"]["wq"]["w"].numpy(), jw[i])
    q = s["qparams_from_jax"]["layers"]
    assert q[0]["attn"]["wq"]["w"].scale.shape == (1, s["cfg"].q_dim)
    assert q[3]["attn"]["wq"]["w"].scale.shape == (1, 1)   # per tensor
    assert q[0]["attn"]["wq"]["xs"].shape == ()
    assert "xs" not in q[1]["ffn"]["wi"]                     # per token


def test_float_forward_matches(s):
    batch = s["batches"][0]
    ours = T.forward(s["params"], {k: _t(v) for k, v in batch.items()},
                     s["cfg"], s["float_plan"])
    ref, _ = JT.forward(s["jparams"], to_jax_batches([batch])[0],
                        s["jcfg"], s["jfloat_plan"],
                        compute_dtype=jnp.float32)
    assert rel_linf(np.asarray(ref), ours.numpy()) <= 1e-5


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_golden_forward_matches(s, backend):
    """The quantized forward on the carried-across JAX PTQ params."""
    from repro_torch.kernels.backend import get_backend
    batch = s["batches"][1]
    ours = T.forward(s["qparams_from_jax"],
                     {k: _t(v) for k, v in batch.items()}, s["cfg"],
                     s["qplan"], backend=get_backend(backend))
    ref, _ = JT.forward(s["jq"], to_jax_batches([batch])[0], s["jcfg"],
                        s["jqplan"], compute_dtype=jnp.float32)
    assert rel_linf(np.asarray(ref), ours.numpy()) <= 5e-3


def test_capture_stats_matches(s):
    stats = ptq.capture_stats(s["params"], s["batches"], s["cfg"],
                              s["float_plan"], precision=s["plan"])
    assert set(stats) == set(s["jstats"])
    for layer, sites in stats.items():
        # every site, the per-head k_cache / v_cache vectors (lists) too
        assert set(sites) == set(s["jstats"][layer])
        for site, amax in sites.items():
            np.testing.assert_allclose(amax, s["jstats"][layer][site],
                                       rtol=1e-5, err_msg=f"{layer}/{site}")


@pytest.mark.parametrize("calibrator", ["minmax", "percentile"])
def test_capture_stats_single_calibrator(s, calibrator):
    from repro.quant import ptq as jptq
    stats = ptq.capture_stats(s["params"], s["batches"][:1], s["cfg"],
                              s["float_plan"], calibrator=calibrator)
    jstats = jptq.capture_stats(s["jparams"],
                                to_jax_batches(s["batches"][:1]), s["jcfg"],
                                s["jfloat_plan"], calibrator=calibrator)
    for layer, sites in stats.items():
        for site, amax in sites.items():
            assert amax == pytest.approx(jstats[layer][site], rel=1e-5)


def test_apply_plan_leaves_match(s):
    qparams, qplan = ptq.apply_plan(s["params"], s["cfg"], s["plan"],
                                    s["jstats"], float_plan=s["float_plan"])
    assert qplan == s["qplan"]
    ours = dict(_leaves(qparams))
    ref = dict(_leaves(s["qparams_from_jax"]))
    assert set(ours) == set(ref)
    n_quant = 0
    for key, leaf in ref.items():
        mine = ours[key]
        if isinstance(leaf, QuantizedTensor):
            n_quant += 1
            assert isinstance(mine, QuantizedTensor), key
            assert mine.values.equal(leaf.values), key
            assert mine.scale.shape == leaf.scale.shape, key
            np.testing.assert_allclose(mine.scale.numpy(), leaf.scale.numpy(),
                                       rtol=1e-6, atol=0)
        else:
            assert mine.shape == leaf.shape, key
            np.testing.assert_allclose(mine.numpy(), leaf.numpy(), rtol=1e-6,
                                       atol=0)
    # layers 0, 1, 3 quantize 6, 2, 6 GEMM weights
    assert n_quant == 14


def test_apply_plan_refuses_unported_schemes(s):
    """Every scheme of the ported slices applies. A quantized v4 experts
    family on dense bert-base applies as the JAX package applies it, inert
    there, with leaves equal to JAX's (the MoE slice lifted the refusal);
    the v2 KV-cache schemes and the v3 softmax / norm schemes attach their
    kernel operands."""
    from repro.core.plan import INT8_SPEC as JAX_INT8
    from repro.core.plan import LayerPlan as JaxLayerPlan
    from repro.core.plan import PrecisionPlan as JaxPlan
    from repro.quant import ptq as jptq
    from repro_torch.core.plan import INT8_SPEC, LayerPlan
    from test_torch_support import jax_to_numpy
    n = s["cfg"].num_layers
    jq, _ = jptq.apply_plan(s["jparams"], s["jcfg"], JaxPlan.uniform(
        n, JaxLayerPlan(experts=JAX_INT8), "float32"), s["jstats"],
        float_plan=s["jfloat_plan"])
    q, qplan = ptq.apply_plan(s["params"], s["cfg"], PrecisionPlan.uniform(
        n, LayerPlan(experts=INT8_SPEC), "float32"), s["jstats"])
    want = dict(_leaves(params_from_numpy(jax_to_numpy(jq), qplan, "cpu")))
    got = dict(_leaves(q))
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert torch.is_tensor(leaf) and got[key].equal(leaf), key
    q, _ = ptq.apply_plan(s["params"], s["cfg"], PrecisionPlan.uniform(
        n, LayerPlan(kv_cache="int8_per_head"), "float32"), s["jstats"])
    assert all(lp["attn"]["kc_scale"].shape == (s["cfg"].num_kv_heads,)
               for lp in q["layers"])
    q, _ = ptq.apply_plan(s["params"], s["cfg"], PrecisionPlan.uniform(
        n, LayerPlan(qkv=INT8_SPEC, softmax="uint8"), "float32"),
        s["jstats"])
    assert all("p_scale" in lp["attn"] for lp in q["layers"])
    q, _ = ptq.apply_plan(s["params"], s["cfg"], PrecisionPlan.uniform(
        n, LayerPlan(attn_out=INT8_SPEC, ffn_in=INT8_SPEC, norm="int8"),
        "float32"), s["jstats"])
    assert all("out_xs" in lp["attn"]["wo"] and "out_xs" not in
               lp["ffn"]["wi"] for lp in q["layers"])   # ffn_out is float
    with pytest.raises(ValueError):
        ptq.apply_plan(s["params"], s["cfg"],
                       PrecisionPlan.full_float(n + 1), s["jstats"])


@pytest.mark.parametrize("scheme", ["int8_per_channel", "int8_per_tensor"])
def test_quantize_weight_matches(scheme):
    from repro.quant import ptq as jptq
    w = np.random.default_rng(4).standard_normal((32, 16)).astype(np.float32)
    ours = ptq.quantize_weight(_t(w), scheme)
    ref = jptq.quantize_weight(jnp.asarray(w), scheme)
    np.testing.assert_array_equal(ours.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref.scale))
    with pytest.raises(ValueError):
        ptq.quantize_weight(_t(w), "int4")


def test_params_from_numpy_checks_group_count(s):
    tree = {"groups": [], "final_norm": {}}
    with pytest.raises(ValueError):
        params_from_numpy(tree, s["float_plan"], "cpu")


def test_run_groups_capture_names_every_layer(s):
    obs: dict = {}
    with torch.inference_mode():
        T.forward(s["params"], {k: _t(v) for k, v in s["batches"][0].items()},
                  s["cfg"], s["float_plan"], obs=obs)
    layers = {k.split("/")[0] for k in obs}
    assert layers == {f"layer{i}" for i in range(s["cfg"].num_layers)}
    assert {"attn_in", "q", "k", "p", "v", "attn_out", "attn_delta",
            "ffn_in", "ffn_hidden"} <= {k.split("/")[1] for k in obs}


def test_dense_refuses_the_unported_int8_span():
    """The int8 span is ported: ``out_xs`` requantizes a dense output on
    the reference path too (a QDQ onto the scale's grid)."""
    x = torch.tensor([[1.0, -2.0, 0.5, 3.0]])
    p = {"w": torch.eye(4) * 0.3, "out_xs": torch.tensor(0.1)}
    y = L.dense(x, p)
    assert y.equal(torch.round(x * 0.3 / 0.1) * 0.1)
    assert not y.equal(L.dense(x, {"w": p["w"]}))


def test_cls_target_matches_apply_head(s):
    from repro_torch.toolkit.targets import CLS, get_target
    assert get_target("cls") is CLS and not CLS.token_level
    hidden = torch.randn(3, 5, s["cfg"].d_model,
                         generator=torch.Generator().manual_seed(0))
    logits = CLS.apply(s["params"], hidden, s["cfg"])
    assert logits.shape == (3, 15)
    assert logits.equal(T.apply_head(hidden, s["params"], "cls"))
    assert CLS.predict(logits).tolist() == logits.argmax(-1).tolist()
    head = CLS.init(torch.Generator().manual_seed(0), s["cfg"], 7)
    assert head["out"]["w"].shape == (s["cfg"].d_model, 7)
