"""Port parity for slice 2, the schema-v3 whole-layer int8 span
(``softmax='uint8'`` + ``norm='int8'``): ``quant_flash_attention``'s plain
version against the JAX package's Pallas kernel (interpret mode here) and
against the port's reference attention path, the backend dispatch, the
requantizing GEMM and int8-input addnorm epilogues, the v3 PTQ leaves, the
plan helpers, and the span end to end through the model and the engine, at
reduced bert-base (4 layers, d_model 64, 4 query heads over 2 KV heads of
dim 16)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import LayerPlan as JaxLayerPlan
from repro.core.plan import PrecisionPlan as JaxPlan
from repro.core.precision import LayerMode as JaxMode
from repro.core.quantize import QuantizedTensor as JaxQT
from repro.core.samp import int8_dataflow_variant as jax_variant
from repro.kernels import ops
from repro.models import layers as JL
from repro.models import transformer as JT

from repro_torch import kernels
from repro_torch.core.plan import LayerPlan, PrecisionPlan
from repro_torch.core.precision import LayerMode
from repro_torch.core.quantize import (UINT8_MAX, QuantizedTensor,
                                       quantize_unsigned)
from repro_torch.core.samp import int8_dataflow_variant
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.backend import (FusedBackend, QuantActivation,
                                         get_backend)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.quant import ptq
from repro_torch.serve import EncoderRequest, EncoderServeEngine, Runtime

from test_torch_support import GOLDEN, bert_slice, rel_linf, to_jax_batches

BUDGET = 5e-3       # the JAX package's fused-vs-reference budget for the span


@pytest.fixture(scope="module")
def s():
    return bert_slice(GOLDEN, dataflow=True)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _batch(s, i):
    b = s["batches"][i]
    return {k: _t(v) for k, v in b.items()}, to_jax_batches([b])[0]


# ---------------------------------------------------------------------------
# quant_flash_attention: plain version against the Pallas kernel
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, Sq, Sk, key lengths per batch row)
SHAPES = {
    "mha": (2, 4, 4, 16, 16, (16, 16)),
    "gqa_padded": (2, 4, 2, 16, 16, (16, 9)),
    "all_padding_row": (2, 4, 2, 8, 8, (8, 0)),
    "ragged_sq": (3, 2, 1, 12, 12, (12, 5, 1)),
}
SCALES = dict(q_scale=0.011, k_scale=0.013, v_scale=0.02)


def _attn_inputs(name, seed=0):
    B, Hq, Hkv, Sq, Sk, lens = SHAPES[name]
    rng = np.random.default_rng(seed + sum(SHAPES[name][:5]))
    q = rng.integers(-128, 128, (B, Hq, Sq, 16)).astype(np.int8)
    k = rng.integers(-128, 128, (B, Hkv, Sk, 16)).astype(np.int8)
    v = rng.integers(-128, 128, (B, Hkv, Sk, 16)).astype(np.int8)
    idx = np.arange(Sk, dtype=np.int32)
    k_pos = np.where(idx[None] < np.array(lens)[:, None], idx[None], -1)
    return q, k, v, k_pos.astype(np.int32)


def _code_diff(a, b):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_plain_matches_pallas(name, requant, softcap):
    """Float output within rel-Linf 5e-3; int8 output within one code on at
    most 0.5% of elements. The two are not held to bit equality: XLA's CPU
    exp and torch's CPU exp differ by an ulp on about a tenth of float32
    inputs in [-30, 0], and the softmax denominators are summed in
    different orders, so a probability code at a rounding tie can flip."""
    q, k, v, k_pos = _attn_inputs(name)
    # p_scale = amax / 255 with the amax of this input's probabilities
    p_scale = np.float32(0.6) / np.float32(UINT8_MAX)
    kw = dict(SCALES, p_scale=float(p_scale), softcap=softcap)
    if requant:
        kw["o_scale"] = 0.01
    ours = FA.quant_flash_attention_plain(_t(q), _t(k), _t(v), _t(k_pos),
                                          **kw)
    want = ops.quant_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_pos),
        **{n: (jnp.float32(x) if n.endswith("scale") else x)
           for n, x in kw.items()})
    want = np.asarray(want)
    assert ours.shape == want.shape == q.shape
    if requant:
        assert ours.dtype == torch.int8
        worst, share = _code_diff(want, ours.numpy())
        assert worst <= 1 and share <= 5e-3, (worst, share)
    else:
        assert np.isfinite(ours.numpy()).all()
        assert rel_linf(want, ours.numpy()) <= BUDGET


def test_fully_padded_row_is_uniform():
    """A batch row with no valid key gets a uniform softmax (NEG_INF is
    finite), as the runtime's padded batch rows need, not NaN."""
    q, k, v, k_pos = _attn_inputs("all_padding_row")
    out = FA.quant_flash_attention_plain(
        _t(q), _t(k), _t(v), _t(k_pos), p_scale=1.0 / UINT8_MAX, **SCALES)
    assert torch.isfinite(out).all()
    # every query of row 1 sees the same uniform mix of the values
    row = out[1]
    assert torch.allclose(row, row[:, :1].expand_as(row))


def test_softmax_sum_is_the_warp_order():
    """softmax_sum adds keys l, l + 32, ... per lane, then a butterfly: a
    sum, in one fixed order, that zero padding does not move."""
    e = torch.rand(3, 5, 77, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(FA.softmax_sum(e).numpy(),
                               e.double().sum(-1, keepdim=True).numpy(),
                               rtol=1e-6)
    padded = torch.nn.functional.pad(e, (0, 19))
    assert FA.softmax_sum(padded).equal(FA.softmax_sum(e))


def test_quantize_unsigned_keeps_the_calibrated_scale():
    """The reference path hands quant_bmm ``p_scale * 255`` as an amax and
    quantize_unsigned divides it by 255 again; on these scales, as on 10^6
    random float32 amax values in (0, 1], that gives p_scale back exactly,
    so the reference and the kernel quantize p at one scale."""
    rng = np.random.default_rng(3)
    amax = rng.uniform(1e-3, 1.0, 4096).astype(np.float32)
    ps = torch.from_numpy(amax) / torch.tensor(float(UINT8_MAX))
    for p in ps[:64]:
        assert quantize_unsigned(torch.zeros(1), p * UINT8_MAX).scale \
            .equal(p)


@pytest.mark.parametrize("name", ["mha", "gqa_padded", "all_padding_row"])
def test_plain_matches_reference_attention_core(name):
    """The kernel's plain version against the port's reference path
    (``attention_core`` with ``quant_bmm(unsigned_a=True)``) on the same
    float q, k, v: the reference sums the softmax in the kernel's order on
    the uint8 path (``models.layers._softmax(ordered=True)``), so the two
    agree exactly, within the JAX budget of 5e-3 with room to spare."""
    B, Hq, Hkv, Sq, Sk, lens = SHAPES[name]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, Sq, Hq, 16)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, 16)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, 16)).astype(np.float32)
    _, _, _, k_pos = _attn_inputs(name)
    sc = {"q": torch.tensor(0.012), "k": torch.tensor(0.03),
          "p": torch.tensor(0.5) / UINT8_MAX, "v": torch.tensor(0.025)}
    scale = 0.25
    ref = L.attention_core(
        _t(q), _t(k), _t(v), _t(k_pos), _t(k_pos), L.MaskSpec(causal=False),
        scale=scale, quant=L.AttnQuant(enabled=True, plan_scheme="uint8"),
        scales=sc)
    p = {f"{n}_scale": x for n, x in sc.items()}
    fused = get_backend("fused").attention(
        _t(q), _t(k), _t(v), p, k_pos=_t(k_pos),
        spec=L.MaskSpec(causal=False), scale=scale)
    assert fused.shape == ref.shape == (B, Sq, Hq, 16)
    assert rel_linf(ref.numpy(), fused.numpy()) <= BUDGET
    assert fused.equal(ref)


# ---------------------------------------------------------------------------
# backend dispatch
# ---------------------------------------------------------------------------


def _attn_params(o_scale=True):
    rng = np.random.default_rng(1)
    p = {"q_scale": torch.tensor(0.01), "k_scale": torch.tensor(0.03),
         "p_scale": torch.tensor(0.4 / UINT8_MAX),
         "v_scale": torch.tensor(0.03),
         "wo": {"w": QuantizedTensor(
             _t(rng.integers(-128, 128, (64, 64)).astype(np.int8)),
             torch.full((1, 64), 1e-3))}}
    if o_scale:
        p["wo"]["xs"] = torch.tensor(0.02)
    return p


def _qkv(B=2, S=8, Hq=4, Hkv=2):
    rng = np.random.default_rng(2)
    return tuple(_t(rng.standard_normal((B, S, h, 16)).astype(np.float32))
                 for h in (Hq, Hkv, Hkv))


def test_fused_attention_runs_plain_on_cpu():
    """On CPU tensors the fused op runs the plain version (no launch is
    counted) and returns int8 at wo's static scale, or float32 when wo
    takes per-token scales."""
    q, k, v = _qkv()
    pos = torch.arange(8, dtype=torch.int32)
    spec = L.MaskSpec(causal=False)
    kernels.reset_launches()
    qa = get_backend("fused").attention(q, k, v, _attn_params(), k_pos=pos,
                                        spec=spec, scale=0.25)
    assert isinstance(qa, QuantActivation) and qa.shape == (2, 8, 4, 16)
    assert qa.q.values.dtype == torch.int8 and float(qa.q.scale) == \
        pytest.approx(0.02)
    out = get_backend("fused").attention(q, k, v, _attn_params(False),
                                         k_pos=pos, spec=spec, scale=0.25)
    assert out.dtype == torch.float32 and out.shape == (2, 8, 4, 16)
    assert kernels.launch_counts()["quant_flash_attention"] == 0
    # the int8 output is the float output requantized at wo's scale
    assert qa.q.values.equal(torch.clamp(torch.round(out / 0.02), -128, 127)
                             .to(torch.int8))


@pytest.mark.parametrize("case", ["causal", "window", "no_p_scale",
                                  "no_q_scale", "heads"])
def test_fused_attention_declines(case):
    q, k, v = _qkv()
    p = _attn_params()
    spec = L.MaskSpec(causal=False)
    if case == "causal":
        spec = L.MaskSpec(causal=True)
    elif case == "window":
        spec = L.MaskSpec(causal=False, window=4)
    elif case == "no_p_scale":
        del p["p_scale"]
    elif case == "no_q_scale":
        del p["q_scale"]
    else:
        q, k, v = _qkv(Hq=4, Hkv=3)
    assert get_backend("fused").attention(
        q, k, v, p, k_pos=torch.arange(8), spec=spec, scale=0.25) is None


def test_auto_and_reference_decline_attention_on_cpu():
    q, k, v = _qkv()
    for name in ("auto", "reference"):
        assert get_backend(name).attention(
            q, k, v, _attn_params(), k_pos=torch.arange(8),
            spec=L.MaskSpec(causal=False), scale=0.25) is None


def test_quant_activation_reshape_and_transpose():
    v = torch.arange(24, dtype=torch.int8).reshape(2, 3, 4)
    qa = QuantActivation(QuantizedTensor(v, torch.tensor(0.5)),
                         torch.float32)
    assert qa.dtype == torch.float32
    r = qa.reshape(6, 4)
    assert r.shape == (6, 4) and r.q.values.equal(v.reshape(6, 4))
    assert qa.reshape((3, 8)).shape == (3, 8)
    t = qa.transpose(0, 2)
    assert t.shape == (4, 3, 2) and t.dequantize().equal(
        qa.dequantize().transpose(0, 2))


# ---------------------------------------------------------------------------
# the span's epilogue variants
# ---------------------------------------------------------------------------


def _span_linear(rng, K=64, N=32):
    w = rng.standard_normal((K, N)).astype(np.float32)
    scale = np.abs(w).max(0, keepdims=True) / np.float32(127)
    return {"w": QuantizedTensor(
                _t(np.clip(np.round(w / scale), -128, 127).astype(np.int8)),
                _t(scale)),
            "b": _t(rng.standard_normal(N).astype(np.float32) * 0.1),
            "xs": torch.tensor(0.025), "out_xs": torch.tensor(0.04)}


@pytest.mark.parametrize("act", [None, "gelu"])
def test_dense_out_xs_matches_jax(act):
    """The reference dense requantizes at ``out_xs`` after bias and
    activation (a QDQ), as ``repro.models.layers.dense`` does."""
    rng = np.random.default_rng(5)
    p = _span_linear(rng)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    ours = L.dense(_t(x), p, act=act)
    jp = {"w": JaxQT(jnp.asarray(p["w"].values.numpy()),
                     jnp.asarray(p["w"].scale.numpy())),
          "b": jnp.asarray(p["b"].numpy()), "xs": jnp.float32(0.025),
          "out_xs": jnp.float32(0.04)}
    want = np.asarray(JL.dense(jnp.asarray(x), jp, act=act))
    worst = np.abs(want - ours.numpy()).max()
    # on the grid of out_xs: equal, or one code apart at a GELU tie
    assert worst == 0.0 or worst == pytest.approx(0.04, rel=1e-6)
    codes = ours.numpy() / np.float32(0.04)
    np.testing.assert_allclose(codes, np.round(codes), atol=1e-4)


@pytest.mark.parametrize("quant_in", [False, True])
def test_fused_linear_out_xs_hands_off_int8(quant_in):
    rng = np.random.default_rng(6)
    p = _span_linear(rng)
    x = _t(rng.standard_normal((2, 5, 64)).astype(np.float32))
    if quant_in:
        from repro_torch.core.quantize import quantize
        x = QuantActivation(QuantizedTensor(quantize(x, p["xs"]), p["xs"]),
                            torch.float32)
    y = get_backend("fused").linear(x, p, act="gelu")
    assert isinstance(y, QuantActivation) and y.shape == (2, 5, 32)
    assert y.q.values.dtype == torch.int8 and y.q.scale.equal(p["out_xs"])
    ref = L.dense(x, p, act="gelu")
    assert y.dequantize().equal(ref)


def test_fused_addnorm_takes_an_int8_delta():
    """``addnorm`` with a QuantActivation delta feeds the kernel its int8
    payload and ``x_in_scale``, as ``repro.kernels.ops.addnorm_quant``."""
    rng = np.random.default_rng(8)
    D = 64
    codes = rng.integers(-128, 128, (2, 3, D)).astype(np.int8)
    resid = rng.standard_normal((2, 3, D)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(D)).astype(np.float32)
    delta = QuantActivation(QuantizedTensor(_t(codes), torch.tensor(0.03)),
                            torch.float32)
    h, qa = get_backend("fused").addnorm(
        delta, _t(resid), {"scale": _t(gamma), "bias": _t(beta)},
        "layernorm", torch.tensor(0.02))
    jh, jq = ops.addnorm_quant(
        jnp.asarray(codes.reshape(-1, D)), jnp.asarray(resid.reshape(-1, D)),
        jnp.zeros((D,), jnp.float32), jnp.asarray(gamma), jnp.asarray(beta),
        jnp.float32(0.02), x_in_scale=jnp.float32(0.03))
    # XLA on the CPU contracts x * x_in_scale + residual into an FMA, so h
    # is within float32 rounding of the JAX kernel's, not bit-equal
    assert rel_linf(np.asarray(jh), h.numpy().reshape(-1, D)) <= 1e-6
    worst, share = _code_diff(np.asarray(jq), qa.q.values.numpy()
                              .reshape(-1, D))
    assert worst <= 1 and share < 5e-3
    # the reference boundary dequantizes the delta: the same h
    ref_h, _ = L.residual_norm(delta, _t(resid),
                               {"scale": _t(gamma), "bias": _t(beta)},
                               "layernorm")
    assert ref_h.equal(h)


# ---------------------------------------------------------------------------
# PTQ under the v3 plan
# ---------------------------------------------------------------------------


def test_apply_plan_v3_leaves_equal_jax(s):
    """p_scale, wo.out_xs and wi.out_xs equal the JAX package's bit for bit
    (the port quantizes the carried float params with JAX's stats)."""
    qparams, qplan = ptq.apply_plan(s["params"], s["cfg"], s["plan"],
                                    s["jstats"], float_plan=s["float_plan"])
    assert qplan == s["qplan"]
    ref = s["qparams_from_jax"]["layers"]
    span = [i for i, lp in enumerate(s["plan"].layers) if lp.norm == "int8"]
    assert span == [0, 3]
    for i, (mine, want) in enumerate(zip(qparams["layers"], ref)):
        for path in (("attn", "p_scale"), ("attn", "wo", "out_xs"),
                     ("ffn", "wi", "out_xs")):
            a, b = ptq._get_path(mine, path), ptq._get_path(want, path)
            if i in span:
                assert a is not None and a.equal(b), (i, path)
            elif path[-1] == "out_xs":
                assert a is None and b is None, (i, path)
        assert "out_xs" not in mine["attn"]["wq"]
        assert "out_xs" not in mine["ffn"]["wo"]


def test_apply_plan_v3_needs_attn_delta(s):
    stats = {layer: {k: v for k, v in sites.items() if k != "attn_delta"}
             for layer, sites in s["jstats"].items()}
    with pytest.raises(ValueError, match="attn_delta"):
        ptq.apply_plan(s["params"], s["cfg"], s["plan"], stats,
                       float_plan=s["float_plan"])


def test_uint8_softmax_with_per_token_qkv_gets_p_scale(s):
    """A per-token qkv block has no static bmm scales, but softmax='uint8'
    still attaches the unsigned p_scale, as in the JAX package."""
    from repro_torch.core.plan import QuantSpec
    tok = QuantSpec(weight="int8_per_channel", act="int8_per_token")
    layer = LayerPlan(qkv=tok, attn_out=tok, softmax="uint8")
    n = s["cfg"].num_layers
    qparams, _ = ptq.apply_plan(
        s["params"], s["cfg"], PrecisionPlan.uniform(n, layer, "float32"),
        s["jstats"], float_plan=s["float_plan"])
    for i, lp in enumerate(qparams["layers"]):
        amax = s["jstats"][f"layer{i}"]["p"]
        want = np.float32(max(amax, 1e-8)) / np.float32(UINT8_MAX)
        assert float(lp["attn"]["p_scale"]) == want
        assert "q_scale" not in lp["attn"]


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile", [1, 3])
def test_dataflow_variant_fingerprints_match_jax(tile):
    golden, jgolden = PrecisionPlan.load(GOLDEN), JaxPlan.load(GOLDEN)
    plan = PrecisionPlan(golden.layers * tile, golden.float_dtype)
    jplan = JaxPlan(jgolden.layers * tile, jgolden.float_dtype)
    ours, want = int8_dataflow_variant(plan), jax_variant(jplan)
    assert ours.fingerprint() == want.fingerprint()
    assert ours.to_json() == want.to_json()
    assert [(lp.softmax, lp.norm) for lp in ours.layers] == \
        [("uint8", "int8"), ("float", "float"), ("float", "float"),
         ("uint8", "int8")] * tile
    assert int8_dataflow_variant(PrecisionPlan.full_float(4)) is None
    assert jax_variant(JaxPlan.full_float(4)) is None
    if tile == 3:
        # chip_smoke.py's span_path fails unless the port's plan has the
        # fingerprint it records as the JAX package's
        text = (Path(__file__).resolve().parents[1] / "chip_smoke.py") \
            .read_text()
        m = re.search(r'SPAN_FINGERPRINT = \("(\w+)"\s*"(\w+)"\)', text)
        assert m.group(1) + m.group(2) == want.fingerprint()


@pytest.mark.parametrize("mode", list(LayerMode))
@pytest.mark.parametrize("dynamic", [False, True])
def test_for_mode_and_with_dataflow_match_jax(mode, dynamic):
    jmode = JaxMode(mode.value)
    ours = LayerPlan.for_mode(mode, dynamic_acts=dynamic, calibrator="mse")
    want = JaxLayerPlan.for_mode(jmode, dynamic_acts=dynamic,
                                 calibrator="mse")
    assert ours.to_dict() == want.to_dict()
    assert ours.with_dataflow() is ours
    if mode.quant_mha:
        a = ours.with_dataflow(softmax="uint8")
        b = want.with_dataflow(softmax="uint8")
        assert a.to_dict() == b.to_dict() and a.softmax == "uint8"
        assert LayerPlan.for_mode(mode, softmax="uint8").to_dict() == \
            JaxLayerPlan.for_mode(jmode, softmax="uint8").to_dict()
        if not dynamic:
            full = ours.with_dataflow(softmax="uint8", norm="int8")
            n = 2
            fp = PrecisionPlan.uniform(n, full, "float32").fingerprint()
            jfp = JaxPlan.uniform(n, want.with_dataflow(
                softmax="uint8", norm="int8"), "float32").fingerprint()
            assert fp == jfp
    if not mode.quant_mha:
        with pytest.raises(ValueError):
            ours.with_dataflow(softmax="uint8")


# ---------------------------------------------------------------------------
# the span end to end
# ---------------------------------------------------------------------------


def test_span_reference_matches_jax_reference(s):
    """The port's reference forward against the JAX package's on the
    carried-across JAX PTQ params. On batch 0 they agree to float32
    rounding (the slice-1 norms' summation order, ROADMAP "Faults"). On
    batch 1 one GELU output of layer 3 sits at an exact rounding tie of the
    requantization at ``wi.out_xs`` in JAX (40.5 codes) and one ulp above
    it in the port, whose LayerNorm sums in another order; that one flipped
    code moves the logits by 5.9e-4, inside the ±1-code-at-a-tie budget of
    5e-3."""
    for i, tol in ((0, 1e-5), (1, BUDGET)):
        tb, jb = _batch(s, i)
        ours = T.forward(s["qparams_from_jax"], tb, s["cfg"], s["qplan"])
        want, _ = JT.forward(s["jq"], jb, s["jcfg"], s["jqplan"],
                             compute_dtype=jnp.float32)
        assert rel_linf(np.asarray(want), ours.numpy()) <= tol, i


@pytest.mark.parametrize("layer", [0, 3])
def test_span_attention_block_matches_jax(s, layer):
    """Fed the same input, a span layer's attention block (the uint8 core
    and attn_out with its requantizing epilogue) equals the JAX package's,
    on the reference path and on the fused one."""
    import jax
    jlp = jax.tree_util.tree_map(lambda a: a[0],
                                 s["jq"]["groups"][layer]["layers"][0])
    lp = s["qparams_from_jax"]["layers"][layer]
    rng = np.random.default_rng(layer)
    h = rng.standard_normal((2, 16, s["cfg"].d_model)).astype(np.float32)
    pos = np.where(np.arange(16)[None] < np.array([[16], [11]]),
                   np.arange(16)[None], -1).astype(np.int32)
    jq = JL.AttnQuant(enabled=True, plan_scheme="uint8")
    want, _ = JL.attention_block(jnp.asarray(h), jlp["attn"], s["jcfg"],
                                 positions=jnp.asarray(pos),
                                 spec=JL.MaskSpec(causal=False), quant=jq)
    for backend in (None, get_backend("fused")):
        got = L.attention_block(
            _t(h), lp["attn"], s["cfg"], positions=_t(pos),
            spec=L.MaskSpec(causal=False),
            quant=L.AttnQuant(enabled=True, plan_scheme="uint8"),
            backend=backend)
        if isinstance(got, QuantActivation):
            got = got.dequantize()
        assert rel_linf(np.asarray(want), got.numpy()) <= 1e-5


@pytest.mark.parametrize("batch", [0, 1])
def test_span_fused_matches_jax_fused(s, batch):
    """Port fused (the kernels' plain versions) against JAX fused (the
    Pallas kernels in interpret mode): within the budget, same
    predictions; and the port's fused path equals its reference path
    exactly on the CPU."""
    from repro.kernels.backend import get_backend as jax_backend
    tb, jb = _batch(s, batch)
    fused = T.forward(s["qparams_from_jax"], tb, s["cfg"], s["qplan"],
                      backend=get_backend("fused"))
    ref = T.forward(s["qparams_from_jax"], tb, s["cfg"], s["qplan"])
    want, _ = JT.forward(s["jq"], jb, s["jcfg"], s["jqplan"],
                         compute_dtype=jnp.float32,
                         backend=jax_backend("fused"))
    want = np.asarray(want)
    assert rel_linf(want, fused.numpy()) <= BUDGET
    head = lambda h: T.apply_head(h, s["qparams_from_jax"], "cls")  # noqa
    assert head(fused).argmax(-1).tolist() == \
        head(_t(want)).argmax(-1).tolist()
    assert fused.equal(ref)


def test_whole_layer_span_no_float_boundaries(s, monkeypatch):
    """Backend-level spies prove the span, as the JAX package's test of the
    same name: the attention emits int8, attn_out and the FFN GEMMs take
    int8 in, wo and wi emit int8, the residual boundary takes the int8
    delta, and quant_flash_attention runs with o_scale."""
    lin_in, lin_out, attn_out, addnorm_in = [], [], [], []
    orig_linear = FusedBackend.linear
    orig_attn = FusedBackend.attention
    orig_addnorm = FusedBackend.addnorm

    def linear(self, x, p, *, act=None):
        out = orig_linear(self, x, p, act=act)
        lin_in.append(isinstance(x, QuantActivation))
        lin_out.append(isinstance(out, QuantActivation))
        return out

    def attention(self, *a, **kw):
        out = orig_attn(self, *a, **kw)
        attn_out.append(isinstance(out, QuantActivation))
        return out

    def addnorm(self, delta, *a, **kw):
        addnorm_in.append(isinstance(delta, QuantActivation))
        return orig_addnorm(self, delta, *a, **kw)

    calls = {"flash": [], "linear": [], "addnorm": []}
    from repro_torch.kernels import backend as B
    orig_flash, orig_ql, orig_an = (B.quant_flash_attention, B.quant_linear,
                                    B.addnorm_quant)

    def flash(*a, **kw):
        calls["flash"].append(kw.get("o_scale") is not None)
        return orig_flash(*a, **kw)

    def ql(x_q, *a, **kw):
        calls["linear"].append((x_q.dtype == torch.int8,
                                kw.get("out_scale") is not None))
        return orig_ql(x_q, *a, **kw)

    def an(x, *a, **kw):
        calls["addnorm"].append((x.dtype == torch.int8,
                                 kw.get("x_in_scale") is not None))
        return orig_an(x, *a, **kw)

    monkeypatch.setattr(FusedBackend, "linear", linear)
    monkeypatch.setattr(FusedBackend, "attention", attention)
    monkeypatch.setattr(FusedBackend, "addnorm", addnorm)
    monkeypatch.setattr(B, "quant_flash_attention", flash)
    monkeypatch.setattr(B, "quant_linear", ql)
    monkeypatch.setattr(B, "addnorm_quant", an)

    cfg, qparams = s["cfg"], s["qparams_from_jax"]
    # one span layer (layer 0) on its own
    plan = T.build_plan(cfg, s["plan"])
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    g = plan[0]
    with torch.inference_mode():
        T.layer_forward(x, qparams["layers"][0], cfg, g.kinds[0], g.mode,
                        T.QuantScheme(), positions=torch.arange(16),
                        obs=None, chunk=512, quant_bmm=g.quant_bmm,
                        softmax=g.softmax, backend=get_backend("fused"))
    assert attn_out == [True] and calls["flash"] == [True]
    # wq/wk/wv take the float stream; wo, wi and the FFN's wo take int8
    assert lin_in == [False] * 3 + [True] * 3, lin_in
    # wo and wi requantize in the epilogue; the FFN's wo emits float
    assert lin_out == [False] * 3 + [True, True, False], lin_out
    assert calls["linear"] == [(True, False)] * 3 + [(True, True)] * 2 \
        + [(True, False)]
    assert addnorm_in == [True] and calls["addnorm"] == [(True, True)]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _requests(cfg, n=10, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, int(rng.integers(3, 30))).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_engine_serves_the_span_like_jax(s, backend):
    """EncoderServeEngine on the CPU under the v3 plan against the JAX
    engine (fused, Pallas in interpret mode) at the same buckets."""
    from repro.serve import EncoderRequest as JaxRequest
    from repro.serve import EncoderServeEngine as JaxEngine
    reqs = _requests(s["cfg"])
    jeng = JaxEngine(s["jcfg"], s["jq"], s["jqplan"], target="cls",
                     backend="fused")
    eng = EncoderServeEngine(s["cfg"], s["qparams_from_jax"], s["qplan"],
                             backend=backend, device="cpu")
    for i, toks in enumerate(reqs):
        jeng.submit(JaxRequest(uid=i, tokens=toks))
        eng.submit(EncoderRequest(uid=i, tokens=toks))
    want = sorted(jeng.run(), key=lambda r: r.uid)
    got = sorted(eng.run(), key=lambda r: r.uid)
    a = np.stack([r.logits for r in want])
    b = np.stack([r.logits for r in got])
    assert b.shape == (len(reqs), 15) and np.isfinite(b).all()
    assert rel_linf(a, b) <= BUDGET
    assert [int(r.prediction) for r in got] == \
        [int(r.prediction) for r in want]


def test_runtime_keys_v3_apart_from_v1(s):
    """The executable cache key carries the plan fingerprint, so the span
    plan and the v1 plan it came from never share a cached callable."""
    v1 = PrecisionPlan.load(GOLDEN)
    assert v1.fingerprint() != s["plan"].fingerprint()
    keys = set()
    for plan in (v1, s["plan"]):
        rt = Runtime(s["cfg"], T.build_plan(s["cfg"], plan), precision=plan,
                     backend="fused", device="cpu")
        keys.add(rt._plan_key)
    assert len(keys) == 2
    assert T.build_plan(s["cfg"], v1) != s["qplan"]
