"""Port parity: the four kernels' plain versions against the JAX package's
Pallas kernels (``repro.kernels.ops``, interpret mode here), the wrappers'
CPU dispatch and launch counters, the build recipe, and the compute-backend
registry. The CUDA kernels themselves run only on a card:
``tests/test_torch_cuda.py`` holds them against their plain versions
there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref

from repro_torch import kernels
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.kernels import (addnorm_quant, build, dynamic_quant,
                                 fused_embed, quant_linear)
from repro_torch.kernels.backend import (BACKENDS, AutoBackend,
                                         ComputeBackend, FusedBackend,
                                         QuantActivation, ffn_input_scale,
                                         get_backend)
from repro_torch.models import layers as L

from test_torch_support import rel_linf


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _codes(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _dynamic_quant_inputs(M, D, ties):
    rng = np.random.default_rng(M + D)
    x = rng.standard_normal((M, D)).astype(np.float32)
    if ties:
        # each row's amax fixes its scale; put the rest on (k + 0.5) * scale
        amax = np.abs(x).max(axis=1, keepdims=True)
        scale = amax / np.float32(127.0)
        x = ((rng.integers(-120, 120, (M, D)) + np.float32(0.5))
             * scale).astype(np.float32)
        x[:, 0] = amax[:, 0]
    return x


@pytest.mark.parametrize("M,D", [(8, 64), (16, 256), (24, 128)])
@pytest.mark.parametrize("ties", [False, True])
def test_dynamic_quant_plain_exact(M, D, ties):
    """Codes and scales equal the kernel's contract as the JAX package
    states it (``repro.kernels.ref``, run op by op)."""
    x = _dynamic_quant_inputs(M, D, ties)
    q, s = dynamic_quant.dynamic_quant_plain(_t(x))
    jq, js = ref.dynamic_quant(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("M,D", [(8, 64), (24, 128)])
@pytest.mark.parametrize("ties", [False, True])
def test_dynamic_quant_plain_vs_pallas(M, D, ties):
    """Against the Pallas kernel under jit: XLA compiles its ``amax / 127``
    into a multiply by the reciprocal, so a row's scale may sit one ulp off
    the divided one (ROADMAP "Faults"); codes then differ by at most one, and
    only in those rows."""
    x = _dynamic_quant_inputs(M, D, ties)
    q, s = dynamic_quant.dynamic_quant_plain(_t(x))
    jq, js = ops.dynamic_quant(jnp.asarray(x))
    s, js = s.numpy(), np.asarray(js)
    np.testing.assert_allclose(s, js, rtol=1.2e-7, atol=0)
    same = (s == js)[:, 0]
    np.testing.assert_array_equal(q.numpy()[same], np.asarray(jq)[same])
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
    assert diff.max() <= 1


@pytest.mark.parametrize("act", [None, "gelu", "silu", "relu"])
@pytest.mark.parametrize("per_token", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_quant_linear_plain_float_out(act, per_token, bias):
    rng = np.random.default_rng(7)
    M, K, N = 16, 128, 64
    x_q, w_q = _codes(rng, (M, K)), _codes(rng, (K, N))
    w_scale = (rng.random(N) * 1e-3 + 1e-4).astype(np.float32)
    x_scale = ((rng.random((M, 1)) * 0.02 + 1e-3).astype(np.float32)
               if per_token else np.float32(0.013))
    b = rng.standard_normal(N).astype(np.float32) if bias else None
    ours = quant_linear.quant_linear_plain(
        _t(x_q), _t(w_q), _t(w_scale), _t(x_scale),
        bias=None if b is None else _t(b), act=act)
    want = ops.quant_linear(jnp.asarray(x_q), jnp.asarray(w_q),
                           jnp.asarray(w_scale), jnp.asarray(x_scale),
                           bias=None if b is None else jnp.asarray(b),
                           act=act, out_dtype=jnp.float32)
    assert ours.dtype == torch.float32 and ours.shape == (M, N)
    assert rel_linf(np.asarray(want), ours.numpy()) <= 1e-6


@pytest.mark.parametrize("act", [None, "gelu"])
def test_quant_linear_plain_int8_out(act):
    rng = np.random.default_rng(11)
    M, K, N = 32, 64, 128
    x_q, w_q = _codes(rng, (M, K)), _codes(rng, (K, N))
    w_scale = (rng.random(N) * 1e-3 + 1e-4).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    out_scale = np.float32(0.02)
    ours = quant_linear.quant_linear_plain(
        _t(x_q), _t(w_q), _t(w_scale), 0.011, bias=_t(b), act=act,
        out_scale=out_scale)
    want = ops.quant_linear(jnp.asarray(x_q), jnp.asarray(w_q),
                           jnp.asarray(w_scale), jnp.float32(0.011),
                           bias=jnp.asarray(b), act=act,
                           out_scale=jnp.asarray(out_scale))
    assert ours.dtype == torch.int8
    diff = np.abs(ours.numpy().astype(np.int32)
                  - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1


def test_quant_linear_requant_rounds_half_to_even():
    """Every output sits on a tie (acc + 0.5 at unit scales): the requant
    epilogue must round half to even, exactly as the Pallas kernel does."""
    rng = np.random.default_rng(12)
    M, K, N = 8, 4, 16
    x_q = rng.integers(-3, 4, (M, K)).astype(np.int8)
    w_q = rng.integers(-3, 4, (K, N)).astype(np.int8)
    ones, half = np.ones(N, np.float32), np.full(N, 0.5, np.float32)
    ours = quant_linear.quant_linear_plain(
        _t(x_q), _t(w_q), _t(ones), 1.0, bias=_t(half), out_scale=1.0)
    want = ops.quant_linear(jnp.asarray(x_q), jnp.asarray(w_q),
                            jnp.asarray(ones), jnp.float32(1.0),
                            bias=jnp.asarray(half), out_scale=jnp.float32(1.0))
    acc = x_q.astype(np.int32) @ w_q.astype(np.int32)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ours.numpy(), np.round(acc + 0.5))


@pytest.mark.parametrize("M,K,N", [(8, 896, 896), (8, 896, 128),
                                   (8, 896, 4864), (8, 4864, 896),
                                   (8, 6144, 6144), (8, 6144, 1024),
                                   (32, 1000, 72), (1024, 768, 768),
                                   (1024, 3072, 768), (1024, 768, 3072),
                                   (4096, 3072, 3072), (64, 64, 64)])
def test_quant_linear_split_plan(M, K, N):
    """The kernel's split of K (csrc/quant_linear.cu, mirrored here for the
    workspace): only for M <= 32; every split holds at least one 64-byte
    stage and the splits cover K; the workspace holds the partial sums and
    one counter a 64-column tile; and the decode shapes put as many blocks
    on the card as K's stages allow, up to 264 (two an SM)."""
    splits = quant_linear.quant_linear_splits(M, N, K)
    ktiles = -(-K // 64)
    assert 1 <= splits <= max(ktiles, 1)
    per = -(-ktiles // splits)
    assert -(-ktiles // per) == splits
    work = quant_linear.quant_linear_workspace(M, N, K)
    if M > quant_linear.SMALL_M:
        assert splits == 1
    if splits == 1:
        assert work == 0
        return
    assert work == M * N + -(-N // 64)
    assert -(-N // 64) * splits >= min(264, -(-N // 64) * ktiles)


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("beta", [False, True])
@pytest.mark.parametrize("int8_in", [False, True])
def test_addnorm_quant_plain(kind, beta, int8_in):
    rng = np.random.default_rng(5)
    M, D = 24, 96
    if int8_in:
        x = _codes(rng, (M, D))
        x_in = np.float32(0.03)
    else:
        x = rng.standard_normal((M, D)).astype(np.float32)
        x_in = None
    res = (rng.standard_normal((M, D)) * 2).astype(np.float32)
    bias = (rng.standard_normal(D) * 0.1).astype(np.float32)
    gamma = (1 + rng.standard_normal(D) * 0.1).astype(np.float32)
    bta = (rng.standard_normal(D) * 0.1).astype(np.float32) if beta else None
    s = np.float32(0.025)
    h, qv = addnorm_quant.addnorm_quant_plain(
        _t(x), _t(res), _t(bias), _t(gamma),
        None if bta is None else _t(bta), s,
        x_in_scale=None if x_in is None else _t(x_in), kind=kind)
    jh, jqv = ops.addnorm_quant(
        jnp.asarray(x), jnp.asarray(res), jnp.asarray(bias),
        jnp.asarray(gamma), None if bta is None else jnp.asarray(bta),
        jnp.float32(s), x_in_scale=None if x_in is None else jnp.float32(x_in),
        kind=kind)
    assert rel_linf(np.asarray(jh), h.numpy()) <= 1e-6
    diff = np.abs(qv.numpy().astype(np.int32)
                  - np.asarray(jqv).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.005


def test_addnorm_quant_needs_x_in_scale_for_int8():
    x = torch.zeros((2, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        addnorm_quant.addnorm_quant(x, torch.zeros(2, 8), torch.zeros(8),
                                    torch.ones(8), None, 0.1)


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("positions", [False, True])
def test_fused_embed_plain_exact(segments, positions):
    rng = np.random.default_rng(9)
    N, D, V, P, S = 40, 32, 50, 16, 2
    tok = rng.standard_normal((V, D)).astype(np.float32)
    pos = rng.standard_normal((P, D)).astype(np.float32)
    seg = rng.standard_normal((S, D)).astype(np.float32)
    ids = rng.integers(0, V, N).astype(np.int32)
    segs = rng.integers(0, S, N).astype(np.int32) if segments else None
    pids = rng.integers(0, P, N).astype(np.int32) if positions else None
    ours = fused_embed.fused_embed_plain(
        _t(ids).long(), _t(tok), _t(pos), _t(seg) if segments else None,
        _t(segs) if segments else None,
        positions=_t(pids) if positions else None)
    want = ops.fused_embed(jnp.asarray(ids), jnp.asarray(tok),
                          jnp.asarray(pos),
                          jnp.asarray(seg) if segments else None,
                          jnp.asarray(segs) if segments else None,
                          positions=jnp.asarray(pids) if positions else None,
                          out_dtype=jnp.float32)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# wrapper dispatch: CPU tensors run the plain version, no count, no kernel
# ---------------------------------------------------------------------------


def test_wrappers_run_plain_on_cpu_and_count_nothing():
    kernels.reset_launches()
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((8, 64)).astype(np.float32))
    assert all(a.equal(b) for a, b in zip(dynamic_quant.dynamic_quant(x),
                                          dynamic_quant.dynamic_quant_plain(x)))
    xq, wq = _t(_codes(rng, (8, 64))), _t(_codes(rng, (64, 16)))
    ws = torch.full((16,), 1e-3)
    assert quant_linear.quant_linear(xq, wq, ws, 0.01, act="gelu").equal(
        quant_linear.quant_linear_plain(xq, wq, ws, 0.01, act="gelu"))
    g, z = torch.ones(64), torch.zeros(64)
    a = addnorm_quant.addnorm_quant(x, x, z, g, z, 0.02)
    b = addnorm_quant.addnorm_quant_plain(x, x, z, g, z, 0.02)
    assert a[0].equal(b[0]) and a[1].equal(b[1])
    tab = torch.randn(10, 64)
    ids = torch.tensor([1, 2, 3])
    assert fused_embed.fused_embed(ids, tab, tab, None, None).equal(
        fused_embed.fused_embed_plain(ids, tab, tab, None, None))
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNEL_COUNTERS}


def test_wrappers_raise_on_other_devices():
    """No silent path for a device the kernels do not serve."""
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError):
        dynamic_quant.dynamic_quant(x)
    with pytest.raises(ValueError):
        quant_linear.quant_linear(x.to(torch.int8), x.to(torch.int8).t(),
                                  torch.empty(4, device="meta"), 0.1)
    with pytest.raises(ValueError):
        addnorm_quant.addnorm_quant(x, x, x[0], x[0], None, 0.1)
    with pytest.raises(ValueError):
        fused_embed.fused_embed(torch.zeros(4, dtype=torch.long,
                                            device="meta"), x, x, None, None)


def test_build_recipe():
    names = sorted(p.name for p in build.sources())
    assert names == ["addnorm_quant.cu", "decode_attention.cu",
                     "dynamic_quant.cu", "flash_attention.cu",
                     "fused_embed.cu", "quant_expert_gemm.cu",
                     "quant_flash_attention.cu", "quant_linear.cu"]
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "-fmad=false" in flags
    assert build.source_hash() == build.source_hash()
    for src in build.sources():
        text = src.read_text()
        assert "src/repro/kernels/" in text       # names the TPU kernel
        assert "extern \"C\" int samp_" in text
        assert "roundf(" not in text.replace("rintf(", "")
        assert "__expf(" not in text and "__fdividef(" not in text


# ---------------------------------------------------------------------------
# compute-backend registry
# ---------------------------------------------------------------------------


def _linear(rng, K=64, N=32, static=True, bias=True):
    from repro_torch.quant.ptq import quantize_weight
    w = _t(rng.standard_normal((K, N)).astype(np.float32) * 0.1)
    p = {"w": quantize_weight(w)}
    if static:
        p["xs"] = torch.tensor(0.02)
    if bias:
        p["b"] = _t(rng.standard_normal(N).astype(np.float32))
    return p


def test_registry_names_and_errors():
    assert sorted(BACKENDS) == ["auto", "fused", "reference"]
    assert type(get_backend(None)) is ComputeBackend
    assert type(get_backend("fused")) is FusedBackend
    inst = AutoBackend()
    assert get_backend(inst) is inst
    with pytest.raises(KeyError):
        get_backend("tpu")


def test_reference_declines_every_op():
    """Every op but the decode step over int8 pages, which runs the
    ``decode_attention`` plain version (tests/test_torch_decode.py), and
    the int8 expert GEMM, which runs the ``quant_expert_gemm`` plain version
    (tests/test_torch_moe.py); over float pages and float expert stacks they
    decline too."""
    b = get_backend("reference")
    assert b.linear(torch.zeros(2, 4), {"w": torch.zeros(4, 4)}) is None
    assert b.addnorm(None, None, {}, "layernorm", 0.1) is None
    assert b.embed(None, {}, None, positions=None, segments=None) is None
    assert b.attention(None, None, None, {}, k_pos=None, spec=None,
                       scale=1.0) is None
    pages = {"pages_k": torch.zeros((2, 4, 1, 8)),
             "pages_v": torch.zeros((2, 4, 1, 8))}
    assert b.decode_attention(torch.zeros((1, 1, 2, 8)), pages,
                              torch.zeros((1, 2), dtype=torch.int32),
                              positions=torch.zeros((1, 1), dtype=torch.int32),
                              active=None, scale=1.0) is None
    assert b.expert_gemm(None, None) is None


@pytest.mark.parametrize("name", ["fused", "auto"])
def test_unported_ops_decline(name):
    """``attention``, ``decode_attention`` and ``expert_gemm`` are ported
    (tests/test_torch_dataflow.py, tests/test_torch_decode.py and
    tests/test_torch_moe.py); a float expert stack declines to the model's
    batched matmul, and decode attention declines float pages, which keep
    the gather path."""
    b = get_backend(name)
    assert b.expert_gemm(None, None) is None
    pages = {"pages_k": torch.zeros((2, 4, 1, 8)),
             "pages_v": torch.zeros((2, 4, 1, 8))}
    assert b.decode_attention(torch.zeros((1, 1, 2, 8)), pages,
                              torch.zeros((1, 2), dtype=torch.int32),
                              positions=torch.zeros((1, 1), dtype=torch.int32),
                              active=None, scale=1.0) is None


@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("act", [None, "gelu"])
def test_fused_linear_matches_reference_dense(static, act):
    rng = np.random.default_rng(1)
    p = _linear(rng, static=static)
    x = _t(rng.standard_normal((2, 5, 64)).astype(np.float32))
    ref = L.dense(x, p, act=act)
    fused = L.dense(x, p, act=act, backend=get_backend("fused"))
    assert fused.shape == ref.shape == (2, 5, 32)
    assert rel_linf(ref.numpy(), fused.numpy()) <= 1e-6


def test_fused_declines_float_blocks_and_auto_declines_cpu():
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((3, 64)).astype(np.float32))
    assert get_backend("fused").linear(x, {"w": torch.zeros(64, 8)}) is None
    assert get_backend("fused").linear(x, _linear(rng), act="tanh") is None
    assert get_backend("auto").linear(x, _linear(rng)) is None
    res = torch.zeros(1, 3, 64)
    assert get_backend("auto").addnorm(res, res, {}, "layernorm",
                                       torch.tensor(0.1)) is None


def test_fused_addnorm_hands_off_int8():
    rng = np.random.default_rng(4)
    D = 64
    delta = _t(rng.standard_normal((2, 3, D)).astype(np.float32))
    resid = _t(rng.standard_normal((2, 3, D)).astype(np.float32))
    p = {"scale": torch.ones(D), "bias": torch.zeros(D)}
    ns = torch.tensor(0.03)
    h, qa = get_backend("fused").addnorm(delta, resid, p, "layernorm", ns)
    assert isinstance(qa, QuantActivation) and qa.shape == (2, 3, D)
    assert qa.q.values.dtype == torch.int8
    ref_h, ref_y = L.residual_norm(delta, resid, p, "layernorm")
    assert rel_linf(ref_h.numpy(), h.numpy()) <= 1e-6
    assert (qa.dequantize() - ref_y).abs().max() <= float(ns) * 1.01
    # the next GEMM consumes the int8 payload without requantizing
    lin = _linear(rng, K=D)
    lin["xs"] = ns
    y = get_backend("fused").linear(qa, lin)
    assert y.shape == (2, 3, 32)
    assert get_backend("fused").addnorm(delta, resid, p, "layernorm",
                                        None) is None


def test_ffn_input_scale():
    rng = np.random.default_rng(0)
    assert ffn_input_scale({"wi": _linear(rng)}, "gelu") is not None
    assert ffn_input_scale({"wi": _linear(rng, static=False)},
                           "gelu") is None
    assert ffn_input_scale({"wi": {"w": torch.zeros(4, 4)}}, "gelu") is None
    assert ffn_input_scale({"wg": _linear(rng)}, "glu") is not None


def test_quant_activation_dequantize():
    v = torch.tensor([[-3, 0, 5]], dtype=torch.int8)
    qa = QuantActivation(QuantizedTensor(v, torch.tensor(0.5)),
                         torch.float32)
    assert qa.shape == (1, 3)
    assert qa.dequantize().tolist() == [[-1.5, 0.0, 2.5]]
