"""Port parity: ``repro_torch.kernels.ops``, the public kernel API, against
the JAX package's ``repro.kernels.ops`` (its Pallas kernels in interpret
mode here), led by the float ``flash_attention`` in every case of the JAX
package's own tests (``tests/test_kernels.py``, ``tests/test_backend.py``)
plus a head dim of 256, bfloat16, and rows with no valid key; then the
shapes the decode and quantized attention kernels take (the fused backend
claims every one of them, shown with stubs in place of the kernel
wrappers), and a uint8-softmax layer past the resident attention kernel's
shared memory. The CUDA kernels run only
on a card: ``tests/test_torch_cuda.py`` holds them against their plain
versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref

from repro_torch import kernels
from repro_torch.kernels import backend as B
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.models import layers as L

from test_torch_support import rel_linf

TOL = 2e-4                # the JAX test's budget (tests/test_kernels.py)
BF16_ULP = 2.0 ** -8


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _qkv(B_, Hq, Hkv, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B_, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B_, Hkv, Sk, D)).astype(np.float32),
            rng.standard_normal((B_, Hkv, Sk, D)).astype(np.float32))


def _both(q, k, v, **kw):
    """(flash_attention_plain, ops.flash_attention) on the CPU, and the JAX
    op, on the same numpy inputs."""
    want = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), **kw))
    plain = FA.flash_attention_plain(_t(q), _t(k), _t(v), **kw).numpy()
    op = ops.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    return plain, op, want


# ---------------------------------------------------------------------------
# float flash attention against the JAX kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("kwargs", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=64),
    dict(causal=True, softcap=30.0)], ids=["causal", "bidirectional",
                                           "window", "softcap"])
def test_flash_attention_matches_jax(Hq, Hkv, kwargs):
    """The cases of test_kernels.py::test_flash_attention."""
    q, k, v = _qkv(2, Hq, Hkv, 256, 256, 64)
    plain, op, want = _both(q, k, v, bq=64, bk=64, **kwargs)
    np.testing.assert_allclose(plain, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(op, plain)


def test_flash_attention_uneven_kv_len_matches_jax():
    """test_kernels.py::test_flash_attention_uneven_kv_len: Sq 128, Sk 256,
    queries at positions 0.. (not Sk - Sq ..)."""
    q, k, v = _qkv(1, 2, 2, 128, 256, 64, seed=1)
    for causal in (False, True):
        plain, op, want = _both(q, k, v, causal=causal, bq=64, bk=64)
        np.testing.assert_allclose(plain, want, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(op, plain)


def test_flash_attention_head_dim_32_matches_jax():
    """test_kernels.py::test_flash_matches_model_attention_core's shape."""
    q, k, v = _qkv(1, 2, 2, 128, 128, 32, seed=2)
    plain, op, want = _both(q, k, v, causal=True, bq=64, bk=64)
    np.testing.assert_allclose(plain, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(op, plain)


def test_flash_attention_defaults_bidirectional_like_jax():
    """test_backend.py::test_flash_attention_defaults_bidirectional: d 16,
    blocks of 32, causal off by default."""
    q, k, v = _qkv(1, 2, 2, 64, 64, 16, seed=3)
    plain, op, want = _both(q, k, v, bq=32, bk=32)
    np.testing.assert_allclose(plain, want, rtol=TOL, atol=TOL)
    causal = FA.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                      bq=32, bk=32).numpy()
    assert np.abs(plain - causal).max() > 1e-3


def test_flash_attention_head_dim_256_matches_jax():
    q, k, v = _qkv(1, 2, 1, 128, 128, 256, seed=4)
    for kw in (dict(causal=True), dict(causal=True, softcap=50.0)):
        plain, op, want = _both(q, k, v, bq=64, bk=64, **kw)
        np.testing.assert_allclose(plain, want, rtol=TOL, atol=TOL)


def test_flash_attention_bfloat16_matches_jax():
    """bfloat16 in, bfloat16 out, float32 inside: within 2e-4 of the JAX
    kernel's result plus one bfloat16 rounding."""
    q, k, v = _qkv(1, 4, 2, 128, 128, 64, seed=5)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jops.flash_attention(jq, jk, jv, causal=True, bq=64,
                                           bk=64).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (jq, jk, jv))
    got = ops.flash_attention(tq, tk, tv, causal=True, bq=64, bk=64)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= TOL + (TOL + BF16_ULP) * np.abs(want)).all()


def test_flash_attention_rows_without_a_valid_key_follow_the_kernel():
    """A window without causal and Sq > Sk + window - 1: rows whose blocks
    all skip return 0, rows whose run blocks hold no valid key the mean of
    those keys' values — the JAX kernel's answer, where the full-softmax
    oracle ref.flash_attention gives NaN."""
    q, k, v = _qkv(1, 2, 2, 256, 64, 16, seed=6)
    plain, op, want = _both(q, k, v, window=16, bq=32, bk=32)
    np.testing.assert_allclose(plain, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(op, plain)
    oracle = np.asarray(ref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), window=16))
    assert np.isnan(oracle[:, :, 96:]).all() and np.isfinite(plain).all()
    assert (plain[:, :, 96:] == 0).all()
    np.testing.assert_allclose(
        plain[:, :, 80:96],
        np.broadcast_to(v[:, :, 32:64].mean(axis=2, keepdims=True),
                        (1, 2, 16, 16)), atol=1e-6)


@pytest.mark.parametrize("bq,bk", [(32, 128), (128, 32), (16, 256)])
def test_flash_attention_block_sizes_set_only_the_skipped_blocks(bq, bk):
    """On rows with a valid key the block size changes the result by
    rounding only; the plain version follows JAX at each."""
    q, k, v = _qkv(1, 2, 1, 256, 256, 32, seed=7)
    kw = dict(causal=True, window=48)
    plain, _, want = _both(q, k, v, bq=bq, bk=bk, **kw)
    np.testing.assert_allclose(plain, want, rtol=TOL, atol=TOL)
    base = FA.flash_attention_plain(_t(q), _t(k), _t(v), bq=64, bk=64,
                                    **kw).numpy()
    np.testing.assert_allclose(plain, base, rtol=TOL, atol=TOL)


def test_flash_attention_refuses_blocks_that_do_not_divide():
    q, k, v = (_t(x) for x in _qkv(1, 2, 2, 96, 96, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, bq=64)
    with pytest.raises(ValueError):               # no kernel for the device
        FA.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_run_rows_follow_the_block_rules():
    # causal: blocks at or below the diagonal; window: blocks that reach it
    assert FA.run_rows(256, 64, 128, 64, True, None) == (128, 256)
    assert FA.run_rows(256, 64, 0, 64, False, 16) == (0, 128)
    assert FA.run_rows(256, 32, 32, 32, False, 16) == (0, 96)
    assert FA.run_rows(64, 32, 0, 32, True, 1) == (0, 32)


# ---------------------------------------------------------------------------
# the other seven ops against the JAX package's
# ---------------------------------------------------------------------------


def _codes(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def test_quant_linear_op_matches_jax():
    rng = np.random.default_rng(0)
    x_q, w_q = _codes(rng, (16, 64)), _codes(rng, (64, 32))
    ws = (rng.random(32) * 1e-3 + 1e-4).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    jargs = (jnp.asarray(x_q), jnp.asarray(w_q), jnp.asarray(ws),
             jnp.float32(0.02))
    targs = (_t(x_q), _t(w_q), _t(ws), torch.tensor(0.02))
    for out_dtype, jdt in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jops.quant_linear(*jargs, bias=jnp.asarray(b),
                                            act="gelu", out_dtype=jdt)
                          .astype(jnp.float32))
        got = ops.quant_linear(*targs, bias=_t(b), act="gelu",
                               out_dtype=out_dtype)
        assert got.dtype == out_dtype
        ulp = 0.0 if out_dtype == torch.float32 else BF16_ULP
        assert rel_linf(want, got.float().numpy()) <= 1e-6 + ulp
    default = ops.quant_linear(*targs, bias=_t(b), act="gelu")
    assert default.dtype == torch.bfloat16          # the JAX default
    q = ops.quant_linear(*targs, bias=_t(b), act="gelu",
                         out_scale=torch.tensor(0.05))
    jq = np.asarray(jops.quant_linear(*jargs, bias=jnp.asarray(b),
                                      act="gelu", out_scale=jnp.float32(0.05)))
    assert q.dtype == torch.int8
    assert np.abs(q.numpy().astype(int) - jq.astype(int)).max() <= 1


def test_addnorm_quant_op_matches_jax():
    rng = np.random.default_rng(1)
    x, res = (rng.standard_normal((8, 64)).astype(np.float32)
              for _ in range(2))
    bias = np.zeros(64, np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(64)).astype(np.float32)
    h, q = ops.addnorm_quant(_t(x), _t(res), _t(bias), _t(gamma), _t(beta),
                             torch.tensor(0.03))
    jh, jq = jops.addnorm_quant(*(jnp.asarray(a) for a in
                                  (x, res, bias, gamma, beta)),
                                jnp.float32(0.03))
    assert rel_linf(np.asarray(jh), h.numpy()) <= 1e-6
    diff = np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.005


def test_fused_embed_op_matches_jax():
    rng = np.random.default_rng(2)
    tok = rng.standard_normal((50, 32)).astype(np.float32)
    pos = rng.standard_normal((16, 32)).astype(np.float32)
    seg = rng.standard_normal((2, 32)).astype(np.float32)
    ids = rng.integers(0, 50, 24).astype(np.int32)
    segs = rng.integers(0, 2, 24).astype(np.int32)
    got = ops.fused_embed(_t(ids), _t(tok), _t(pos), _t(seg), _t(segs))
    want = jops.fused_embed(jnp.asarray(ids), jnp.asarray(tok),
                            jnp.asarray(pos), jnp.asarray(seg),
                            jnp.asarray(segs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dynamic_quant_op_matches_jax():
    """amax / 127 under jit is a multiply by the reciprocal in JAX: scales
    within an ulp, codes within one (ROADMAP Faults)."""
    x = np.random.default_rng(3).standard_normal((8, 64)).astype(np.float32)
    q, s = ops.dynamic_quant(_t(x))
    jq, js = jops.dynamic_quant(jnp.asarray(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1.2e-7,
                               atol=0)
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)).max() \
        <= 1


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_addnorm_quant_op_matches_jax_past_the_old_row_limit(kind):
    """Rows of 16384 values, past the 12,280 the first CUDA kernel held in
    shared memory (its streamed variant takes them now), under the
    budgets of ``test_addnorm_quant_op_matches_jax``."""
    rng = np.random.default_rng(6)
    D = 16384
    x, res = (rng.standard_normal((4, D)).astype(np.float32)
              for _ in range(2))
    bias = (0.1 * rng.standard_normal(D)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    beta = ((0.1 * rng.standard_normal(D)).astype(np.float32)
            if kind == "layernorm" else None)
    h, q = ops.addnorm_quant(_t(x), _t(res), _t(bias), _t(gamma),
                             None if beta is None else _t(beta),
                             torch.tensor(0.03), kind=kind)
    jh, jq = jops.addnorm_quant(
        *(jnp.asarray(a) for a in (x, res, bias, gamma)),
        None if beta is None else jnp.asarray(beta), jnp.float32(0.03),
        kind=kind)
    assert h.shape == q.shape == (4, D)
    assert rel_linf(np.asarray(jh), h.numpy()) <= 1e-6
    diff = np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.005


def test_dynamic_quant_op_matches_jax_past_32768():
    """Rows of 40000 values, past the register plan of the CUDA kernel (its
    streamed variant takes them), under the budgets of
    ``test_dynamic_quant_op_matches_jax``."""
    x = (np.random.default_rng(7).standard_normal((2, 40000)) * 3).astype(
        np.float32)
    q, s = ops.dynamic_quant(_t(x))
    jq, js = jops.dynamic_quant(jnp.asarray(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1.2e-7,
                               atol=0)
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)).max() \
        <= 1


def test_quant_expert_gemm_op_matches_jax():
    """Static per-expert scales: codes and outputs bit for bit (both
    dequantize as acc * (xs * ws))."""
    rng = np.random.default_rng(4)
    xe = rng.standard_normal((1, 4, 3, 32)).astype(np.float32)
    w_q = _codes(rng, (4, 32, 16))
    ws = (rng.random((4, 1, 16)) * 1e-3 + 1e-4).astype(np.float32)
    xs = (rng.random((4, 1, 1)) * 0.02 + 0.01).astype(np.float32)
    got = ops.quant_expert_gemm(_t(xe), _t(w_q), _t(ws), _t(xs))
    want = jops.quant_expert_gemm(jnp.asarray(xe), jnp.asarray(w_q),
                                  jnp.asarray(ws), jnp.asarray(xs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quant_flash_attention_op_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (_codes(rng, (2, 4, 16, 16)) for _ in range(3))
    k_pos = np.where(np.arange(16)[None] < np.array([[16], [9]]),
                     np.arange(16)[None], -1).astype(np.int32)
    kw = dict(q_scale=0.01, k_scale=0.03, p_scale=0.6 / 255, v_scale=0.02)
    jkw = {n: jnp.float32(x) for n, x in kw.items()}
    tkw = {n: torch.tensor(x) for n, x in kw.items()}
    got = ops.quant_flash_attention(_t(q), _t(k), _t(v), _t(k_pos), **tkw)
    want = np.asarray(jops.quant_flash_attention(
        *(jnp.asarray(a) for a in (q, k, v, k_pos)), **jkw))
    assert got.dtype == torch.float32
    assert rel_linf(want, got.numpy()) <= 5e-3
    got_q = ops.quant_flash_attention(_t(q), _t(k), _t(v), _t(k_pos),
                                      o_scale=torch.tensor(0.01), **tkw)
    want_q = np.asarray(jops.quant_flash_attention(
        *(jnp.asarray(a) for a in (q, k, v, k_pos)),
        o_scale=jnp.float32(0.01), **jkw))
    diff = np.abs(got_q.numpy().astype(int) - want_q.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3


def test_decode_attention_op_matches_jax():
    rng = np.random.default_rng(6)
    B_, Hkv, g, hd, ps, NP = 2, 2, 3, 16, 8, 6
    q = rng.standard_normal((B_, Hkv, g, hd)).astype(np.float32)
    kp, vp = (_codes(rng, (NP, ps, Hkv, hd)) for _ in range(2))
    table = np.array([[3, 1, -1], [0, 5, 2]], np.int32)
    lengths = np.array([13, 20], np.int32)
    ks, vs = ((rng.random((NP, ps, Hkv)) * 0.03 + 0.01).astype(np.float32)
              for _ in range(2))
    got = ops.decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                               _t(lengths), k_scale=_t(ks), v_scale=_t(vs),
                               per_head=False)
    want = jops.decode_attention(*(jnp.asarray(a) for a in
                                   (q, kp, vp, table, lengths)),
                                 k_scale=jnp.asarray(ks),
                                 v_scale=jnp.asarray(vs), per_head=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("op", ["flash", "quant_flash", "decode"])
def test_attention_ops_past_head_dim_256_match_jax(op):
    """The JAX kernels take any head dim; so do the port's wrappers (on the
    card the wide kernels, here their plain versions): at 320 each equals
    the JAX op within the budgets of the tests above."""
    rng = np.random.default_rng(7)
    d = 320
    if op == "flash":
        q, k, v = _qkv(1, 2, 1, 64, 64, d, seed=7)
        plain, got, want = _both(q, k, v, bq=32, bk=32, causal=True)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    elif op == "quant_flash":
        q, k, v = (_codes(rng, (1, 2, 8, d)) for _ in range(3))
        k_pos = np.where(np.arange(8)[None] < 6, np.arange(8)[None],
                         -1).astype(np.int32)
        kw = dict(q_scale=0.35 / d, k_scale=0.013, p_scale=0.6 / 255,
                  v_scale=0.02)
        got = ops.quant_flash_attention(
            _t(q), _t(k), _t(v), _t(k_pos),
            **{n: torch.tensor(x) for n, x in kw.items()})
        want = np.asarray(jops.quant_flash_attention(
            *(jnp.asarray(a) for a in (q, k, v, k_pos)),
            **{n: jnp.float32(x) for n, x in kw.items()}))
        assert got.shape == (1, 2, 8, d)
        assert rel_linf(want, got.numpy()) <= 5e-3
    else:
        q = rng.standard_normal((2, 1, 2, d)).astype(np.float32)
        kp, vp = (_codes(rng, (4, 8, 1, d)) for _ in range(2))
        table = np.array([[3, 1], [0, -1]], np.int32)
        lengths = np.array([13, 5], np.int32)
        ks, vs = ((rng.random((4, 8, 1)) * 0.03 + 0.01).astype(np.float32)
                  for _ in range(2))
        got = ops.decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                   _t(lengths), k_scale=_t(ks),
                                   v_scale=_t(vs), per_head=False)
        want = jops.decode_attention(*(jnp.asarray(a) for a in
                                       (q, kp, vp, table, lengths)),
                                     k_scale=jnp.asarray(ks),
                                     v_scale=jnp.asarray(vs), per_head=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_register_backend_is_reached_through_get_backend(monkeypatch):
    """A backend registered by name (through the toolkit's re-export) is
    what ``get_backend`` and a model forward's ``backend=`` resolve to."""
    from repro_torch import toolkit
    from repro_torch.configs import get_config
    from repro_torch.core.precision import EncoderPolicy
    from repro_torch.models import transformer as T

    class Counting(B.ComputeBackend):
        name = "counting"
        calls = 0

        def linear(self, x, p, *, act=None):
            Counting.calls += 1
            return None                       # the reference path

    monkeypatch.setitem(B.BACKENDS, "counting", B.BACKENDS["reference"])
    assert toolkit.register_backend("counting", Counting) is Counting
    assert toolkit.BACKENDS is B.BACKENDS
    assert B.BACKENDS["counting"] is Counting
    be = B.get_backend("counting")
    assert isinstance(be, Counting)
    cfg = get_config("qwen2-0.5b").reduced()
    params = T.init_params(cfg, seed=0, device="cpu")
    plan = T.build_plan(cfg, EncoderPolicy.full_float(cfg.num_layers))
    tokens = {"tokens": torch.ones((1, 4), dtype=torch.int32)}
    with torch.inference_mode():
        want = T.forward(params, tokens, cfg, plan)
        got = T.forward(params, tokens, cfg, plan, backend=be)
    assert Counting.calls > 0 and got.equal(want)
    with pytest.raises(KeyError):
        B.get_backend("unregistered")


def test_ops_launch_nothing_on_cpu():
    """Every op reaches its wrapper, which runs the plain version for CPU
    tensors and counts no launch."""
    kernels.reset_launches()
    x = torch.randn(4, 16)
    ops.dynamic_quant(x)
    q, k, v = (_t(a) for a in _qkv(1, 2, 1, 32, 32, 16))
    ops.flash_attention(q, k, v, causal=True)
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNEL_COUNTERS}
    assert sorted(kernels.KERNEL_COUNTERS) == sorted(
        ["quant_linear", "addnorm_quant", "dynamic_quant", "fused_embed",
         "quant_flash_attention", "decode_attention", "quant_expert_gemm",
         "flash_attention"])
    for name in ("quant_linear", "addnorm_quant", "fused_embed",
                 "dynamic_quant", "quant_expert_gemm", "flash_attention",
                 "quant_flash_attention", "decode_attention"):
        assert callable(getattr(ops, name)) and hasattr(jops, name)


# ---------------------------------------------------------------------------
# the shapes the kernels take, and the fused backend's claims
# ---------------------------------------------------------------------------


def test_decode_block_rows_cover_the_kernel_tables():
    """Every head dim up to 256 with every page size up to 128 (zero-padded
    to the next instantiation), any GQA group (split over blocks of at most
    32 rows that fit the shared memory); a 256-dim page of 128 tokens fits
    with K and V sharing one page buffer."""
    for hd, ps, g in ((64, 16, 7), (256, 16, 2), (64, 64, 1), (64, 16, 48),
                      (48, 16, 1), (80, 3, 7), (18, 5, 1), (128, 128, 48),
                      (256, 64, 32), (256, 128, 1), (256, 128, 2),
                      (200, 100, 7)):
        assert DA.block_rows(hd, ps, g), (hd, ps, g)
    assert not DA.block_rows(320, 16, 1) and not DA.block_rows(64, 256, 1)
    assert not DA.block_rows(64, 16, 0)
    assert [DA.block_rows(64, 16, g) for g in (1, 7, 32, 33, 40, 48)] == \
        [1, 7, 32, 17, 20, 24]
    assert DA.block_rows(256, 64, 48) == 24
    assert [DA.block_rows(256, 128, g) for g in (1, 7, 32, 48)] == \
        [1, 7, 32, 24]
    # the layout of csrc/decode_attention.cu in floats, at qwen2's shape:
    # q, K, V, their scales, scores, acc, m / l / alpha, the weights of up
    # to 32 splits a row, the last-block flag
    assert DA.decode_attention_smem(7, 64, 16) == 4 * (
        7 * 65 + 2 * 16 * 65 + 2 * 16 + 7 * 16 + 7 * 64 + 3 * 7 + 7 * 32
        + 1)
    assert DA.decode_attention_smem(7, 48, 16) == \
        DA.decode_attention_smem(7, 64, 16)
    # at head dim 256 with pages of 128, one page buffer for K and V
    assert DA.decode_attention_smem(2, 256, 128) == 4 * (
        2 * 257 + 128 * 257 + 2 * 128 + 2 * 128 + 2 * 256 + 3 * 2 + 2 * 32
        + 1)
    for hd in DA.HEAD_DIMS:
        for ps in DA.PAGE_SIZES:
            assert DA.kv_buffers(hd, ps) == (1 if (hd, ps) == (256, 128)
                                             else 2)
            rows = DA.block_rows(hd, ps, 64)
            assert rows
            assert DA.decode_attention_smem(rows, hd, ps) <= DA._MAX_SMEM


def test_quant_flash_attention_smem_mirrors_the_kernel_layout():
    """The row-block kernel's layout, in bytes, with DP the head dim rounded
    up to 32, 64, 128, 256 and rows DP + 16 bytes apart: 32 q rows, a ring
    of three K / V tiles of 128 keys, a float score row per query row over
    the key axis (padded to 128, plus 8), k_pos, 4 key warps' row maxima,
    the row sums, V's column sums, an int32 accumulator (rows DP + 1
    words). At Sk 512 it is the 109 KB the 512-key case uses; d = 64 takes
    it up to Sk 1408, and past it the long-key kernel streams K and V."""
    assert FA.quant_flash_attention_smem(128, 64) == \
        (32 + 3 * 128) * 80 + 4 * 32 * 136 + 4 * 128 + 4 * 4 * 32 \
        + 4 * 32 + 4 * 64 + 4 * 32 * 65 == 60416
    assert FA.quant_flash_attention_smem(8, 64) == \
        FA.quant_flash_attention_smem(128, 64)
    assert FA.quant_flash_attention_smem(512, 64) == 111104
    assert FA.quant_flash_attention_smem(1408, 64) == 229376
    assert FA.quant_flash_attention_smem(1409, 64) > FA._MAX_SMEM
    assert FA.quant_flash_attention_smem(16, 20) == \
        FA.quant_flash_attention_smem(16, 32)
    assert not FA.quant_flash_attention_tiled(1408, 64)
    assert FA.quant_flash_attention_tiled(1409, 64)
    assert FA.quant_flash_attention_tiled(32768, 64)
    assert not FA.quant_flash_attention_tiled(128, 18)   # padded to 20
    assert not FA.quant_flash_attention_tiled(600, 128)


def test_float_flash_attention_smem_and_head_dims():
    assert [FA.float_head_dim(d) for d in (1, 16, 17, 48, 64, 65, 200,
                                            256, 257)] == \
        [16, 16, 32, 64, 64, 128, 256, 256, None]
    assert FA.flash_attention_smem(64) == 87040
    assert FA.flash_attention_smem(64, torch.bfloat16) == 64512
    assert max(FA.flash_attention_smem(d) for d in FA.FLOAT_HEAD_DIMS) \
        <= FA._MAX_SMEM
    with pytest.raises(ValueError):
        FA.flash_attention_smem(320)


class _Stub:
    """Stands in for a kernel wrapper: records its calls and fails them, so
    a test sees that the fused backend claimed the op."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *a, **kw):
        self.calls += 1
        raise AssertionError("claimed")


def _decode_ops(hd, ps, g, seed=0):
    rng = np.random.default_rng(seed)
    B_, Hkv, NP = 2, 2, 5
    return dict(
        q=_t(rng.standard_normal((B_, Hkv, g, hd)).astype(np.float32)),
        k_pages=_t(_codes(rng, (NP, ps, Hkv, hd))),
        v_pages=_t(_codes(rng, (NP, ps, Hkv, hd))),
        page_table=_t(np.array([[4, 1], [0, -1]], np.int32)),
        lengths=_t(np.array([ps + 3, ps - 2], np.int32)),
        k_scale=_t((rng.random((NP, ps, Hkv)) * 0.03 + 0.01)
                   .astype(np.float32)),
        v_scale=_t((rng.random((NP, ps, Hkv)) * 0.03 + 0.01)
                   .astype(np.float32)),
        per_head=False, scale=hd ** -0.5)


@pytest.mark.parametrize("hd,ps,g", [(64, 16, 7), (256, 16, 2), (64, 64, 2),
                                     (32, 8, 40)],
                         ids=["qwen2", "head_dim_256", "page_size_64",
                              "group_40"])
def test_fused_decode_claims_every_shape(monkeypatch, hd, ps, g):
    """The fused backend hands every int8-paged step to the kernel's
    wrapper, whatever the shape; with the real wrapper on CPU tensors it
    equals the reference backend (the same plain version) exactly."""
    args = _decode_ops(hd, ps, g)
    want = B.ComputeBackend().paged_decode(**args)
    assert B.FusedBackend().paged_decode(**args).equal(want)
    stub = _Stub()
    monkeypatch.setattr(B, "paged_decode_attention", stub)
    with pytest.raises(AssertionError, match="claimed"):
        B.FusedBackend().paged_decode(**args)
    assert stub.calls == 1


def _attn_params():
    return {"q_scale": torch.tensor(0.01), "k_scale": torch.tensor(0.03),
            "p_scale": torch.tensor(0.4 / 255), "v_scale": torch.tensor(0.03)}


@pytest.mark.parametrize("Sk,d", [(2048, 64), (1337, 64), (128, 18),
                                  (1336, 64), (512, 64)])
def test_fused_attention_claims_every_shape(monkeypatch, Sk, d):
    """Keys past the resident kernel's shared memory (Sk > 1336 at d = 64)
    and a head dim that is not a multiple of 4 are the kernel's too: the
    fused backend claims the core at every shape."""
    stub = _Stub()
    monkeypatch.setattr(B, "quant_flash_attention", stub)
    rng = np.random.default_rng(0)
    q, k, v = (_t(rng.standard_normal((1, Sk, 2, d)).astype(np.float32))
               for _ in range(3))
    kw = dict(k_pos=torch.arange(Sk, dtype=torch.int32),
              spec=L.MaskSpec(causal=False), scale=d ** -0.5)
    assert B.ComputeBackend().attention(q, k, v, _attn_params(), **kw) \
        is None
    with pytest.raises(AssertionError, match="claimed"):
        B.FusedBackend().attention(q, k, v, _attn_params(), **kw)
    assert stub.calls == 1


@pytest.mark.parametrize("Sk,head_dim", [(2048, 64), (64, 18)])
def test_attention_block_at_unresident_shapes(Sk, head_dim):
    """A whole uint8-softmax attention layer on the fused backend (CPU
    tensors) at 2048 keys, or at a head dim that is not a multiple of 4,
    equals the reference backend. At 2048 keys the reference core's int8
    P.V once refused (a float32 product of more than 1024 terms); its
    float32 chunks now follow the codes' ranges, so it serves them too."""
    from repro_torch.configs import get_config
    from repro_torch.core.plan import LayerPlan, PrecisionPlan
    from repro_torch.core.precision import LayerMode
    from repro_torch.models import transformer as T
    from repro_torch.quant import ptq
    cfg = get_config("bert-base").reduced().replace(
        num_layers=1, head_dim=head_dim, max_position=2048)
    lp = LayerPlan.for_mode(LayerMode.FULLY_QUANT, softmax="uint8")
    plan = PrecisionPlan((lp,), "float32")
    fp = PrecisionPlan.full_float(1, "float32")
    params = T.init_params(cfg, fp, seed=0, head=("cls", 3), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (2, Sk))
             .astype(np.int32)}
    stats = ptq.capture_stats(params, [batch], cfg, T.build_plan(cfg, fp),
                              precision=plan)
    q, qplan = ptq.apply_plan(params, cfg, plan, stats,
                              float_plan=T.build_plan(cfg, fp))
    tokens = {"tokens": torch.from_numpy(batch["tokens"])}
    outs = []
    for name in ("fused", "reference"):
        with torch.inference_mode():
            outs.append(T.forward(q, tokens, cfg, qplan,
                                  backend=B.get_backend(name)))
    assert outs[0].shape == (2, Sk, cfg.d_model)
    assert torch.isfinite(outs[0]).all()
    assert outs[0].equal(outs[1])
