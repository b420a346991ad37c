"""Port parity: quantization primitives and calibrators
(repro_torch.core.quantize / core.calibration against repro's)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro.core import quantize as jq

from repro_torch.configs import get_config
from repro_torch.core import calibration as cal
from repro_torch.core import quantize as q


def _inputs(seed: int, kind: str, shape=(6, 40)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    if kind == "ties":
        # values at exact (k + 0.5) multiples of the per-tensor scale: the
        # rounding ties where half-to-even and divide-vs-reciprocal matter
        amax = np.float32(np.abs(x).max())
        scale = np.float32(amax) / np.float32(127.0)
        k = rng.integers(-120, 120, shape).astype(np.float32)
        x = ((k + np.float32(0.5)) * scale).astype(np.float32)
        x.flat[0] = amax
    return x


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("granularity",
                         ["tensor", "channel", "token", "unsigned"])
def test_quantize_codes_equal(seed, kind, granularity):
    x = _inputs(seed, kind)
    if granularity == "tensor":
        ours, ref = q.quantize_per_tensor(_t(x)), \
            jq.quantize_per_tensor(jnp.asarray(x))
    elif granularity == "channel":
        ours, ref = q.quantize_per_channel(_t(x), axis=-1), \
            jq.quantize_per_channel(jnp.asarray(x), axis=-1)
    elif granularity == "token":
        ours, ref = q.quantize_per_token(_t(x)), \
            jq.quantize_per_token(jnp.asarray(x))
    else:
        x = np.abs(x)
        ours, ref = q.quantize_unsigned(_t(x)), \
            jq.quantize_unsigned(jnp.asarray(x))
        assert int(ours.zero_point) == int(ref.zero_point) == -128
    np.testing.assert_array_equal(ours.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(ours.dequantize().numpy(),
                                  np.asarray(ref.dequantize()))


@pytest.mark.parametrize("amax", [0.0, 1e-9, 0.3, 7.5, 127.0, 1e6])
def test_compute_scale_symmetric_equal(amax):
    ours = q.compute_scale_symmetric(torch.tensor(amax, dtype=torch.float32))
    ref = jq.compute_scale_symmetric(jnp.float32(amax))
    assert float(ours) == float(ref)


@pytest.mark.parametrize("x_scheme", ["tensor", "token", "unsigned"])
def test_int8_matmul_equal(x_scheme):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 48)).astype(np.float32)
    w = rng.standard_normal((48, 24)).astype(np.float32)
    wq, jwq = q.quantize_per_channel(_t(w)), \
        jq.quantize_per_channel(jnp.asarray(w))
    if x_scheme == "tensor":
        xq, jxq = q.quantize_per_tensor(_t(x)), \
            jq.quantize_per_tensor(jnp.asarray(x))
    elif x_scheme == "token":
        xq, jxq = q.quantize_per_token(_t(x)), \
            jq.quantize_per_token(jnp.asarray(x))
    else:
        xq, jxq = q.quantize_unsigned(_t(np.abs(x))), \
            jq.quantize_unsigned(jnp.asarray(np.abs(x)))
    ours = q.int8_matmul(xq, wq).numpy()
    ref = np.asarray(jq.int8_matmul(jxq, jwq, out_dtype=jnp.float32))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)


def test_int_matmul_exact_at_extremes():
    """All -128 codes: every product is 2**14, the largest partial sums."""
    a = torch.full((3, 2, 1024), -128, dtype=torch.int8)
    b = torch.full((3, 1024, 5), -128, dtype=torch.int8)
    out = q.int_matmul(a, b)
    assert out.dtype == torch.int32
    assert int(out.min()) == int(out.max()) == 1024 * 128 * 128
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, (4, 2000)).astype(np.int8)
    b = rng.integers(-128, 128, (2000, 3)).astype(np.int8)
    np.testing.assert_array_equal(
        q.int_matmul(_t(a), _t(b)).numpy(),
        a.astype(np.int64) @ b.astype(np.int64))


def test_divide_is_true_division():
    x = torch.tensor([1.0, 3.0, 10.0, 1e-8], dtype=torch.float32)
    np.testing.assert_array_equal(q.divide(x, 127.0).numpy(),
                                  x.numpy() / np.float32(127.0))


@pytest.mark.parametrize("name", sorted(cal.CALIBRATORS))
@pytest.mark.parametrize("seed", [0, 1])
def test_calibrators_pick_same_amax(name, seed):
    """Same observations (with a range expansion between batches) -> the
    same amax from both packages' calibrators."""
    rng = np.random.default_rng(seed)
    batches = [rng.standard_normal((64, 32)).astype(np.float32) * s
               for s in (1.0, 2.5, 0.7)]
    ours, ref = cal.make_calibrator(name), jcal.make_calibrator(name)
    for b in batches:
        ours.observe(torch.from_numpy(b))
        ref.observe(b)
    assert ours.compute_amax() == pytest.approx(ref.compute_amax(),
                                                rel=1e-6)


def test_calibrator_registry_and_errors():
    assert sorted(cal.CALIBRATORS) == sorted(jcal.CALIBRATORS)
    with pytest.raises(KeyError):
        cal.make_calibrator("magic")
    with pytest.raises(ValueError):
        cal.PercentileCalibrator(percentile=0.0)
    for name in cal.CALIBRATORS:
        assert cal.make_calibrator(name).compute_amax() == cal.EPS


def test_synthetic_calibration_batches():
    cfg = get_config("bert-base").reduced()
    a = cal.synthetic_calibration_batches(cfg, num_batches=3, batch_size=2,
                                          seq_len=16, seed=5)
    b = cal.synthetic_calibration_batches(cfg, num_batches=3, batch_size=2,
                                          seq_len=16, seed=5)
    assert len(a) == 3
    for x, y in zip(a, b):
        assert set(x) == {"tokens", "segments"}
        assert x["tokens"].shape == (2, 16) and x["tokens"].dtype == np.int32
        assert 0 <= x["tokens"].min() and x["tokens"].max() < cfg.vocab_size
        assert not x["segments"].any()
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
