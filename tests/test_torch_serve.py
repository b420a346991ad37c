"""Port parity for the slice as a whole — JAX-quantized reduced bert-base
carried across and served by both packages' EncoderServeEngine — plus the
runtime and scheduler contracts, the entry points' device rule, and the
port's import boundary (no JAX, nothing of ``repro``)."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve import EncoderRequest as JaxRequest
from repro.serve import EncoderServeEngine as JaxEngine
from repro.serve import MicroBatcher as JaxBatcher
from repro.serve.runtime import bucket_size as jax_bucket_size

from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.serve import (EncoderRequest, EncoderServeEngine,
                               MicroBatcher, Runtime, bucket_size)

from test_torch_support import GOLDEN, bert_slice, rel_linf

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.fixture(scope="module")
def s():
    return bert_slice(GOLDEN)


def _requests(cfg, n=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, int(rng.integers(3, 30))).tolist()
            for _ in range(n)]


def _serve_jax(s, reqs, backend):
    eng = JaxEngine(s["jcfg"], s["jq"], s["jqplan"], target="cls",
                    backend=backend)
    for i, toks in enumerate(reqs):
        eng.submit(JaxRequest(uid=i, tokens=toks))
    done = sorted(eng.run(), key=lambda r: r.uid)
    return (np.stack([r.logits for r in done]),
            [int(r.prediction) for r in done])


def _serve_port(s, reqs, backend, params=None):
    eng = EncoderServeEngine(s["cfg"], params or s["qparams_from_jax"],
                             s["qplan"], backend=backend, device="cpu")
    for i, toks in enumerate(reqs):
        eng.submit(EncoderRequest(uid=i, tokens=toks))
    done = sorted(eng.run(), key=lambda r: r.uid)
    return (np.stack([r.logits for r in done]),
            [int(r.prediction) for r in done]), eng


# ---------------------------------------------------------------------------
# the slice against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("jax_backend", ["reference", "fused"])
def test_engine_matches_jax_engine(s, backend, jax_backend):
    """Same requests, same buckets (both engines flush one (length bucket)
    queue at a time with max_batch 8), JAX-quantized params carried across."""
    reqs = _requests(s["cfg"])
    want, want_pred = _serve_jax(s, reqs, jax_backend)
    (got, pred), eng = _serve_port(s, reqs, backend)
    assert got.shape == want.shape == (len(reqs), 15)
    assert np.isfinite(got).all()
    assert rel_linf(want, got) <= 5e-3
    assert pred == want_pred
    assert eng.stats["retired"] == len(reqs)


def test_port_ptq_serves_like_jax(s):
    """The port's own apply_plan (on the carried float params and the JAX
    stats) serves what the JAX engine serves."""
    from repro_torch.quant import ptq
    qparams, _ = ptq.apply_plan(s["params"], s["cfg"], s["plan"],
                                s["jstats"], float_plan=s["float_plan"])
    reqs = _requests(s["cfg"], seed=1)
    want, want_pred = _serve_jax(s, reqs, "reference")
    (got, pred), _ = _serve_port(s, reqs, "fused", params=qparams)
    assert rel_linf(want, got) <= 5e-3 and pred == want_pred


def test_fused_matches_reference_and_pads_cleanly(s):
    """Fused == reference on the CPU (the kernels' plain versions), and a
    request served alone matches it served inside a padded batch."""
    reqs = _requests(s["cfg"], n=6, seed=2)
    (ref, _), _ = _serve_port(s, reqs, "reference")
    (fused, _), _ = _serve_port(s, reqs, "fused")
    assert rel_linf(ref, fused) <= 5e-3
    (alone, _), _ = _serve_port(s, reqs[:1], "fused")
    assert rel_linf(alone[0], fused[0]) <= 1e-5


# ---------------------------------------------------------------------------
# runtime and scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 100, 128, 129, 300])
@pytest.mark.parametrize("floor,cap", [(1, None), (8, None), (8, 256)])
def test_bucket_size_matches(n, floor, cap):
    assert bucket_size(n, floor, cap) == jax_bucket_size(n, floor, cap)


def test_bucket_size_rejects_empty():
    with pytest.raises(ValueError):
        bucket_size(0)


def test_micro_batcher_flushes_like_jax():
    ours, ref = MicroBatcher(max_batch=2, max_wait=1.0), \
        JaxBatcher(max_batch=2, max_wait=1.0)
    lengths = [5, 6, 12, 7, 30, 3]
    for i, n in enumerate(lengths):
        ours.submit(EncoderRequest(uid=i, tokens=[1] * n), now=float(i) / 10)
        ref.submit(JaxRequest(uid=i, tokens=[1] * n), now=float(i) / 10)
    for now, force in ((0.55, False), (1.35, False), (2.0, True)):
        a = [(b, [r.uid for r in rs]) for b, rs in ours.ready(now, force)]
        b = [(b, [r.uid for r in rs]) for b, rs in ref.ready(now, force)]
        assert a == b
    assert len(ours) == 0


def test_micro_batcher_evict_and_cancel():
    mb = MicroBatcher(max_batch=4)
    reqs = [EncoderRequest(uid=i, tokens=[1] * (i + 1)) for i in range(5)]
    for r in reqs:
        mb.submit(r, now=0.0)
    assert mb.cancel(reqs[0]) and not mb.cancel(reqs[0])
    assert [r.uid for r in mb.evict(lambda r: r.uid % 2)] == [1, 3]
    assert len(mb) == 2 and mb.evicted == 3


def test_runtime_caches_per_bucket_and_counts(s):
    rt = Runtime(s["cfg"], s["qplan"], precision=s["plan"], backend="fused",
                 device="cpu")
    p = s["qparams_from_jax"]
    tok = np.ones((3, 10), np.int32)
    rt.encode(p, {"tokens": tok}, np.array([10, 4, 7]))
    rt.encode(p, {"tokens": tok[:2, :9]}, np.array([9, 9]))
    rt.encode(p, {"tokens": np.ones((1, 20), np.int32)})
    rt.encode(p, {"tokens": tok[:, :3]}, np.array([3, 3, 3]))   # (4, 8)
    rt.encode(p, {"tokens": tok}, np.array([10, 10, 10]))       # reused
    st = rt.stats
    assert st["calls"] == 5 and st["executables"] == 4
    assert st["buckets"] == [(1, 32), (2, 16), (4, 8), (4, 16)]
    assert st["real_tokens"] == 21 + 18 + 20 + 9 + 30
    assert st["padded_tokens"] == ((4 * 16 - 21) + (2 * 16 - 18) + (32 - 20)
                                   + (4 * 8 - 9) + (4 * 16 - 30))
    key = next(iter(rt._exe))
    # (backend, plan fingerprint, mesh fingerprint, cluster): "unmeshed"
    # without a mesh, None for an unrouted runtime
    assert key[1] == ("fused", s["plan"].fingerprint(), "unmeshed", None)


def test_runtime_masks_padding(s):
    """Padding a row with garbage tokens does not move its hidden states."""
    rt = Runtime(s["cfg"], s["qplan"], device="cpu")
    p = s["qparams_from_jax"]
    a = np.full((1, 8), 5, np.int32)
    b = a.copy()
    b[0, 5:] = 77
    ha = rt.encode(p, {"tokens": a}, np.array([5]))
    hb = rt.encode(p, {"tokens": b}, np.array([5]))
    np.testing.assert_allclose(ha[0, :5], hb[0, :5], rtol=1e-5, atol=1e-6)


def test_engine_validates_requests(s):
    eng = EncoderServeEngine(s["cfg"], s["qparams_from_jax"], s["qplan"],
                             max_len=16, device="cpu")
    for bad in (EncoderRequest(uid=0, tokens=[]),
                EncoderRequest(uid=1, tokens=[1] * 17),
                EncoderRequest(uid=2, tokens=[1, 2], segments=[0])):
        with pytest.raises(ValueError):
            eng.submit(bad)
    with pytest.raises(ValueError):
        EncoderServeEngine(s["cfg"], {"layers": []}, s["qplan"],
                           device="cpu")
    with pytest.raises(KeyError):
        EncoderServeEngine(s["cfg"], s["qparams_from_jax"], s["qplan"],
                           target="ner", device="cpu")


# ---------------------------------------------------------------------------
# the device rule: CUDA by default, never a silent move to the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["init_params", "runtime", "engine",
                                   "params_from_numpy"])
def test_entry_points_default_to_cuda(s, entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "init_params":
            T.init_params(s["cfg"])
        elif entry == "runtime":
            Runtime(s["cfg"], s["qplan"])
        elif entry == "engine":
            EncoderServeEngine(s["cfg"], s["qparams_from_jax"], s["qplan"])
        else:
            from test_torch_support import jax_to_numpy
            params_from_numpy(jax_to_numpy(s["jq"]), s["qplan"])


# ---------------------------------------------------------------------------
# import boundary
# ---------------------------------------------------------------------------


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            for arg in node.args:
                if isinstance(arg, ast.Constant):
                    yield str(arg.value)
                elif isinstance(arg, ast.JoinedStr):
                    yield "".join(str(v.value) for v in arg.values
                                  if isinstance(v, ast.Constant))


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro") or name.startswith("flax")


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): name for f in files
           for name in _imports(f) if _banned(name)}
    assert not bad, bad


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
