"""Cross-architecture conformance of the port: every config of its registry,
the full pipeline at reduced dims, as ``tests/test_conformance.py`` runs the
JAX package's.

Each architecture runs build -> synthetic calibration -> apply_plan ->
fused-vs-reference forward (on the CPU the fused backend runs the kernels'
plain versions behind its dispatch) -> bundle round trip. The parameters
are the registry itself (``all_configs()``), with ``<family>__<arch>`` ids
so one family runs with ``-k "<family>__"``. MoE configs quantize through
the schema-v4 ``experts`` family (per-expert weight scales, a float
router). Every config passes every stage: there is no skip or xfail, and
``test_registry_fully_covered`` fails if the list and the registry drift
apart."""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.core.calibration import synthetic_calibration_batches
from repro_torch.core.plan import plan_from_policy
from repro_torch.core.precision import make_policy
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.core.samp import SAMPEngine, moe_family_variant
from repro_torch.interop import flatten_names
from repro_torch.kernels.backend import get_backend
from repro_torch.models import transformer as T
from repro_torch.toolkit.artifact import load_artifact, save_artifact

ARCHS = sorted(all_configs())
PARAMS = [pytest.param(a, id=f"{get_config(a).family}__{a}") for a in ARCHS]


_built: dict = {}


def built(arch):
    """Build once a process: the seeded float init of the reduced config,
    synthetic calibration under the plan that quantizes every FFN block
    (with the experts family on MoE configs) and its apply."""
    if arch not in _built:
        cfg = get_config(arch).reduced()
        eng = SAMPEngine(cfg, float_dtype="float32")
        params = T.init_params(cfg, eng.float_precision, seed=0,
                               device="cpu")
        batches = synthetic_calibration_batches(cfg, num_batches=2,
                                                seq_len=16)
        precision = plan_from_policy(make_policy(cfg, "ffn",
                                                 float_dtype="float32"))
        if cfg.moe is not None:
            precision = moe_family_variant(precision)
        stats = eng.calibrate(params, batches, precision=precision)
        qparams, qplan = eng.apply(params, stats, precision)
        batch = {k: torch.from_numpy(np.asarray(v))
                 for k, v in batches[0].items()}
        _built[arch] = (cfg, eng, precision, stats, qparams, qplan, batch)
    return _built[arch]


def _forward(cfg, params, plan, batch, backend=None):
    with torch.inference_mode():
        return T.forward(params, batch, cfg, plan, backend=backend).numpy()


def test_registry_fully_covered():
    """The suite's list is the registry: all eleven archs of the JAX
    package, so a new config shows up here and a pruned one fails."""
    assert ARCHS == sorted(all_configs()) == sorted(ARCH_IDS)
    assert len(ARCHS) == 11


@pytest.mark.parametrize("arch", PARAMS)
def test_calibrate_and_apply(arch):
    """Synthetic calibration and apply_plan give int8 leaves on every
    layer; MoE archs per-expert (E, 1, F) weight scales under the experts
    family and a float router."""
    cfg, eng, precision, stats, qparams, qplan, batch = built(arch)
    assert precision.num_quant_ffn == cfg.num_layers
    assert set(stats) == {f"layer{i}" for i in range(cfg.num_layers)}
    for i, lp in enumerate(qparams["layers"]):
        int8 = [n for n, v in flatten_names(lp)
                if v.dtype == torch.int8]
        assert int8, f"{arch}: layer {i} has no int8 leaf"
    if cfg.moe is not None:
        E = cfg.moe.num_experts
        stacks = [sub["w"] for lp in qparams["layers"]
                  for sub in lp["ffn"].values()
                  if isinstance(sub, dict)
                  and isinstance(sub.get("w"), QuantizedTensor)
                  and sub["w"].values.ndim == 3]
        assert stacks and all(w.scale.shape[:2] == (E, 1) for w in stacks)
        routers = [lp["ffn"]["router"] for lp in qparams["layers"]
                   if "router" in lp["ffn"]]
        assert routers and all(
            not isinstance(r["w"], QuantizedTensor)
            and r["w"].dtype.is_floating_point for r in routers)


@pytest.mark.parametrize("arch", PARAMS)
def test_fused_matches_reference(arch):
    """The fused backend (the kernels' plain versions on the CPU) against
    the reference on the quantized forward: within 5e-3, the JAX suite's
    budget."""
    cfg, eng, precision, stats, qparams, qplan, batch = built(arch)
    ref = _forward(cfg, qparams, qplan, batch)
    fused = _forward(cfg, qparams, qplan, batch, get_backend("fused"))
    assert np.isfinite(fused).all()
    rel = float(np.abs(ref - fused).max() / (np.abs(ref).max() + 1e-9))
    assert rel < 5e-3, f"{arch}: fused-vs-reference rel Linf {rel}"


@pytest.mark.parametrize("arch", PARAMS)
def test_bundle_roundtrip(arch, tmp_path):
    """save_artifact -> load_artifact gives back the plan's fingerprint,
    the config and a bit-identical forward."""
    cfg, eng, precision, stats, qparams, qplan, batch = built(arch)
    path = save_artifact(str(tmp_path / "bundle"), cfg=cfg,
                         policy=precision, stats=stats, params=qparams,
                         scheme=eng.scheme)
    art = load_artifact(path, device="cpu")
    assert art.precision.fingerprint() == precision.fingerprint()
    assert art.cfg == cfg
    want = _forward(cfg, qparams, qplan, batch)
    got = _forward(art.cfg, art.params, art.plan, batch)
    np.testing.assert_array_equal(want, got)
