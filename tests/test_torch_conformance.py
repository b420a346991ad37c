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
apart. ``test_lm_loss_and_grads_match_jax`` holds each config's training
loss and every gradient leaf against ``jax.value_and_grad`` of the JAX
package's ``lm_loss`` on the same params and batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.plan import PrecisionPlan as JaxPlan
from repro.models import transformer as JT

from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.core.calibration import synthetic_calibration_batches
from repro_torch.core.plan import PrecisionPlan, plan_from_policy
from repro_torch.core.precision import make_policy
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.core.samp import SAMPEngine, moe_family_variant
from repro_torch.interop import (flatten_names, params_from_numpy,
                                 params_to_numpy)
from repro_torch.kernels.backend import get_backend
from repro_torch.models import transformer as T
from repro_torch.toolkit.artifact import load_artifact, save_artifact
from repro_torch.train import TrainConfig, Trainer

from test_torch_support import jax_to_numpy, rel_linf

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


# gradient rel-Linf of each leaf against JAX's: float32 reduction order of
# the attention families' GEMMs, and the recurrent bodies' scan-order sums
# (ROADMAP section 3) on top
GRAD_RTOL = {"hybrid": 5e-5, "ssm": 5e-5}
GRAD_RTOL_DEFAULT = 2e-5


@pytest.mark.parametrize("arch", PARAMS)
def test_lm_loss_and_grads_match_jax(arch):
    """The training loss (next-token CE; frame CE for audio; the text
    region for vision) and every gradient leaf, through the Trainer's
    value-and-grad, against ``jax.value_and_grad`` of JAX's ``lm_loss`` in
    float32: JAX's seeded params carried across, one numpy batch of 2 x 8.
    Loss within 1e-5 relative; each leaf within its family's rel-Linf.
    A leaf the loss does not reach (hubert's ``embed/tok``) is zero in
    both."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jfp = JaxPlan.full_float(jcfg.num_layers, "float32")
    fp = PrecisionPlan.full_float(cfg.num_layers, "float32")
    jplan = JT.build_plan(jcfg, jfp)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, jfp)
    tr = Trainer(cfg, fp, tcfg=TrainConfig(remat=False,
                                           compute_dtype="float32"),
                 device="cpu")
    params = params_from_numpy(jax_to_numpy(jparams), tr.plan, "cpu")
    batch = synthetic_calibration_batches(cfg, num_batches=1, batch_size=2,
                                          seq_len=8, seed=0)[0]
    if cfg.frontend == "audio":
        batch["labels"] = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 8), dtype=np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, b, jcfg, jplan,
                                compute_dtype=jnp.float32)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = tr._value_and_grad(params, tr._on_device(batch))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = dict(flatten_names(jax_to_numpy(jgrads)))
    got = dict(flatten_names(params_to_numpy(grads, tr.plan)))
    assert got.keys() == want.keys()
    tol = GRAD_RTOL.get(cfg.family, GRAD_RTOL_DEFAULT)
    for name in want:
        assert rel_linf(want[name], got[name]) <= tol, (arch, name)
    if cfg.frontend == "audio":
        assert not want["embed/tok"].any() and not got["embed/tok"].any()
