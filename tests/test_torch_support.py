"""Shared helpers of the ``test_torch_*`` parity suite (this module holds
no tests): moving JAX values into numpy for the port, and building the
reduced BERT slice, and any reduced arch under the golden plan, once in both
packages from the same numpy inputs."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.core.plan import PrecisionPlan as JaxPlan
from repro.core.quantize import QuantizedTensor as JaxQT
from repro.core.samp import int8_dataflow_variant as jax_dataflow_variant
from repro.core.samp import moe_family_variant as jax_moe_variant
from repro.models import transformer as JT
from repro.quant import ptq as jptq

from repro_torch.configs import get_config
from repro_torch.core.calibration import synthetic_calibration_batches
from repro_torch.core.plan import PrecisionPlan
from repro_torch.core.samp import int8_dataflow_variant, moe_family_variant
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as T

GOLDEN = "tests/data/golden_plan.json"
GOLDEN_V4 = "tests/data/golden_plan_v4.json"
N_CLASSES = 15


def jax_to_numpy(tree):
    """A JAX parameter tree as nested dicts / lists / tuples of numpy
    arrays, each QuantizedTensor as {"values", "scale", "zero_point"}."""
    if isinstance(tree, JaxQT):
        return {"values": np.asarray(tree.values),
                "scale": np.asarray(tree.scale),
                "zero_point": (None if tree.zero_point is None
                               else np.asarray(tree.zero_point))}
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_to_numpy(v) for v in tree)
    if tree is None:
        return None
    return np.asarray(tree)


def rel_linf(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


def to_jax_batches(batches):
    return [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]


def bert_slice(plan_path: str = GOLDEN, *, dataflow: bool = False) -> dict:
    """Reduced bert-base in both packages: JAX float params (seeded) carried
    into the port, calibration stats from each package on the same numpy
    batches, and the JAX-quantized params under ``plan_path`` — or, with
    ``dataflow``, under each package's ``int8_dataflow_variant`` of it (the
    schema-v3 whole-layer int8 span)."""
    jcfg = jax_get_config("bert-base").reduced()
    cfg = get_config("bert-base").reduced()
    jplan, plan = JaxPlan.load(plan_path), PrecisionPlan.load(plan_path)
    if dataflow:
        jplan, plan = jax_dataflow_variant(jplan), int8_dataflow_variant(plan)
    jfloat = JaxPlan.full_float(jcfg.num_layers, "float32")
    tfloat = PrecisionPlan.full_float(cfg.num_layers, "float32")
    jfloat_plan = JT.build_plan(jcfg, jfloat)
    float_plan = T.build_plan(cfg, tfloat)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, jfloat,
                             head=("cls", N_CLASSES))
    params = params_from_numpy(jax_to_numpy(jparams), float_plan, "cpu")
    batches = synthetic_calibration_batches(cfg, num_batches=2, seq_len=16)
    jstats = jptq.capture_stats(jparams, to_jax_batches(batches), jcfg,
                                jfloat_plan, precision=jplan)
    jq, jqplan = jptq.apply_plan(jparams, jcfg, jplan, jstats,
                                 float_plan=jfloat_plan)
    qplan = T.build_plan(cfg, plan)
    return {"jcfg": jcfg, "cfg": cfg, "jplan": jplan, "plan": plan,
            "jfloat_plan": jfloat_plan, "float_plan": float_plan,
            "jparams": jparams, "params": params, "batches": batches,
            "jstats": jstats, "jq": jq, "jqplan": jqplan, "qplan": qplan,
            "qparams_from_jax": params_from_numpy(jax_to_numpy(jq), qplan,
                                                  "cpu")}


def golden_plans(num_layers: int, moe: bool = False):
    """The golden plan's four layers tiled to ``num_layers``, as
    ``chip_smoke.py`` tiles them, in both packages; an MoE arch takes its
    schema-v4 experts-family variant. Returns (port plan, JAX plan)."""
    plan, jplan = PrecisionPlan.load(GOLDEN), JaxPlan.load(GOLDEN)
    reps = -(-num_layers // plan.num_layers)
    plan = PrecisionPlan((plan.layers * reps)[:num_layers], plan.float_dtype)
    jplan = JaxPlan((jplan.layers * reps)[:num_layers], jplan.float_dtype)
    if moe:
        plan, jplan = moe_family_variant(plan), jax_moe_variant(jplan)
    return plan, jplan


@functools.lru_cache(maxsize=None)
def arch_slice(arch: str) -> dict:
    """A reduced arch in both packages: JAX float params (seeded) carried
    into the port, numpy calibration batches (2 of 2 x 8; a vision arch's
    carry its prefix embeddings, an audio arch's are frames), and the tiled
    golden plan (:func:`golden_plans`) calibrated by JAX on those batches,
    quantized by JAX and carried across. Built once a process; tests must
    not mutate it."""
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jfp = JaxPlan.full_float(jcfg.num_layers, "float32")
    fp = PrecisionPlan.full_float(cfg.num_layers, "float32")
    jfloat_plan, float_plan = JT.build_plan(jcfg, jfp), T.build_plan(cfg, fp)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, jfp)
    params = params_from_numpy(jax_to_numpy(jparams), float_plan, "cpu")
    batches = synthetic_calibration_batches(cfg, num_batches=2, batch_size=2,
                                            seq_len=8, seed=0)
    plan, jplan = golden_plans(cfg.num_layers, cfg.moe is not None)
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
