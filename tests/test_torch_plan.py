"""Port parity: configs, the precision lattice and the PrecisionPlan schema
(repro_torch.configs / core.precision / core.plan against repro's)."""
import dataclasses
import json

import pytest

from repro.configs import get_config as jax_get_config
from repro.core import plan as jplan_mod
from repro.core.precision import EncoderPolicy as JaxPolicy
from repro.core.precision import LayerMode as JaxMode
from repro.models import transformer as JT

from repro_torch.configs import get_config
from repro_torch.core import plan as plan_mod
from repro_torch.core.precision import EncoderPolicy, LayerMode
from repro_torch.models import transformer as T

from test_torch_support import GOLDEN, GOLDEN_V4

PLAN_FILES = [GOLDEN, GOLDEN_V4]


def _group_tuple(g):
    return (g.start, g.stop, g.mode.value, tuple(str(k) for k in g.kinds),
            g.steps, g.quant_bmm, g.softmax)


@pytest.mark.parametrize("path", PLAN_FILES)
def test_fingerprint_byte_identical(path):
    ours = plan_mod.PrecisionPlan.load(path)
    ref = jplan_mod.PrecisionPlan.load(path)
    assert ours.fingerprint() == ref.fingerprint()
    assert ours.to_json() == ref.to_json()


@pytest.mark.parametrize("path", PLAN_FILES)
def test_json_round_trip_keeps_fingerprint(path):
    ours = plan_mod.PrecisionPlan.load(path)
    again = plan_mod.PrecisionPlan.from_json(ours.to_json())
    assert again == ours and again.fingerprint() == ours.fingerprint()


@pytest.mark.parametrize("path", PLAN_FILES)
def test_plan_queries_match(path):
    ours = plan_mod.PrecisionPlan.load(path)
    ref = jplan_mod.PrecisionPlan.load(path)
    assert [(s, e, m.value) for s, e, m in ours.group_boundaries()] == \
        [(s, e, m.value) for s, e, m in ref.group_boundaries()]
    for i in range(ours.num_layers):
        assert ours.bmm_quantized(i) == ref.bmm_quantized(i)
        assert ours.softmax_scheme(i) == ref.softmax_scheme(i)
        assert ours.layers[i].mode.value == ref.layers[i].mode.value
        for block in plan_mod.BLOCKS + plan_mod.BLOCK_FAMILIES:
            assert ours.layers[i].spec(block).to_dict() == \
                ref.layers[i].spec(block).to_dict()


def test_full_float_and_uniform_match():
    for n, dt in ((4, "float32"), (12, "bfloat16")):
        assert plan_mod.PrecisionPlan.full_float(n, dt).fingerprint() == \
            jplan_mod.PrecisionPlan.full_float(n, dt).fingerprint()
    lp = plan_mod.LayerPlan(ffn_in=plan_mod.INT8_SPEC)
    jlp = jplan_mod.LayerPlan(ffn_in=jplan_mod.INT8_SPEC)
    assert plan_mod.PrecisionPlan.uniform(3, lp, "float32").fingerprint() \
        == jplan_mod.PrecisionPlan.uniform(3, jlp, "float32").fingerprint()


BAD_PLANS = [
    {"schema_version": 1, "layers": [{"kv_cache": "int8_per_head"}]},
    {"schema_version": 2, "layers": [{"softmax": "uint8"}]},
    {"schema_version": 3, "layers": [{"experts": {"weight": "float",
                                                  "act": "float"}}]},
    {"schema_version": 5, "layers": [{}]},
    {"schema_version": 1, "layers": []},
    {"schema_version": 1, "float_dtypes": "float32", "layers": [{}]},
    {"schema_version": 1, "layers": [{"qkv": {"weight": "int8_per_channel",
                                              "act": "float"}}]},
    {"schema_version": 1, "layers": [{"qkv": {"weight": "int8_per_channel",
                                              "act": "int8_per_tensor",
                                              "calibrator": "magic"}}]},
    {"schema_version": 1, "layers": [{"attention": {}}]},
    {"schema_version": 3, "layers": [{"norm": "int8"}]},
    {"schema_version": 4, "layers": [{"router": {
        "weight": "int8_per_channel", "act": "int8_per_tensor"}}]},
]


@pytest.mark.parametrize("bad", BAD_PLANS, ids=range(len(BAD_PLANS)))
def test_schema_rejections_match(bad):
    """Both packages refuse the same malformed plans."""
    with pytest.raises(ValueError):
        jplan_mod.PrecisionPlan.from_dict(bad)
    with pytest.raises(ValueError):
        plan_mod.PrecisionPlan.from_dict(bad)


@pytest.mark.parametrize("reduced", [False, True])
def test_bert_config_matches(reduced):
    ours, ref = get_config("bert-base"), jax_get_config("bert-base")
    if reduced:
        ours, ref = ours.reduced(), ref.reduced()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert [str(k) for k in ours.layer_kinds()] == \
        [str(k) for k in ref.layer_kinds()]
    assert (ours.q_dim, ours.kv_dim) == (ref.q_dim, ref.kv_dim)


def test_unknown_config_raises():
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("tile", [1, 3])
def test_build_plan_groups_match(tile):
    """The execution plan (which the carried-across parameter trees are
    packed under) groups layers exactly as the JAX package does."""
    golden = plan_mod.PrecisionPlan.load(GOLDEN)
    jgolden = jplan_mod.PrecisionPlan.load(GOLDEN)
    plan = plan_mod.PrecisionPlan(golden.layers * tile, golden.float_dtype)
    jplan = jplan_mod.PrecisionPlan(jgolden.layers * tile,
                                    jgolden.float_dtype)
    cfg = get_config("bert-base")
    jcfg = jax_get_config("bert-base")
    if tile == 1:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert [_group_tuple(g) for g in T.build_plan(cfg, plan)] == \
        [_group_tuple(g) for g in JT.build_plan(jcfg, jplan)]


def test_build_plan_from_policy_matches():
    cfg, jcfg = get_config("bert-base"), jax_get_config("bert-base")
    modes = [LayerMode.FULLY_QUANT] * 3 + [LayerMode.FLOAT] * 9
    jmodes = [JaxMode.FULLY_QUANT] * 3 + [JaxMode.FLOAT] * 9
    ours = T.build_plan(cfg, EncoderPolicy(tuple(modes), "float32"))
    ref = JT.build_plan(jcfg, JaxPolicy(tuple(jmodes), "float32"))
    assert [_group_tuple(g) for g in ours] == [_group_tuple(g) for g in ref]
    with pytest.raises(ValueError):
        T.build_plan(cfg, EncoderPolicy.full_float(4))


def test_layer_mode_lattice():
    assert [(m.value, m.quant_ffn, m.quant_mha) for m in LayerMode] == \
        [(m.value, m.quant_ffn, m.quant_mha) for m in JaxMode]
    pol = EncoderPolicy((LayerMode.FLOAT, LayerMode.FLOAT,
                         LayerMode.QUANT_FFN_ONLY), "float32")
    assert pol.group_boundaries() == [(0, 2, LayerMode.FLOAT),
                                      (2, 3, LayerMode.QUANT_FFN_ONLY)]
    assert (pol.num_quant_ffn, pol.num_quant_mha) == (1, 0)


def test_describe_names_fingerprint():
    plan = plan_mod.PrecisionPlan.load(GOLDEN)
    assert plan.fingerprint()[:12] in plan.describe()
    assert json.loads(plan.to_json())["schema_version"] == 1


def _span(plan_mod_, path):
    """The golden plan, and its whole-layer int8 span variant."""
    from repro.core.samp import int8_dataflow_variant as jflow
    from repro_torch.core.samp import int8_dataflow_variant as flow
    plan = plan_mod_.PrecisionPlan.load(path)
    return plan, (flow if plan_mod_ is plan_mod else jflow)(plan) or plan


@pytest.mark.parametrize("path", PLAN_FILES)
@pytest.mark.parametrize("span", [False, True])
def test_plan_counts_and_describe_match(path, span):
    ours = _span(plan_mod, path)[span]
    ref = _span(jplan_mod, path)[span]
    assert [m.value for m in ours.modes] == [m.value for m in ref.modes]
    for attr in ("num_quant_ffn", "num_quant_mha", "num_quant_kv",
                 "softmax_schemes", "norm_schemes", "num_int8_dataflow",
                 "num_expert_layers"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    assert ours.describe() == ref.describe()
    assert [m.value for m in ours.to_policy().modes] == \
        [m.value for m in ref.to_policy().modes]


@pytest.mark.parametrize("mode", ["fully_quant", "quant_ffn_only"])
@pytest.mark.parametrize("dynamic", [False, True])
def test_prefix_subset_and_policy_shims_match(mode, dynamic):
    kw = dict(dynamic_acts=dynamic, calibrator="percentile")
    for k in (0, 2, 5):
        assert plan_mod.PrecisionPlan.prefix(
            5, k, LayerMode(mode), "float32", **kw).fingerprint() == \
            jplan_mod.PrecisionPlan.prefix(
                5, k, JaxMode(mode), "float32", **kw).fingerprint()
    assert plan_mod.PrecisionPlan.subset(
        5, [4, 1], LayerMode(mode), **kw).fingerprint() == \
        jplan_mod.PrecisionPlan.subset(5, [4, 1], JaxMode(mode),
                                       **kw).fingerprint()
    with pytest.raises(ValueError):
        plan_mod.PrecisionPlan.prefix(5, 6, LayerMode(mode))
    with pytest.raises(ValueError):
        plan_mod.PrecisionPlan.subset(5, [5], LayerMode(mode))
    pol = EncoderPolicy.prefix(4, 3, LayerMode(mode), "float32")
    jpol = JaxPolicy.prefix(4, 3, JaxMode(mode), "float32")
    with pytest.warns(DeprecationWarning):
        ours = plan_mod.PrecisionPlan.from_policy(pol, dynamic_acts=dynamic)
    with pytest.warns(DeprecationWarning):
        ref = jplan_mod.PrecisionPlan.from_policy(jpol,
                                                  dynamic_acts=dynamic)
    assert ours.fingerprint() == ref.fingerprint()


def test_with_families_matches():
    spec = plan_mod.QuantSpec("int8_per_channel", "int8_per_token")
    jspec = jplan_mod.QuantSpec("int8_per_channel", "int8_per_token")
    lp = plan_mod.LayerPlan(ffn_in=plan_mod.INT8_SPEC)
    jlp = jplan_mod.LayerPlan(ffn_in=jplan_mod.INT8_SPEC)
    ours = lp.with_families(experts=spec, router=plan_mod.FLOAT_SPEC)
    ref = jlp.with_families(experts=jspec, router=jplan_mod.FLOAT_SPEC)
    assert ours.to_dict() == ref.to_dict()
    assert lp.with_families() is lp
    assert plan_mod.PrecisionPlan.uniform(2, ours).fingerprint() == \
        jplan_mod.PrecisionPlan.uniform(2, ref).fingerprint()
