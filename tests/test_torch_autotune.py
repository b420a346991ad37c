"""Port parity of the SAMP search: the allocator (Algorithm 1 and the
Appendix-A policies), the roofline's op inventory, the three search
strategies, the MoE grid and the ``SAMP`` facade (repro_torch.core.allocator
/ core.samp / toolkit.latency / toolkit.samp against repro's).

The strategies get the same eval and latency functions in both packages,
keyed by plan fingerprint, so they must visit the same candidates in the
same order and recommend the same plan."""
import dataclasses
import hashlib

import jax
import numpy as np
import pytest
import torch

from _hypothesis_shim import hypothesis, st

from repro.configs import get_config as jax_get_config
from repro.core import allocator as JA
from repro.core import samp as JS
from repro.core.precision import LayerMode as JMode
from repro.models import transformer as JT
from repro.toolkit import latency as JL
from repro.toolkit.samp import SAMP as JaxSAMP

from repro_torch.configs import get_config
from repro_torch.core import allocator as A
from repro_torch.core import samp as S
from repro_torch.core.calibration import synthetic_calibration_batches
from repro_torch.core.precision import LayerMode
from repro_torch.interop import params_from_numpy
from repro_torch.toolkit import latency as L
from repro_torch.toolkit.samp import SAMP

from test_torch_support import jax_to_numpy, to_jax_batches

settings = hypothesis.settings(max_examples=40, deadline=None)
MODES = (LayerMode.FULLY_QUANT, LayerMode.QUANT_FFN_ONLY)
JMODES = (JMode.FULLY_QUANT, JMode.QUANT_FFN_ONLY)


def _rec(r):
    return dataclasses.astuple(r)


# ---------------------------------------------------------------------------
# allocator: the cases of tests/test_allocator.py through both packages
# ---------------------------------------------------------------------------

ACC = [0.90, 0.89, 0.885, 0.70, 0.50]
LAT = [1.00, 0.95, 0.85, 0.80, 0.75]
ACC4, LAT4 = [0.9, 0.88, 0.8, 0.7], [1.0, 0.9, 0.6, 0.5]
ALLOCATOR_CASES = [
    ("accuracy_decay_aware", (ACC, LAT), {}),
    ("accuracy_decay_aware", ([0.80, 0.85], [1.00, 0.90]), {}),
    ("accuracy_decay_aware", ([0.8, 0.7, 0.9], [1.0, 1.0, 1.0]), {}),
    ("under_latency_ceiling", (ACC4, LAT4), {"max_latency": 0.65}),
    ("under_latency_ceiling", (ACC4, LAT4), {"max_latency": 0.1}),
    ("above_accuracy_floor", (ACC4, LAT4), {"min_accuracy": 0.85}),
    ("above_accuracy_floor", (ACC4, LAT4), {"min_accuracy": 0.99}),
    ("top_k_by_efficiency",
     ([0.9] + [0.9 - 0.01 * i for i in range(1, 8)],
      [1.0] + [1.0 - 0.05 * i for i in range(1, 8)]), {"k": 5}),
    ("recommend", ([0.9, 0.8], [1.0, 0.5]), {}),
    ("recommend", ([0.9, 0.8], [1.0, 0.5]), {"max_latency": 0.6}),
    ("recommend", ([0.9, 0.8], [1.0, 0.5]), {"min_accuracy": 0.85}),
    ("recommend", (ACC, LAT), {"max_latency": 0.9, "min_accuracy": 0.89}),
    ("greedy_subset_schedule", ([0.88, 0.70, 0.86], 0.9, [0.1, 0.1, 0.1],
                                1.0), {}),
]


@pytest.mark.parametrize("name,args,kw", ALLOCATOR_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(ALLOCATOR_CASES)])
def test_allocator_matches_jax(name, args, kw):
    ours, theirs = getattr(A, name)(*args, **kw), getattr(JA, name)(*args,
                                                                     **kw)
    if isinstance(ours, list):
        assert [_rec(r) for r in ours] == [_rec(r) for r in theirs]
    else:
        assert _rec(ours) == _rec(theirs)


@pytest.mark.parametrize("args", [([], []), ([0.5], [1.0, 2.0]),
                                  ([0.5], [0.0])])
def test_allocator_validation_matches_jax(args):
    with pytest.raises(ValueError):
        JA.accuracy_decay_aware(*args)
    with pytest.raises(ValueError):
        A.accuracy_decay_aware(*args)


@settings
@hypothesis.given(
    st.lists(st.tuples(st.floats(0, 1), st.floats(0.01, 10)),
             min_size=1, max_size=20),
    st.one_of(st.none(), st.floats(0.02, 9)),
    st.one_of(st.none(), st.floats(0, 1)))
def test_recommend_property_matches_jax(pairs, ceiling, floor):
    acc = [p[0] for p in pairs]
    lat = [p[1] for p in pairs]
    kw = {"max_latency": ceiling, "min_accuracy": floor}
    assert _rec(A.recommend(acc, lat, **kw)) == \
        _rec(JA.recommend(acc, lat, **kw))
    assert [_rec(r) for r in A.top_k_by_efficiency(acc, lat)] == \
        [_rec(r) for r in JA.top_k_by_efficiency(acc, lat)]


# ---------------------------------------------------------------------------
# roofline: the same op inventory, H100 constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["bert-base", "qwen2-0.5b", "mixtral-8x22b"])
@pytest.mark.parametrize("mode", ["float", "fully_quant", "quant_ffn_only"])
def test_layer_ops_match_jax(arch, mode):
    ours = L.layer_ops(get_config(arch), LayerMode(mode), 8, 128, "float32")
    theirs = JL.layer_ops(jax_get_config(arch), JMode(mode), 8, 128,
                          "float32")
    assert [(o.name, o.flops, o.bytes, o.precision) for o in ours] == \
        [(o.name, o.flops, o.bytes, o.precision) for o in theirs]


def test_roofline_prices_the_h100():
    assert L.PEAK == {"float32": 67e12, "bfloat16": 989.4e12,
                      "float16": 989.4e12, "int8": 1978.9e12}
    assert L.HBM_BW == 3.35e12
    cfg = get_config("bert-base")
    plan = S.PrecisionPlan.full_float(cfg.num_layers, "float32")
    fn = L.RooflineBackend().bind(cfg, batch=32, seq=128)
    assert fn.analytic is True
    assert fn(None, None, plan) == L.encoder_latency(cfg, plan, batch=32,
                                                     seq=128)
    quant = S.PrecisionPlan.prefix(cfg.num_layers, cfg.num_layers,
                                   LayerMode.FULLY_QUANT, "float32")
    assert fn(None, None, quant) < fn(None, None, plan)


def test_wallclock_times_on_cpu_and_refuses_a_missing_card():
    cfg = get_config("bert-base").reduced()
    backend = L.WallclockBackend(reps=3, warmup=1)
    fn = backend.bind(cfg, batch=2, seq=8, device="cpu")
    assert fn.analytic is False
    samp = SAMP.from_config(cfg, seq_len=8, float_dtype="float32",
                            device="cpu")
    samp.pipeline.init_params(torch.Generator("cpu").manual_seed(0))
    pipe = samp.pipeline
    t = fn(pipe.params, pipe.plan, pipe.policy)
    samples = backend.samples[pipe.policy.fingerprint()]
    assert t > 0 and len(samples) == 3 and samples == sorted(samples)
    assert t == samples[1]
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        backend.bind(cfg, batch=2, seq=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SAMP.from_config(cfg, seq_len=8)


# ---------------------------------------------------------------------------
# search strategies: same candidates, same order, same recommendation
# ---------------------------------------------------------------------------


def _unit(fp: str, salt: str) -> float:
    return int(hashlib.sha256((salt + fp).encode()).hexdigest()[:8],
               16) / 16**8


def _fns(log, analytic=True):
    """Eval and latency functions of the plan alone (its fingerprint and
    quantized-layer counts), logging each call."""
    def eval_fn(qp, plan, pol):
        fp = pol.fingerprint()
        log.append(("eval", fp))
        return round(0.6 + 0.3 * _unit(fp, "acc"), 6)

    def latency_fn(qp, plan, pol):
        fp = pol.fingerprint()
        log.append(("latency", fp, qp is None))
        return round(1.0 - 0.05 * pol.num_quant_ffn
                     - 0.03 * pol.num_quant_mha
                     - 0.01 * pol.num_int8_dataflow
                     + 0.02 * _unit(fp, "lat"), 6)
    if analytic:
        latency_fn.analytic = True
    return eval_fn, latency_fn


@pytest.fixture(scope="module")
def engines():
    """Reduced bert-base cut to 3 layers in both packages: JAX float params
    carried into the port, and the JAX calibration stats (the search's
    functions ignore the quantized params, so both use one stats dict)."""
    jcfg = jax_get_config("bert-base").reduced().replace(num_layers=3)
    cfg = get_config("bert-base").reduced().replace(num_layers=3)
    jeng = JS.SAMPEngine(jcfg, float_dtype="float32")
    eng = S.SAMPEngine(cfg, float_dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg,
                             jeng.float_precision, head=("cls", 15))
    params = params_from_numpy(jax_to_numpy(jparams), eng.float_plan, "cpu")
    batches = synthetic_calibration_batches(cfg, num_batches=1, seq_len=16)
    stats = jeng.calibrate(jparams, to_jax_batches(batches))
    return {"jeng": jeng, "eng": eng, "jparams": jparams, "params": params,
            "stats": stats}


def _points(points):
    return [(p.mode_name, p.k, p.plan.fingerprint(), p.accuracy, p.latency)
            for p in points]


def _recs(results):
    return [(r.mode_name, r.plan.fingerprint(), _rec(r.recommendation))
            for r in results]


STRATEGIES = [
    ("prefix_grid", {}),
    ("prefix_grid", {"dataflow": True}),
    ("prefix_grid", {"stride": 2, "modes": "ffn"}),
    ("greedy", {}),
    ("greedy", {"mode": "fully_quant", "max_layers": 2}),
    ("latency_budget", {"max_latency": 0.93}),
    ("latency_budget", {"max_latency": 0.93, "dataflow": True}),
]


@pytest.mark.parametrize("strategy,kw", STRATEGIES,
                         ids=[f"{s}-{i}" for i, (s, _) in
                              enumerate(STRATEGIES)])
def test_strategy_matches_jax(engines, strategy, kw):
    def resolve(kw, mode_cls):
        kw = dict(kw)
        if kw.get("modes") == "ffn":
            kw["modes"] = (mode_cls.QUANT_FFN_ONLY,)
        if "mode" in kw:
            kw["mode"] = mode_cls(kw["mode"])
        return kw

    jlog, log = [], []
    jpts = engines["jeng"].search(strategy, engines["jparams"],
                                  engines["stats"], *_fns(jlog),
                                  **resolve(kw, JMode))
    pts = engines["eng"].search(strategy, engines["params"],
                                engines["stats"], *_fns(log),
                                **resolve(kw, LayerMode))
    assert _points(pts) == _points(jpts)
    assert log == jlog
    assert pts[0].mode_name == "float" and len(pts) > 1
    base = pts[0].latency
    for th in ({}, {"max_latency": base - 0.05}, {"min_accuracy": 0.75},
               {"max_latency": base - 0.05, "min_accuracy": 0.75}):
        assert _recs(S.SAMPEngine.recommend(pts, **th)) == \
            _recs(JS.SAMPEngine.recommend(jpts, **th))
    assert [p.plan.fingerprint() for p in engines["eng"].top5(pts)] == \
        [p.plan.fingerprint() for p in engines["jeng"].top5(jpts)]


@pytest.mark.parametrize("dataflow", [False, True])
def test_latency_budget_with_a_measured_backend(engines, dataflow):
    """An unmarked latency callable is measured: it is only called on
    quantized params, and the budget keeps the same candidates."""
    jlog, log = [], []
    kw = dict(max_latency=0.93, dataflow=dataflow)
    jpts = engines["jeng"].search("latency_budget", engines["jparams"],
                                  engines["stats"], *_fns(jlog), **kw)
    pts = engines["eng"].search("latency_budget", engines["params"],
                                engines["stats"],
                                *_fns(log, analytic=False), **kw)
    assert _points(pts) == _points(jpts)
    assert not any(e[0] == "latency" and e[2] for e in log)
    assert [e for e in log if e[0] == "eval"] == \
        [e for e in jlog if e[0] == "eval"]


def test_latency_budget_lets_errors_raise(engines):
    eval_fn, _ = _fns([])

    def broken(qp, plan, pol):
        raise RuntimeError("CUDA error: an illegal memory access")
    broken.analytic = True
    with pytest.raises(RuntimeError, match="illegal memory access"):
        engines["eng"].search("latency_budget", engines["params"],
                              engines["stats"], eval_fn, broken,
                              max_latency=1.0)


def _grid(mod, eng, stride, modes, **kw):
    return [(n, k, p.fingerprint())
            for n, k, p in mod._grid_candidates(eng, stride, modes,
                                                "minmax", **kw)]


def test_moe_family_grid_matches_jax():
    cfg = get_config("mixtral-8x22b").reduced()
    jcfg = jax_get_config("mixtral-8x22b").reduced()
    eng, jeng = S.SAMPEngine(cfg), JS.SAMPEngine(jcfg)
    for dataflow in (False, True):
        ours = _grid(S, eng, 1, MODES, dataflow=dataflow, moe_families=True)
        assert ours == _grid(JS, jeng, 1, JMODES, dataflow=dataflow,
                             moe_families=True)
        assert any(n.endswith("+experts") for n, _, _ in ours)
    plan = S.PrecisionPlan.prefix(cfg.num_layers, 1,
                                  LayerMode.QUANT_FFN_ONLY)
    flow = S.moe_family_variant(plan, dynamic_acts=True)
    assert flow.fingerprint() == JS.moe_family_variant(
        JS.PrecisionPlan.prefix(jcfg.num_layers, 1, JMode.QUANT_FFN_ONLY),
        dynamic_acts=True).fingerprint()
    assert S.moe_family_variant(flow) is None


def test_full_width_card_grid_matches_jax():
    """The grid ``chip_smoke.py``'s autotune phase searches: full-width
    bert-base, stride 4, with the int8-dataflow variants."""
    eng = S.SAMPEngine(get_config("bert-base"), float_dtype="float32")
    jeng = JS.SAMPEngine(jax_get_config("bert-base"), float_dtype="float32")
    ours = _grid(S, eng, 4, MODES, dataflow=True)
    assert ours == _grid(JS, jeng, 4, JMODES, dataflow=True)
    assert [(n, k) for n, k, _ in ours] == [
        ("float", 0), ("fully_quant", 4), ("fully_quant+int8flow", 4),
        ("fully_quant", 8), ("fully_quant+int8flow", 8),
        ("fully_quant", 12), ("fully_quant+int8flow", 12),
        ("quant_ffn_only", 4), ("quant_ffn_only", 8),
        ("quant_ffn_only", 12)]


# ---------------------------------------------------------------------------
# the facade: JAX's params carried across, real calibration and eval
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def facades():
    jcfg = jax_get_config("bert-base").reduced().replace(num_layers=2)
    cfg = get_config("bert-base").reduced().replace(num_layers=2)
    jsamp = JaxSAMP.from_config(jcfg, task="tnews", seq_len=16,
                                float_dtype="float32")
    jsamp.pipeline.init_params(jax.random.PRNGKey(3))
    samp = SAMP.from_config(cfg, task="tnews", seq_len=16,
                            float_dtype="float32", device="cpu")
    samp.pipeline.params = params_from_numpy(
        jax_to_numpy(jsamp.pipeline.params), samp.pipeline.plan, "cpu")
    return jsamp, samp


def test_facade_calibration_matches_jax(facades):
    jsamp, samp = facades
    jstats = jsamp.calibrate(num_batches=2, batch_size=4)
    stats = samp.calibrate(num_batches=2, batch_size=4)
    assert set(stats) == set(jstats)
    for layer, sites in stats.items():
        assert set(sites) == set(jstats[layer])
        for site, amax in sites.items():
            np.testing.assert_allclose(amax, jstats[layer][site], rtol=1e-5,
                                       err_msg=f"{layer}/{site}")


def test_facade_sweep_accuracy_matches_jax(facades, tmp_path):
    """Each candidate's real ``Pipeline.eval`` accuracy within one example
    of JAX's; then the port's workflow goes on to apply, save, load and
    serve the chosen plan."""
    jsamp, samp = facades
    jsamp.calibrate(num_batches=2, batch_size=4)
    samp.calibrate(num_batches=2, batch_size=4)
    n = 16
    kw = dict(stride=1, eval_batches=1, eval_batch_size=n)
    jpts, pts = jsamp.sweep(**kw), samp.sweep(**kw)
    assert [(p.mode_name, p.k, p.plan.fingerprint()) for p in pts] == \
        [(p.mode_name, p.k, p.plan.fingerprint()) for p in jpts]
    for p, jp in zip(pts, jpts):
        assert abs(p.accuracy - jp.accuracy) <= 1 / n, (p.mode_name, p.k)
    report = samp.autotune(eval_batches=1, eval_batch_size=n,
                           save_to=str(tmp_path / "bundle"))
    assert report.points is pts and report.chosen.mode_name == \
        "quant_ffn_only"
    loaded = SAMP.load(str(tmp_path / "bundle"), device="cpu")
    assert loaded.current.precision.fingerprint() == \
        report.plan.fingerprint()
    from repro_torch.data.pipeline import get_batch
    b = get_batch(samp.task, 0, 8, "dev")
    np.testing.assert_array_equal(loaded.current.predict_logits(b),
                                  samp.current.predict_logits(b))
    with pytest.raises(ValueError, match="deploy-only"):
        loaded.calibrate()


def test_facade_refuses_what_is_not_ported(facades, tmp_path):
    _, samp = facades
    # finetune is ported (tests/test_torch_finetune.py); serve_http is
    # ported: an unstarted front-end over the encoder engine
    from repro_torch.serve.frontend import HTTPFrontend
    fe = samp.serve_http(port=0, log=lambda *a, **k: None)
    assert isinstance(fe, HTTPFrontend) and fe.decode is None
    assert fe.encoder is not None and fe.driver._thread is None
    # plan sets deploy now, as in the JAX package: after a calibration
    # with clusters= only
    from repro_torch.core.plan import PlanSet
    plan = samp.pipeline.precision
    path = PlanSet.single(plan).save(str(tmp_path / "planset.json"))
    for call in (lambda: samp.apply_planset(PlanSet.single(plan)),
                 lambda: samp.apply_plan_file(path)):
        with pytest.raises(ValueError, match="cluster-conditional"):
            call()
