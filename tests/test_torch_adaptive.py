"""Port parity of input-adaptive precision (repro_torch.adaptive, the
cluster-conditional capture, routed serving and v3 bundles, against
repro.adaptive): the cases of tests/test_adaptive.py but its HTTP one, run
on the port, and parity tests feeding both packages the same numpy inputs:
cluster assignments and k-means centroids, clustered stats, the member
trees ``build_router`` quantizes, routed encoder logits, and v3 bundles
written by either package and loaded by the other."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import adaptive as jad
from repro.configs import get_config as jax_get_config
from repro.core.plan import PlanSet as JaxPlanSet
from repro.core.plan import plan_from_policy as jax_plan_from_policy
from repro.core.precision import make_policy as jax_make_policy
from repro.core.samp import SAMPEngine as JaxEngine
from repro.core.samp import int8_dataflow_variant as jax_dataflow_variant
from repro.data.pipeline import TaskSpec as JaxTaskSpec
from repro.models import transformer as JT
from repro.serve import EncoderRequest as JaxEncoderRequest
from repro.serve import EncoderServeEngine as JaxEncoderServeEngine
from repro.toolkit import artifact as JA

from repro_torch import adaptive as ad
from repro_torch.adaptive import (EmbeddingKMeans, LengthBuckets, PlanSet,
                                  TaskLabel, batch_clusters, build_router,
                                  cluster_model_from_dict,
                                  clustered_synthetic_batches,
                                  fit_cluster_model, load_plan_or_planset,
                                  pooled_embeddings)
from repro_torch.configs import get_config
from repro_torch.core.plan import PrecisionPlan, plan_from_policy
from repro_torch.core.precision import make_policy
from repro_torch.core.samp import SAMPEngine, int8_dataflow_variant
from repro_torch.data.pipeline import TaskSpec
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import transformer as T
from repro_torch.serve import (EncoderRequest, EncoderServeEngine,
                               MicroBatcher, Request, ServeEngine,
                               SlotScheduler)
from repro_torch.serve import metrics as M
from repro_torch.toolkit import SAMP, load_artifact
from repro_torch.toolkit import artifact as A
from repro_torch.toolkit.plan_lint import main as plan_lint_main

from test_torch_support import (N_CLASSES, jax_to_numpy, rel_linf,
                                to_jax_batches)

BUDGET = 5e-3            # the port's encoder budget against JAX
EDGES = (8, 12)          # three length clusters at seq_len 16


def tiny_cfg(num_layers=2):
    return get_config("bert-base").reduced().replace(num_layers=num_layers)


def _ffn_plan(cfg):
    return plan_from_policy(make_policy(cfg, "ffn"))


def _mha_plan(cfg):
    return plan_from_policy(make_policy(cfg, "full"))


def _req_tokens(cfg, n, seed=0):
    rng = np.random.default_rng(seed + n)
    return rng.integers(1, cfg.vocab_size, size=n).tolist()


def _assert_trees_match(ours: dict, theirs: dict, where: str = ""):
    """A port tree (as numpy, JAX layout) against a JAX one: int8 codes
    exact, scales and float leaves within 1e-6 (the JAX package's jitted
    scale arithmetic may round an ulp apart)."""
    if isinstance(theirs, dict):
        assert set(k for k, v in ours.items() if v is not None) == \
            set(k for k, v in theirs.items() if v is not None), where
        for k, v in theirs.items():
            if v is not None:
                _assert_trees_match(ours[k], v, f"{where}/{k}")
    elif isinstance(theirs, (list, tuple)):
        assert len(ours) == len(theirs), where
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _assert_trees_match(a, b, f"{where}/{i}")
    else:
        a, b = np.asarray(ours), np.asarray(theirs)
        assert a.shape == b.shape and a.dtype == b.dtype, where
        if a.dtype == np.int8:
            np.testing.assert_array_equal(a, b, err_msg=where)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                       err_msg=where)


# ---------------------------------------------------------------------------
# the shared deployment: a reduced 2-layer BERT in both packages, calibrated
# per length cluster on the same numpy batches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def m():
    jcfg = jax_get_config("bert-base").reduced().replace(num_layers=2)
    cfg = tiny_cfg()
    jeng = JaxEngine(jcfg, float_dtype="float32")
    eng = SAMPEngine(cfg, float_dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, jeng.float_policy,
                             head=("cls", N_CLASSES))
    params = params_from_numpy(jax_to_numpy(jparams), eng.float_plan, "cpu")
    model = LengthBuckets(EDGES)
    batches, classes = clustered_synthetic_batches(cfg, model, max_len=16,
                                                   batch_size=3)
    ids = batch_clusters(model, batches, batch_classes=classes)
    jstats = jeng.calibrate(jparams, to_jax_batches(batches), clusters=ids)
    stats = eng.calibrate(params, batches, clusters=ids)
    jffn = jax_plan_from_policy(jax_make_policy(jcfg, "ffn"))
    jfull = jax_plan_from_policy(jax_make_policy(jcfg, "full"))
    jplanset = JaxPlanSet(((0, jffn), (1, jfull),
                           (2, jax_dataflow_variant(jfull))), default=0)
    planset = PlanSet(((0, _ffn_plan(cfg)), (1, _mha_plan(cfg)),
                       (2, int8_dataflow_variant(_mha_plan(cfg)))),
                      default=0)
    return {"jcfg": jcfg, "cfg": cfg, "jeng": jeng, "eng": eng,
            "jparams": jparams, "params": params, "batches": batches,
            "ids": ids, "jstats": jstats, "stats": stats,
            "jplanset": jplanset, "planset": planset}


@pytest.fixture(scope="module")
def routers(m):
    """Both packages' routers over the same member plans and the JAX
    package's clustered stats (so the member trees must agree)."""
    jrouter = jad.build_router(m["jcfg"], m["jparams"], m["jplanset"],
                               m["jstats"],
                               cluster_model=jad.LengthBuckets(EDGES),
                               scheme=m["jeng"].scheme,
                               float_plan=m["jeng"].float_plan)
    router = build_router(m["cfg"], m["params"], m["planset"], m["jstats"],
                          cluster_model=LengthBuckets(EDGES),
                          scheme=m["eng"].scheme,
                          float_plan=m["eng"].float_plan)
    return jrouter, router


# ---------------------------------------------------------------------------
# PlanSet schema (the port's PlanSet, re-exported by repro_torch.adaptive)
# ---------------------------------------------------------------------------


def test_planset_roundtrip_fingerprint_and_lookup():
    cfg = tiny_cfg()
    ps = PlanSet(((0, _ffn_plan(cfg)), (1, _mha_plan(cfg))), default=0)
    again = PlanSet.from_json(ps.to_json())
    assert again.fingerprint() == ps.fingerprint()
    assert again.cluster_ids == (0, 1)
    assert ps.plan_for(99).fingerprint() == ps.plan_for(0).fingerprint()
    assert ps.plan_for(1).fingerprint() == _mha_plan(cfg).fingerprint()
    assert ps.num_layers == cfg.num_layers
    uni = PlanSet.uniform(_ffn_plan(cfg), range(3))
    assert len(uni) == 3 and uni.default == 0
    assert len({p.fingerprint() for _, p in uni.members}) == 1
    # the JAX package reads the same set to the same fingerprint
    assert JaxPlanSet.from_json(ps.to_json()).fingerprint() == \
        ps.fingerprint()


def test_planset_validation_errors():
    cfg = tiny_cfg()
    p = _ffn_plan(cfg)
    with pytest.raises(ValueError, match="at least one"):
        PlanSet((), default=0)
    with pytest.raises(ValueError, match="duplicate"):
        PlanSet(((0, p), (0, p)), default=0)
    with pytest.raises(ValueError, match="default"):
        PlanSet(((0, p), (1, p)), default=7)
    with pytest.raises(ValueError):
        PlanSet(((0, p), (1, plan_from_policy(
            make_policy(tiny_cfg(num_layers=3), "ffn")))), default=0)
    d = PlanSet(((0, p),), default=0).to_dict()
    d["extra"] = 1
    with pytest.raises(ValueError):
        PlanSet.from_dict(d)
    d = PlanSet(((0, p),), default=0).to_dict()
    d["members"][0]["extra"] = 1
    with pytest.raises(ValueError):
        PlanSet.from_dict(d)


def test_load_plan_or_planset_sniffs_kind(tmp_path):
    cfg = tiny_cfg()
    single = tmp_path / "plan.json"
    single.write_text(_ffn_plan(cfg).to_json())
    setf = tmp_path / "planset.json"
    setf.write_text(PlanSet.single(_ffn_plan(cfg)).to_json())
    assert isinstance(load_plan_or_planset(str(single)), PrecisionPlan)
    assert isinstance(load_plan_or_planset(str(setf)), PlanSet)


def test_plan_lint_accepts_planset_and_rejects_bad(tmp_path, capsys):
    cfg = tiny_cfg()
    good = tmp_path / "planset.json"
    good.write_text(PlanSet(((0, _ffn_plan(cfg)), (1, _mha_plan(cfg))),
                            default=0).to_json())
    assert plan_lint_main([str(good), "--layers",
                           str(cfg.num_layers)]) == 0
    assert plan_lint_main([str(good), "--layers", "13"]) == 1
    raw = json.loads(good.read_text())
    raw["members"][0]["plan"]["layers"][0]["nonexistent_block"] = {}
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(raw))
    assert plan_lint_main([str(bad)]) == 1
    single = tmp_path / "plan.json"
    single.write_text(_ffn_plan(cfg).to_json())
    assert plan_lint_main([str(single), "--layers",
                           str(cfg.num_layers)]) == 0
    capsys.readouterr()


# ---------------------------------------------------------------------------
# cluster models
# ---------------------------------------------------------------------------


def test_length_buckets_assignment():
    m = LengthBuckets((8, 16))
    assert m.num_clusters == 3
    assert [m.assign([0] * n) for n in (5, 8, 9, 40)] == [0, 0, 1, 2]
    rows = m.assign_rows({"tokens": np.zeros((3, 12), np.int32),
                          "lengths": np.asarray([4, 12, 30])})
    assert rows.tolist() == [0, 1, 2]
    assert LengthBuckets().num_clusters == 1
    with pytest.raises(ValueError):
        LengthBuckets((16, 8))


def test_task_label_assignment():
    m = TaskLabel(("chat", "search"))
    assert m.num_clusters == 2
    assert m.assign([1, 2], traffic_class="search") == 1
    assert m.assign([1, 2], traffic_class="nope") == 0   # default
    assert m.assign([1, 2]) == 0
    assert m.label_for(1) == "search"
    with pytest.raises(ValueError):
        TaskLabel(("a", "a"))


def _two_blobs(seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0, 0.1, (20, 4)),
                           rng.normal(5, 0.1, (20, 4))]).astype(np.float32)


def test_kmeans_fit_and_assign_determinism():
    """Seeded fits agree; the torch argmin is deterministic and agrees with
    the host-side numpy argmin; serialization round-trips the centroids."""
    x = _two_blobs()
    m1 = EmbeddingKMeans(2, seed=3).fit(x)
    m2 = EmbeddingKMeans(2, seed=3).fit(x)
    np.testing.assert_array_equal(m1.centroids, m2.centroids)
    xs = np.random.default_rng(1).normal(2.5, 3.0, (16, 4)).astype(
        np.float32)
    got = m1.assign_embedded(torch.from_numpy(xs))
    assert got.equal(m1.assign_embedded(torch.from_numpy(xs)))
    m1.bind(lambda toks: xs[toks[0]])
    assert [m1.assign([i]) for i in range(16)] == got.tolist()
    again = cluster_model_from_dict(m1.to_dict())
    assert again.fingerprint() == m1.fingerprint()
    assert again.assign_embedded(torch.from_numpy(xs)).equal(got)


def test_kmeans_centroids_equal_jax_bit_for_bit():
    """The numpy fit is the JAX package's: the same bits on the same
    embeddings, and the same assignments and JSON."""
    for seed, x in ((3, _two_blobs()), (0, np.random.default_rng(7).normal(
            0, 1, (50, 8)).astype(np.float32))):
        ours = EmbeddingKMeans(3, seed=seed).fit(x)
        theirs = jad.EmbeddingKMeans(3, seed=seed).fit(x)
        np.testing.assert_array_equal(ours.centroids, theirs.centroids)
        assert json.dumps(ours.to_dict()) == json.dumps(theirs.to_dict())
        np.testing.assert_array_equal(
            ours.assign_embedded(torch.from_numpy(x)).numpy(),
            np.asarray(theirs.assign_embedded(jnp.asarray(x))))


@pytest.mark.parametrize("make", [
    lambda mod: mod.LengthBuckets((8, 16)),
    lambda mod: mod.TaskLabel(("a", "b"), default=1),
    lambda mod: mod.EmbeddingKMeans(3, seed=7),
    lambda mod: mod.EmbeddingKMeans(2, _two_blobs()[:2], seed=1)],
    ids=["length", "task", "kmeans", "kmeans_fitted"])
def test_cluster_model_serialization_roundtrip(make):
    """Each model round-trips through its dict, and the two packages write
    the same JSON and read each other's to the same fingerprint."""
    m, jm = make(ad), make(jad)
    again = cluster_model_from_dict(m.to_dict())
    assert type(again) is type(m)
    assert again.fingerprint() == m.fingerprint() == jm.fingerprint()
    assert json.dumps(m.to_dict(), sort_keys=True) == \
        json.dumps(jm.to_dict(), sort_keys=True)
    assert cluster_model_from_dict(jm.to_dict()).fingerprint() == \
        jm.fingerprint()
    assert jad.cluster_model_from_dict(m.to_dict()).fingerprint() == \
        m.fingerprint()
    with pytest.raises(ValueError, match="unknown cluster model"):
        cluster_model_from_dict({"kind": "astrology"})


@pytest.mark.parametrize("kind", ["length", "task", "kmeans"])
def test_cluster_assignments_match_jax(m, kind):
    """The same requests land in the same clusters in both packages: the
    length and task models by rule, k-means fitted in each package on its
    own pooled embeddings of the same batches and assigned through each
    package's bound embedder."""
    cfg = m["cfg"]
    reqs = [_req_tokens(cfg, n, seed=s) for n in (3, 8, 9, 12, 13, 16)
            for s in (0, 5)]
    tags = ["a", "b", None, "zz"] * 3
    if kind == "length":
        ours, theirs = LengthBuckets(EDGES), jad.LengthBuckets(EDGES)
    elif kind == "task":
        ours, theirs = TaskLabel(("a", "b")), jad.TaskLabel(("a", "b"))
    else:
        ours, theirs = EmbeddingKMeans(3, seed=0), jad.EmbeddingKMeans(
            3, seed=0)
        fit_cluster_model(ours, m["params"], m["batches"], cfg)
        jad.fit_cluster_model(theirs, m["jparams"],
                              to_jax_batches(m["batches"]), m["jcfg"])
        np.testing.assert_allclose(ours.centroids, theirs.centroids,
                                   rtol=1e-5, atol=1e-6)
    got = [ours.assign(r, traffic_class=t) for r, t in zip(reqs, tags)]
    want = [theirs.assign(r, traffic_class=t) for r, t in zip(reqs, tags)]
    assert got == want
    assert len(set(got)) > 1 or kind == "kmeans"


def test_pooled_embeddings_match_jax(m):
    b = m["batches"][2]
    ours = pooled_embeddings(m["params"], b, m["cfg"])
    theirs = jad.pooled_embeddings(m["jparams"], to_jax_batches([b])[0],
                                   m["jcfg"])
    assert ours.shape == theirs.shape == (3, m["cfg"].d_model)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)


def test_clustered_synthetic_batches_cover_every_cluster():
    """Every cluster covered, with the JAX package's lengths, batch counts,
    classes and refusal (the tokens come from torch generators)."""
    cfg = tiny_cfg()
    jcfg = jax_get_config("bert-base").reduced().replace(num_layers=2)
    for model, jmodel, max_len in (
            (LengthBuckets((8, 16)), jad.LengthBuckets((8, 16)), 64),
            (TaskLabel(("a", "b")), jad.TaskLabel(("a", "b")), 32),
            (EmbeddingKMeans(2), jad.EmbeddingKMeans(2), 16)):
        batches, classes = clustered_synthetic_batches(cfg, model,
                                                       max_len=max_len)
        jbatches, jclasses = jad.clustered_synthetic_batches(
            jcfg, jmodel, max_len=max_len)
        assert classes == jclasses
        assert [{k: v.shape for k, v in b.items()} for b in batches] == \
            [{k: tuple(v.shape) for k, v in b.items()} for b in jbatches]
        for b in batches:
            assert b["tokens"].dtype == np.int32
            assert 0 <= b["tokens"].min() and \
                b["tokens"].max() < cfg.vocab_size
        if isinstance(model, EmbeddingKMeans):
            continue
        seen = set()
        for vec in batch_clusters(model, batches, batch_classes=classes):
            seen.update(int(c) for c in vec)
        assert seen == set(range(model.num_clusters))
    # seeded: the same stream twice
    once, _ = clustered_synthetic_batches(cfg, LengthBuckets((8, 16)))
    again, _ = clustered_synthetic_batches(cfg, LengthBuckets((8, 16)))
    for a, b in zip(once, again):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    for mod, c in ((ad, cfg), (jad, jcfg)):
        with pytest.raises(ValueError, match="cannot cover"):
            mod.clustered_synthetic_batches(c, mod.LengthBuckets((8, 16)),
                                            max_len=16)


# ---------------------------------------------------------------------------
# cluster-conditional calibration
# ---------------------------------------------------------------------------


def test_capture_stats_clusters_partitions_rows_exactly(m):
    """Per-cluster stats equal single-cluster calibration on that cluster's
    rows alone: partitioning is exact."""
    cfg, eng, params = m["cfg"], m["eng"], m["params"]

    def mk(seed, rows, width):
        rng = np.random.default_rng(seed)
        return {"tokens": rng.integers(0, cfg.vocab_size, (rows, width),
                                       dtype=np.int32),
                "segments": np.zeros((rows, width), np.int32)}

    b0, b1 = mk(0, 2, 8), mk(1, 2, 12)
    mixed = {k: np.concatenate([b0[k][:1], b0[k][1:]]) for k in b0}
    clustered = eng.calibrate(params, [mixed, b1],
                              clusters=[np.zeros(2, np.int64),
                                        np.ones(2, np.int64)])
    assert set(clustered) == {0, 1}
    for want, got in ((eng.calibrate(params, [b0]), clustered[0]),
                      (eng.calibrate(params, [b1]), clustered[1])):
        assert set(got) == set(want)
        for layer in want:
            assert got[layer] == want[layer]
    with pytest.raises(ValueError, match="does not match"):
        eng.calibrate(params, [b0], clusters=[np.zeros(3, np.int64)])
    with pytest.raises(ValueError, match="entries for"):
        eng.calibrate(params, [b0, b1], clusters=[np.zeros(2, np.int64)])


def test_clustered_stats_match_jax(m):
    """``capture_stats(clusters=)`` against the JAX package's on the same
    batches: the same clusters, layers and sites, each amax within the
    unclustered parity test's rtol (1e-5)."""
    stats, jstats = m["stats"], m["jstats"]
    assert set(stats) == set(jstats) == {0, 1, 2}
    for c in stats:
        assert set(stats[c]) == set(jstats[c])
        for layer, sites in stats[c].items():
            assert set(sites) == set(jstats[c][layer])
            for site, amax in sites.items():
                np.testing.assert_allclose(
                    amax, jstats[c][layer][site], rtol=1e-5,
                    err_msg=f"cluster {c} {layer}/{site}")
    # clusters saw different rows, so their stats differ
    assert stats[0]["layer0"]["attn_in"] != stats[2]["layer0"]["attn_in"]


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_build_router_members_match_jax(m, routers):
    """Each member tree ``build_router`` quantizes equals the JAX
    package's (codes exact), and the float leaves stay shared across the
    K trees."""
    jrouter, router = routers
    assert router.num_clusters == jrouter.num_clusters == 3
    assert router.active_plans == jrouter.active_plans == 3
    assert router.describe() == jrouter.describe()
    for cid in m["planset"].cluster_ids:
        e, je = router.entry(cid), jrouter.entry(cid)
        assert e.precision.fingerprint() == je.precision.fingerprint()
        assert e.plan == T.build_plan(m["cfg"], e.precision)
        _assert_trees_match(params_to_numpy(e.params, e.plan),
                            jax_to_numpy(je.params), f"cluster {cid}")
    # containers copied, tensors shared: the embedding table is one tensor
    toks = {id(router.entry(c).params["embed"]["tok"])
            for c in router.entries}
    assert toks == {id(m["params"]["embed"]["tok"])}
    assert router.entry(99).cluster == 0          # unknown -> default


def test_routed_encoder_matches_jax_and_solo(m, routers):
    """Routed serving: each response equals an unrouted engine running its
    cluster's entry alone, bit for bit, and JAX's routed engine within the
    encoder budget with the same predictions."""
    jrouter, router = routers
    cfg = m["cfg"]
    cases = {i: _req_tokens(cfg, n, seed=i) for i, n in
             enumerate((5, 7, 10, 12, 14, 16))}
    engine = EncoderServeEngine(cfg, router.entry(0).params,
                                router.entry(0).plan, max_batch=4,
                                max_len=16, router=router, device="cpu")
    jengine = JaxEncoderServeEngine(m["jcfg"], jrouter.entry(0).params,
                                    jrouter.entry(0).plan, max_batch=4,
                                    max_len=16, router=jrouter)
    for uid, toks in cases.items():
        engine.submit(EncoderRequest(uid=uid, tokens=toks))
        jengine.submit(JaxEncoderRequest(uid=uid, tokens=toks))
    done = {r.uid: r for r in engine.run()}
    jdone = {r.uid: r for r in jengine.run()}
    assert {u: r.cluster for u, r in done.items()} == \
        {u: r.cluster for u, r in jdone.items()} == \
        {0: 0, 1: 0, 2: 1, 3: 1, 4: 2, 5: 2}
    for uid, toks in cases.items():
        assert rel_linf(jdone[uid].logits, done[uid].logits) <= BUDGET
        assert int(done[uid].prediction) == int(jdone[uid].prediction)
        e = router.entry(done[uid].cluster)
        solo = EncoderServeEngine(cfg, e.params, e.plan, max_batch=4,
                                  max_len=16, device="cpu")
        # the same bucket as the routed batch: two requests a batch
        pair = [t for u, t in cases.items()
                if done[u].cluster == done[uid].cluster]
        for i, t in enumerate(pair):
            solo.submit(EncoderRequest(uid=i, tokens=t))
        got = {tuple(r.tokens): r for r in solo.run()}[tuple(toks)]
        np.testing.assert_array_equal(done[uid].logits, got.logits)


def test_routed_engine_k_callables_and_zero_steady_state_builds(m):
    """K callables per (backend, bucket) reached by K clusters, even with
    identical plan content, and re-serving the same shapes builds
    nothing."""
    cfg = m["cfg"]
    model = LengthBuckets((6, 12))
    batches, classes = clustered_synthetic_batches(cfg, model, max_len=32)
    stats = m["eng"].calibrate(m["params"], batches, clusters=batch_clusters(
        model, batches, batch_classes=classes))
    router = build_router(cfg, m["params"],
                          PlanSet.uniform(_ffn_plan(cfg), range(3)), stats,
                          cluster_model=model, float_plan=m["eng"].float_plan)
    assert router.active_plans == 1
    e = router.entry(0)
    engine = EncoderServeEngine(cfg, e.params, e.plan, max_batch=2,
                                max_len=32, router=router, device="cpu")
    lengths = [5, 7, 10, 14]         # (c0,b8) (c1,b8) (c1,b16) (c2,b16)
    uid = 0
    for n in lengths:
        engine.submit(EncoderRequest(uid=uid, tokens=_req_tokens(cfg, n)))
        uid += 1
        engine.step(force=True)
    s = engine.stats
    assert s["runtime_executables"] == 4   # 2 clusters x 2 buckets
    warm = s["runtime_traces"]
    for n in lengths:
        engine.submit(EncoderRequest(uid=uid,
                                     tokens=_req_tokens(cfg, n, seed=9)))
        uid += 1
        engine.step(force=True)
    s = engine.stats
    assert s["runtime_traces"] == warm and s["runtime_executables"] == 4
    assert dict(router.requests_by_cluster) == {0: 2, 1: 4, 2: 2}
    assert [router.entry(c).runtime.identity for c in range(3)] == [
        {"backend": "reference", "plan": _ffn_plan(cfg).fingerprint(),
         "mesh": "unmeshed", "cluster": str(c)} for c in range(3)]
    assert "cluster" not in engine.runtime.identity
    # the counters the JAX server exports as samp_cluster_requests_total
    # and samp_active_plans
    assert s["cluster_requests"] == {0: 2, 1: 4, 2: 2}
    assert s["active_plans"] == 1
    assert M.engine_counters(engine)["cluster_requests"] == \
        s["cluster_requests"]
    plain = EncoderServeEngine(cfg, e.params, e.plan, device="cpu")
    plain.submit(EncoderRequest(uid=0, tokens=[1, 2, 3]))
    assert (plain.stats["cluster_requests"],
            plain.stats["active_plans"]) == ({0: 1}, 1)


def test_embedding_kmeans_routes_end_to_end(m):
    """EmbeddingKMeans fits during calibration, binds the deployment's
    embedding table, and routes at admission; the host assignment agrees
    with the torch argmin."""
    cfg, params, eng = m["cfg"], m["params"], m["eng"]
    model = EmbeddingKMeans(2, seed=0)
    batches, classes = clustered_synthetic_batches(cfg, model, max_len=16)
    fit_cluster_model(model, params, batches, cfg)
    assert model.fitted
    stats = eng.calibrate(params, batches,
                          clusters=batch_clusters(model, batches,
                                                  batch_classes=classes))
    router = build_router(cfg, params, PlanSet.uniform(_ffn_plan(cfg),
                                                       range(2)), stats,
                          cluster_model=model, scheme=eng.scheme,
                          float_plan=eng.float_plan)
    for n in (5, 9, 14):
        toks = _req_tokens(cfg, n)
        req = EncoderRequest(uid=0, tokens=toks)
        cid = router.admit(req)
        assert req.cluster == cid
        pooled = pooled_embeddings(
            params, {"tokens": np.asarray([toks], np.int32),
                     "segments": np.zeros((1, len(toks)), np.int32)}, cfg)
        assert int(model.assign_embedded(torch.from_numpy(pooled))[0]) == cid


# ---------------------------------------------------------------------------
# cluster-pure scheduling
# ---------------------------------------------------------------------------


def test_microbatcher_flushes_all_overdue_queues_in_one_tick():
    mb = MicroBatcher(max_batch=4, max_wait=0.01)
    for uid, (n, cluster) in enumerate([(5, 0), (5, 1), (20, 0)]):
        r = EncoderRequest(uid=uid, tokens=[1] * n)
        r.cluster = cluster
        mb.submit(r, now=0.0)
    assert len(mb) == 3 and mb.depth_by_cluster() == {0: 2, 1: 1}
    got = mb.ready(now=1.0)          # everything overdue -> one tick
    assert len(got) == 3 and len(mb) == 0
    for _bucket, batch in got:
        assert len({r.cluster for r in batch}) == 1


def test_microbatcher_queues_are_cluster_pure():
    mb = MicroBatcher(max_batch=2, max_wait=10.0)
    for uid, cluster in enumerate([0, 1, 0]):
        r = EncoderRequest(uid=uid, tokens=[1] * 5)
        r.cluster = cluster
        mb.submit(r, now=0.0)
    got = mb.ready(now=0.0)
    assert len(got) == 1
    assert [r.uid for r in got[0][1]] == [0, 2]
    assert mb.depth_by_cluster().get(1) == 1 and len(mb) == 1


def test_slot_scheduler_cluster_pure_admission():
    sched = SlotScheduler(2, cluster_pure=True)
    for uid, cluster in enumerate([0, 1, 0]):
        r = Request(uid=uid, prompt=[1, 2], max_tokens=2)
        r.cluster = cluster
        sched.submit(r)
    newly = sched.admit()
    assert [sched.active[s].uid for s in newly] == [0, 2]
    assert sched.active_cluster == 0
    assert [r.uid for r in sched.queue] == [1]
    assert sched.admit() == []       # cluster 1 waits for the batch drain
    for s in list(newly):
        sched.release(s)
    newly = sched.admit()
    assert [sched.active[s].uid for s in newly] == [1]
    assert sched.active_cluster == 1
    # without cluster_pure, FIFO into every free slot as before
    mixed = SlotScheduler(2)
    for uid, cluster in enumerate([0, 1, 0]):
        r = Request(uid=uid, prompt=[1], max_tokens=1)
        r.cluster = cluster
        mixed.submit(r)
    assert [mixed.active[s].uid for s in mixed.admit()] == [0, 1]


# ---------------------------------------------------------------------------
# routed decode
# ---------------------------------------------------------------------------


def _with_kv(plan, kv_cache):
    return PrecisionPlan(tuple(lp.with_kv(kv_cache) for lp in plan.layers),
                         plan.float_dtype)


def _routed_decoder(kv_cache=None):
    """Reduced qwen2-0.5b, calibrated per LengthBuckets((4,)) cluster, the
    ffn policy deployed uniformly with per-cluster scales (the JAX
    package's ``build_routed_model``)."""
    cfg = get_config("qwen2-0.5b").reduced()
    eng = SAMPEngine(cfg, float_dtype="float32")
    params = T.init_params(cfg, eng.float_precision, seed=0, device="cpu")
    model = LengthBuckets((4,))
    batches, classes = clustered_synthetic_batches(cfg, model, max_len=32)
    stats = eng.calibrate(params, batches, clusters=batch_clusters(
        model, batches, batch_classes=classes))
    plan = plan_from_policy(make_policy(cfg, "ffn"))
    if kv_cache is not None:
        plan = _with_kv(plan, kv_cache)
    router = build_router(cfg, params, PlanSet.uniform(plan, range(2)),
                          stats, cluster_model=model, scheme=eng.scheme,
                          float_plan=eng.float_plan)
    return cfg, router


@pytest.mark.parametrize("kv_cache", [None, "int8_per_token"])
def test_routed_decode_matches_single_plan_decode(kv_cache):
    """Routed generation equals the unrouted engine running each member,
    token for token, over dense caches and over shared int8 pages (none in
    use afterwards)."""
    cfg, router = _routed_decoder(kv_cache)
    e = router.entry(0)
    routed = ServeEngine(cfg, e.params, e.plan, batch_slots=2, max_len=32,
                         precision=e.precision, router=router, device="cpu")
    prompts = {0: [5, 9, 3], 1: [7, 2, 8, 4, 6, 1], 2: [4, 4], 3: [9] * 7}
    for uid, p in prompts.items():
        routed.submit(Request(uid=uid, prompt=p, max_tokens=4))
    outs = {r.uid: r.output for r in routed.run()}
    assert router.requests_by_cluster == {0: 2, 1: 2}
    assert routed.kv_pages_in_use == 0
    assert (routed.pool is not None) == (kv_cache is not None)
    # one cached decode step per cluster, sharing the runtime's counters
    assert routed.stats["runtime_executables"] == 2
    for uid, p in prompts.items():
        c = LengthBuckets((4,)).assign(p)
        ec = router.entry(c)
        solo = ServeEngine(cfg, ec.params, ec.plan, batch_slots=2,
                           max_len=32, precision=ec.precision, device="cpu")
        solo.submit(Request(uid=0, prompt=p, max_tokens=4))
        assert solo.run()[0].output == outs[uid], c


def test_routed_decode_refuses_mixed_kv_schemes():
    cfg, router = _routed_decoder()
    e = router.entry(1)
    e.precision = _with_kv(e.precision, "int8_per_token")
    with pytest.raises(ValueError, match="same per-layer kv_cache"):
        ServeEngine(cfg, e.params, e.plan, router=router, device="cpu")


# ---------------------------------------------------------------------------
# v3 bundles across the two packages
# ---------------------------------------------------------------------------


def _task():
    return TaskSpec(name="tnews", kind="cls", n_classes=N_CLASSES,
                    vocab_size=tiny_cfg().vocab_size, seq_len=16)


def test_v3_bundle_from_jax_loads_in_the_port(m, routers, tmp_path):
    path = str(tmp_path / "jax_v3")
    JA.save_adaptive_artifact(
        path, cfg=m["jcfg"], planset=m["jplanset"],
        cluster_model=jad.LengthBuckets(EDGES), cluster_stats=m["jstats"],
        float_params=m["jparams"],
        task=JaxTaskSpec(**dataclasses.asdict(_task())), target="cls",
        n_out=N_CLASSES)
    art = load_artifact(path, device="cpu")
    assert art.adaptive and art.planset.fingerprint() == \
        m["jplanset"].fingerprint()
    assert art.cluster_model.fingerprint() == \
        jad.LengthBuckets(EDGES).fingerprint()
    assert art.cluster_stats == {c: {layer: dict(s) for layer, s in st.items()}
                                 for c, st in m["jstats"].items()}
    jrouter, _ = routers
    router = art.router()
    for cid in m["planset"].cluster_ids:
        e = router.entry(cid)
        _assert_trees_match(params_to_numpy(e.params, e.plan),
                            jax_to_numpy(jrouter.entry(cid).params),
                            f"cluster {cid}")
    # the default member is the artifact's own pipeline
    assert art.precision.fingerprint() == \
        m["jplanset"].plan_for(0).fingerprint()


def test_v3_bundle_from_the_port_loads_in_jax(m, routers, tmp_path):
    path = str(tmp_path / "port_v3")
    A.save_adaptive_artifact(
        path, cfg=m["cfg"], planset=m["planset"],
        cluster_model=LengthBuckets(EDGES), cluster_stats=m["jstats"],
        float_params=m["params"], task=_task(), target="cls",
        n_out=N_CLASSES)
    with open(f"{path}/artifact.json") as f:
        assert json.load(f)["version"] == 3
    jart = JA.load_artifact(path)
    assert jart.adaptive
    assert jart.planset.fingerprint() == m["planset"].fingerprint()
    jrouter = jart.router()
    _, router = routers
    for cid in m["planset"].cluster_ids:
        e = router.entry(cid)
        _assert_trees_match(params_to_numpy(e.params, e.plan),
                            jax_to_numpy(jrouter.entry(cid).params),
                            f"cluster {cid}")
    # and the port reloads its own bundle to the same trees, bit for bit
    again = load_artifact(path, device="cpu").router()
    for cid in m["planset"].cluster_ids:
        a = params_to_numpy(again.entry(cid).params, again.entry(cid).plan)
        b = params_to_numpy(router.entry(cid).params, router.entry(cid).plan)
        _assert_trees_match(a, b, f"reload {cid}")
    meta = json.load(open(f"{path}/artifact.json"))
    meta["planset_fingerprint"] = "0" * 64
    json.dump(meta, open(f"{path}/artifact.json", "w"))
    with pytest.raises(ValueError, match="planset fingerprint mismatch"):
        load_artifact(path, device="cpu")


# ---------------------------------------------------------------------------
# the facade: adaptive autotune, v3 round trip, routed serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def adaptive_samp():
    """A 2-layer BERT facade (seeded random weights) autotuned into a K=3
    input-adaptive deployment (LengthBuckets)."""
    samp = SAMP.from_config(tiny_cfg(), task="tnews", seq_len=16,
                            float_dtype="float32", device="cpu")
    samp.pipeline.init_params(torch.Generator("cpu").manual_seed(0))
    samp.autotune_report = samp.autotune(
        clusters=LengthBuckets(EDGES), stride=1, eval_batches=1,
        eval_batch_size=16)
    return samp


def test_adaptive_autotune_builds_planset_and_router(adaptive_samp):
    samp = adaptive_samp
    report = samp.autotune_report
    assert samp.planset is not None and len(samp.planset) == 3
    assert samp.router is not None and samp.router.num_clusters == 3
    assert set(report.per_cluster) <= {0, 1, 2}
    assert report.planset is samp.planset
    for cid in samp.planset.cluster_ids:
        assert cid in samp.stats
        assert samp.planset.plan_for(cid).fingerprint() == \
            report.per_cluster[cid][2].point.plan.fingerprint()
    assert report.plan.fingerprint() == samp.planset.plan_for(
        samp.planset.default).fingerprint()
    assert samp.quantized.precision.fingerprint() == report.plan.fingerprint()


def test_cluster_stats_survive_artifact_roundtrip(adaptive_samp, tmp_path):
    """Per-(cluster, layer, site) amax round-trips through the v3 bundle
    exactly, and the reloaded facade rebuilds identical member trees,
    predictions and routed serving."""
    samp = adaptive_samp
    bundle = str(tmp_path / "bundle")
    samp.save(bundle)
    art = load_artifact(bundle, device="cpu")
    assert art.adaptive
    assert art.planset.fingerprint() == samp.planset.fingerprint()
    assert art.cluster_model.fingerprint() == \
        samp.cluster_model.fingerprint()
    assert art.cluster_stats == samp.stats
    reloaded = SAMP.load(bundle, device="cpu")
    assert reloaded.router is not None and reloaded.deploy_only
    from repro_torch.data.pipeline import get_batch
    b = get_batch(samp.task, 3, 16, "dev")
    np.testing.assert_array_equal(samp.predict(b), reloaded.predict(b))
    for cid in samp.planset.cluster_ids:
        a, c = samp.router.entry(cid), reloaded.router.entry(cid)
        _assert_trees_match(params_to_numpy(c.params, c.plan),
                            params_to_numpy(a.params, a.plan))
    # the JAX package loads the port's facade bundle too
    jart = JA.load_artifact(bundle)
    assert jart.planset.fingerprint() == samp.planset.fingerprint()


def test_routed_serving_matches_single_plan_serving(adaptive_samp):
    """Routed responses bit-match an unrouted engine deployed with that
    cluster's (params, plan) alone, and the member pipeline's logits."""
    samp = adaptive_samp
    engine = samp.serve(batch_slots=4, max_len=16, max_wait=0.0)
    assert engine.router is samp.router
    cases = {0: _req_tokens(samp.cfg, 5), 1: _req_tokens(samp.cfg, 10),
             2: _req_tokens(samp.cfg, 14)}
    for cid, toks in cases.items():
        req = EncoderRequest(uid=cid, tokens=toks)
        engine.submit(req)
        assert req.cluster == cid
    done = {r.uid: r for r in engine.run()}
    assert set(done) == {0, 1, 2}
    for cid, toks in cases.items():
        entry = samp.router.entry(cid)
        solo = EncoderServeEngine(samp.cfg, entry.params, entry.plan,
                                  target=samp.pipeline.target.spec,
                                  scheme=samp.pipeline.scheme, max_batch=4,
                                  max_len=16, device="cpu")
        sreq = EncoderRequest(uid=0, tokens=toks)
        solo.submit(sreq)
        solo.run()
        np.testing.assert_array_equal(done[cid].logits, sreq.logits)
        assert done[cid].prediction == sreq.prediction
        pipe_c = samp.pipeline.with_policy(entry.params, entry.plan,
                                           entry.precision)
        batch = {"tokens": np.asarray([toks]),
                 "segments": np.zeros((1, len(toks)), np.int32)}
        np.testing.assert_allclose(done[cid].logits,
                                   pipe_c.predict_logits(batch)[0],
                                   rtol=0, atol=1e-5)


def test_apply_planset_and_plan_files(adaptive_samp, tmp_path):
    """A plan-set file deploys through apply_plan_file; a cluster count
    that does not match the model's is refused, as is a facade without
    clustered stats."""
    samp = adaptive_samp
    path = samp.planset.save(str(tmp_path / "planset.json"))
    pipe = samp.apply_plan_file(path)
    assert pipe is samp.quantized and samp.router.num_clusters == 3
    with pytest.raises(ValueError, match="planset has 1 members"):
        samp.apply_planset(PlanSet.single(samp.planset.plan_for(0)))
    fresh = SAMP.from_config(tiny_cfg(), task="tnews", seq_len=16,
                             float_dtype="float32", device="cpu")
    fresh.pipeline.params = samp.pipeline.params
    with pytest.raises(ValueError, match="cluster-conditional"):
        fresh.apply_planset(samp.planset)
