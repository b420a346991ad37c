"""Port parity of the deployable surface: the checkpoint store, the leaf
names both packages address parameters by, artifact bundles across the two
packages in both directions, and ``plan_lint``'s exit codes
(repro_torch.checkpoint.store / interop / toolkit.artifact /
toolkit.plan_lint against repro's)."""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.adaptive import LengthBuckets
from repro.checkpoint.store import _path_str
from repro.core.plan import PlanSet as JaxPlanSet
from repro.core.plan import plan_from_policy as jax_plan_from_policy
from repro.core.precision import make_policy as jax_make_policy
from repro.data.pipeline import make_task as jax_make_task
from repro.quant import ptq as jptq
from repro.serve import Request as JaxRequest
from repro.toolkit import artifact as JA
from repro.toolkit import plan_lint as jlint
from repro.toolkit.samp import SAMP as JaxSAMP

from repro_torch.checkpoint import store
from repro_torch.core.plan import (INT8_SPEC, LayerPlan, PlanSet,
                                   PrecisionPlan, load_plan_or_planset)
from repro_torch.data.pipeline import get_batch
from repro_torch.interop import (flatten_names, params_from_numpy,
                                 params_to_numpy, tree_from_names)
from repro_torch.serve import Request
from repro_torch.toolkit import artifact as A
from repro_torch.toolkit import plan_lint
from repro_torch.toolkit.samp import SAMP

from test_torch_support import (GOLDEN, GOLDEN_V4, N_CLASSES, bert_slice,
                                rel_linf)

BUDGET = 5e-3            # the ±1-code budget of the int8 paths
SEQ = 16


# ---------------------------------------------------------------------------
# the store: the cases of tests/test_checkpoint.py
# ---------------------------------------------------------------------------


@pytest.fixture
def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": np.ones((4,), np.int32),
                  "d": [torch.zeros((2, 2)), np.full((3,), 7.0)]}}


def _leaves(t):
    return [np.asarray(v) for _, v in flatten_names(t)]


def test_save_restore_roundtrip(tmp_path, tree):
    store.save(str(tmp_path), 10, tree)
    out = store.restore(str(tmp_path), 10, tree)
    assert torch.is_tensor(out["a"]) and isinstance(out["b"]["c"],
                                                    np.ndarray)
    for a, b in zip(_leaves(tree), _leaves(out)):
        np.testing.assert_array_equal(a, b)
    assert [n for n, _ in flatten_names(tree)] == ["a", "b/c", "b/d/0",
                                                   "b/d/1"]


def test_keep_last_k(tmp_path, tree):
    for s in (1, 2, 3, 4, 5):
        store.save(str(tmp_path), s, tree, keep_last=2)
    assert store.all_steps(str(tmp_path)) == [4, 5]


def test_torn_tmp_dir_ignored(tmp_path, tree):
    store.save(str(tmp_path), 1, tree)
    torn = tmp_path / "step_00000002.tmp"
    torn.mkdir()
    (torn / "leaves.npz").write_bytes(b"garbage")
    assert store.latest_step(str(tmp_path)) == 1
    step, out = store.restore_latest(str(tmp_path), tree)
    assert step == 1
    store.save(str(tmp_path), 2, tree)
    assert not torn.exists()


def test_incomplete_final_dir_skipped(tmp_path, tree):
    store.save(str(tmp_path), 1, tree)
    (tmp_path / "step_00000009").mkdir()          # no manifest inside
    assert store.latest_step(str(tmp_path)) == 1
    assert store.restore_latest(str(tmp_path / "none"), tree) == (None, None)


def test_restore_shape_mismatch_raises(tmp_path, tree):
    store.save(str(tmp_path), 3, tree)
    bad = dict(tree, a=torch.zeros((5, 5)))
    with pytest.raises(ValueError):
        store.restore(str(tmp_path), 3, bad)


def test_restore_missing_leaf_raises(tmp_path, tree):
    store.save(str(tmp_path), 3, tree)
    with pytest.raises(KeyError):
        store.restore(str(tmp_path), 3, dict(tree, z=np.zeros((1,))))


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    from repro.checkpoint import store as jstore
    jtree = {"w": jax.numpy.arange(4.0), "g": [{"x": jax.numpy.ones(2)}]}
    jstore.save(str(tmp_path), 7, jtree)
    out = store.restore(str(tmp_path), 7, {"w": torch.zeros(4),
                                           "g": [{"x": torch.zeros(2)}]})
    assert out["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert out["g"][0]["x"].tolist() == [1.0, 1.0]


# ---------------------------------------------------------------------------
# leaf names: the port's params under the JAX package's key paths
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def s():
    return bert_slice(GOLDEN)


def test_names_are_the_jax_key_paths(s):
    flat, _ = jax.tree_util.tree_flatten_with_path(s["jq"])
    tree = params_to_numpy(s["qparams_from_jax"], s["qplan"])
    ours = flatten_names(tree)
    assert [n for n, _ in ours] == [_path_str(kp) for kp, _ in flat]
    for (name, a), (_, b) in zip(ours, flat):
        assert a.dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    assert "groups/0/layers/0/attn/wq/w/values" in dict(ours)
    assert not any(n.endswith("zero_point") for n, _ in ours)


def test_params_to_numpy_inverts_params_from_numpy(s):
    tree = tree_from_names(dict(flatten_names(params_to_numpy(
        s["qparams_from_jax"], s["qplan"]))))
    back = params_from_numpy(tree, s["qplan"], "cpu")
    for (n, a), (m, b) in zip(flatten_names(back),
                              flatten_names(s["qparams_from_jax"])):
        assert n == m and torch.equal(a, b), n


# ---------------------------------------------------------------------------
# bundles across the two packages
# ---------------------------------------------------------------------------


def _task(s):
    return jax_make_task("tnews", vocab_size=s["jcfg"].vocab_size,
                         seq_len=SEQ)


def _jax_bundle(s, path, policy, *, v1=False):
    """A bundle that repro writes: the golden plan, or a named policy
    (quantized here under the slice's stats); ``v1`` rewrites its
    metadata to the v1 form (an EncoderPolicy, no plan)."""
    if isinstance(policy, str):
        plan = jax_plan_from_policy(jax_make_policy(s["jcfg"], policy,
                                                    "float32"))
        jq, _ = jptq.apply_plan(s["jparams"], s["jcfg"], plan, s["jstats"],
                                float_plan=s["jfloat_plan"])
    else:
        plan, jq = policy, s["jq"]
    JA.save_artifact(path, cfg=s["jcfg"], policy=plan, stats=s["jstats"],
                     params=jq, task=_task(s), target="cls",
                     n_out=N_CLASSES, compute_dtype="float32")
    if v1:
        meta_path = os.path.join(path, A.METADATA)
        with open(meta_path) as f:
            meta = json.load(f)
        meta["version"] = 1
        meta["policy"] = {"modes": [m.value for m in plan.modes],
                          "float_dtype": plan.float_dtype}
        del meta["plan"], meta["plan_fingerprint"]
        with open(meta_path, "w") as f:
            json.dump(meta, f)
    return plan


def _batch(task, n=8):
    b = get_batch(task, 3, n, "dev")
    return {"tokens": b["tokens"], "segments": b["segments"]}


@pytest.mark.parametrize("which", ["golden-v2", "ffn-v2", "ffn-v1"])
def test_jax_bundle_loads_in_the_port(s, tmp_path, which):
    path = str(tmp_path / which)
    plan = _jax_bundle(s, path, s["jplan"] if which == "golden-v2"
                       else "ffn", v1=which.endswith("v1"))
    art = A.load_artifact(path, device="cpu")
    jart = JA.load_artifact(path)
    assert art.precision.fingerprint() == plan.fingerprint() == \
        jart.precision.fingerprint()
    assert art.stats == jart.stats and art.n_out == N_CLASSES
    b = _batch(art.task)
    ours = art.pipeline().predict_logits(b)
    theirs = np.asarray(jart.pipeline().predict_logits(b))
    assert rel_linf(theirs, ours) <= BUDGET
    assert (ours.argmax(-1) == theirs.argmax(-1)).all()
    fused = art.pipeline(backend="fused").predict_logits(b)
    assert rel_linf(ours, fused) <= BUDGET


def _port_bundle(s, path):
    """The port's own PTQ of the carried float params under the golden plan,
    saved by the port; returns the quantized pipeline it saved."""
    samp = SAMP.from_config(s["cfg"], task="tnews", seq_len=SEQ,
                            float_dtype="float32", device="cpu")
    samp.pipeline.params = s["params"]
    samp.calibrate(s["batches"], precision=s["plan"])
    pipe = samp.apply(s["plan"])
    samp.save(path)
    return pipe


def test_port_bundle_round_trip_is_bit_exact(s, tmp_path):
    path = str(tmp_path / "port")
    pipe = _port_bundle(s, path)
    art = A.load_artifact(path, device="cpu")
    assert art.precision.fingerprint() == s["plan"].fingerprint()
    for (n, a), (m, b) in zip(flatten_names(art.params),
                              flatten_names(pipe.params)):
        assert n == m and a.dtype == b.dtype and torch.equal(a, b), n
    b = _batch(art.task)
    np.testing.assert_array_equal(art.pipeline().predict_logits(b),
                                  pipe.predict_logits(b))


def test_port_bundle_loads_in_jax(s, tmp_path):
    path = str(tmp_path / "port")
    pipe = _port_bundle(s, path)
    jart = JA.load_artifact(path)
    assert jart.precision.fingerprint() == s["plan"].fingerprint()
    b = _batch(pipe.task)
    ours = pipe.predict_logits(b)
    theirs = np.asarray(jart.pipeline().predict_logits(b))
    assert rel_linf(theirs, ours) <= BUDGET
    assert (ours.argmax(-1) == theirs.argmax(-1)).all()


def test_jax_lm_bundle_serves_the_same_tokens(tmp_path):
    from repro.configs import get_config as jax_get_config
    cfg = jax_get_config("qwen2-0.5b").reduced()
    jsamp = JaxSAMP.from_config(cfg, task="lm", seq_len=SEQ,
                                float_dtype="float32")
    jsamp.pipeline.init_params(jax.random.PRNGKey(0))
    jsamp.calibrate(num_batches=2, batch_size=2)
    jsamp.apply(jax_make_policy(cfg, "ffn", "float32"))
    path = str(tmp_path / "lm")
    jsamp.save(path)
    prompts = [[3, 5, 7], [11, 2, 9, 4, 8]]
    jeng = JaxSAMP.load(path).serve(batch_slots=2, max_len=32)
    eng = SAMP.load(path, device="cpu").serve(batch_slots=2, max_len=32)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(uid=i, prompt=list(p), max_tokens=4))
        eng.submit(Request(uid=i, prompt=list(p), max_tokens=4))
    want = {r.uid: r.output for r in jeng.run()}
    got = {r.uid: r.output for r in eng.run()}
    assert got == want and all(len(v) == 4 for v in got.values())


def test_bundles_the_port_refuses(s, tmp_path):
    v3 = str(tmp_path / "v3")
    JA.save_adaptive_artifact(
        v3, cfg=s["jcfg"], planset=JaxPlanSet.single(s["jplan"]),
        cluster_model=LengthBuckets(), cluster_stats={0: s["jstats"]},
        float_params=s["jparams"], task=_task(s), target="cls",
        n_out=N_CLASSES)
    assert A.load_artifact(v3, device="cpu").adaptive   # v3 loads now
    future = os.path.join(v3, A.METADATA)
    with open(future) as f:
        meta = json.load(f)
    meta["version"] = A.VERSION + 1
    with open(future, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="not in"):
        A.load_artifact(v3, device="cpu")

    edited = str(tmp_path / "edited")
    _jax_bundle(s, edited, s["jplan"])
    meta_path = os.path.join(edited, A.METADATA)
    with open(meta_path) as f:
        meta = json.load(f)
    meta["plan_fingerprint"] = "0" * 64
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        A.load_artifact(edited, device="cpu")

    # a consistent plan and fingerprint that do not fit the saved leaves:
    # the same groups, but the float layer 2 now quantizes its qkv block
    for name, layer, match in (
            ("regrouped", None, "layer groups"),
            ("swapped", LayerPlan(qkv=INT8_SPEC), "the saved weight is float")):
        golden = s["plan"]
        plan = (PrecisionPlan.full_float(golden.num_layers, "float32")
                if layer is None else dataclasses.replace(
                    golden, layers=golden.layers[:2] + (layer,)
                    + golden.layers[3:]))
        path = str(tmp_path / name)
        shutil.copytree(edited, path)
        meta.update(plan=plan.to_dict(), plan_fingerprint=plan.fingerprint())
        with open(os.path.join(path, A.METADATA), "w") as f:
            json.dump(meta, f)
        with pytest.raises(ValueError, match=match):
            A.load_artifact(path, device="cpu")


# ---------------------------------------------------------------------------
# plan_lint: repro's exit codes
# ---------------------------------------------------------------------------


def _lint_files(tmp_path):
    golden = PrecisionPlan.load(GOLDEN)
    files = {"golden": GOLDEN, "golden_v4": GOLDEN_V4}
    (tmp_path / "bad.json").write_text("{not json")
    files["bad_json"] = str(tmp_path / "bad.json")
    d = golden.to_dict()
    d["float_dtypes"] = "float32"
    (tmp_path / "unknown_key.json").write_text(json.dumps(d))
    files["unknown_key"] = str(tmp_path / "unknown_key.json")
    files["planset"] = PlanSet(((0, golden), (2, golden)), default=2).save(
        str(tmp_path / "planset.json"))
    bad = {"planset_version": 1, "default": 1,
           "members": [{"cluster": 0, "plan": golden.to_dict()}]}
    (tmp_path / "bad_planset.json").write_text(json.dumps(bad))
    files["bad_planset"] = str(tmp_path / "bad_planset.json")
    return files


LINT_CASES = [                      # (file, arguments, exit code)
    ("golden", [], 0), ("golden_v4", [], 0), ("bad_json", [], 1),
    ("unknown_key", [], 1),
    ("golden", ["--layers", "4"], 0), ("golden", ["--layers", "12"], 1),
    ("golden", ["--arch", "bert-base"], 1),
    ("golden", ["--arch", "bert-base", "--reduced"], 0),
    ("golden_v4", ["--arch", "bert-base", "--reduced"], 1),
    ("golden_v4", ["--arch", "mixtral-8x22b", "--reduced"], 0),
    ("planset", [], 0), ("planset", ["--layers", "4"], 0),
    ("planset", ["--layers", "5"], 1), ("bad_planset", [], 1),
]


@pytest.mark.parametrize("name,args,want", LINT_CASES,
                         ids=[f"{n}{''.join(a)}" for n, a, _ in LINT_CASES])
def test_plan_lint_exit_codes_match_jax(tmp_path, name, args, want):
    path = _lint_files(tmp_path)[name]
    rc = plan_lint.main([path] + args)
    assert rc == jlint.main([path] + args) == want


def test_planset_loads_like_jax(tmp_path):
    path = _lint_files(tmp_path)["planset"]
    ours = load_plan_or_planset(path)
    assert isinstance(ours, PlanSet) and ours.cluster_ids == (0, 2)
    from repro.core.plan import load_plan_or_planset as jload
    assert ours.fingerprint() == jload(path).fingerprint()
    assert ours.plan_for(7) == ours.plans[2]
    assert isinstance(load_plan_or_planset(GOLDEN), PrecisionPlan)
