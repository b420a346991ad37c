"""Training on a mesh: ``Trainer(mesh=...)`` (FSDP over ``data``, tensor
parallelism over ``model``, ZeRO-3 state), the differentiable collectives
of ``repro_torch.distributed.autograd``, the int8 pod all-reduce of
``repro_torch.distributed.compression`` and ``launch.train --ranks``.

Two gloo ranks, spawned once for the module from
``tests/torch_mesh_worker.py`` (which imports no JAX), run every job; the
tests assert on what they return:

* each differentiable collective's backward is its forward's adjoint;
* one step of every reduced config at (data=2, model=1) and (data=1,
  model=2): every gathered gradient leaf within 2e-5 rel-Linf of the
  unmeshed port (the MoE archs at the mesh's token groups), and at
  (2, 1) the loss and every gradient bit for bit the unmeshed port's at
  ``grad_accum = 2`` (its micro-batches are the ranks' rows; a sum of two
  terms does not reorder); the mesh-aware gradient norm against the
  unmeshed one;
* BERT (``cls``) and qwen2 (``lm``) after 3 meshed steps against the JAX
  package's unmeshed ``Trainer.make_step(jit=False)`` from the same
  params, at ``test_make_step_matches_jax``'s tolerances;
* ZeRO-3: a rank holds half of each FSDP-sharded leaf and the whole of the
  others, in params, both moments and the error state;
* ``compress_allreduce`` on (pod=2) ranks against the JAX package's on a
  1-device pod mesh, bit for bit ((2q)·s/2 = q·s), and a compressed step's
  error state and update against the plain version on the unmeshed
  gradient;
* checkpoints: meshed -> unmeshed, meshed -> another topology, JAX ->
  meshed, each restore bit-exact;
* the CLI on ``--device cpu --mesh-model 2 --ranks 2``, run and resumed.
"""
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_get_config
from repro.core.precision import EncoderPolicy as JaxPolicy
from repro.core.quantize import compute_scale_symmetric as jax_scale
from repro.distributed import compression as jcompression
from repro.train import AdamW as JaxAdamW
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train.trainer import TrainState as JaxTrainState

from repro_torch.checkpoint import store
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.plan import PrecisionPlan
from repro_torch.data.pipeline import get_batch, make_task
from repro_torch.distributed import comm, compression
from repro_torch.distributed.sharding import Rules
from repro_torch.interop import flatten_names, tree_from_names
from repro_torch.train import AdamW, TrainConfig, Trainer, TrainState

import torch_mesh_worker as W
from test_torch_support import jax_to_numpy, rel_linf

KEY = jax.random.PRNGKey(0)
SPAWN_S = 300.0
BATCH = (4, 8)                      # the arch sweep's global batch: B, S
GRAD_BUDGET = 2e-5                  # rel-Linf, a gathered gradient leaf
NORM_RTOL = 1e-6
RANKS = (0, 1)
TOPOLOGIES = W.TOPOLOGIES
# test_torch_train.test_make_step_matches_jax's tolerances
STEP_RTOL = 1e-5
PARAM_ATOL = 2e-4
# name: arch, task, head, and whether the port's meshed run recomputes
# each layer in the backward (remat changes no number: the JAX trainer
# runs without it, op by op)
JAX_RUNS = {"bert": ("bert-base", "tnews", ("cls", 15), True),
            "qwen2": ("qwen2-0.5b", "lm", None, False)}
JAX_STEPS = 3
CKPT_STEP = 2
POD_CASES = ("vector", "matrix", "zeros", "with_error")


def _jax_trainer(arch, head, **tk):
    jcfg = jax_get_config(arch).reduced()
    return JaxTrainer(jcfg, JaxPolicy.full_float(jcfg.num_layers, "float32"),
                      optimizer=JaxAdamW(lr=1e-3),
                      tcfg=JaxTrainConfig(remat=False,
                                          compute_dtype="float32", **tk),
                      head=head)


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _pod_tensors():
    rng = np.random.default_rng(3)
    f = np.float32
    return {"vector": ((rng.standard_normal(64) * 1e-3).astype(f),
                       np.zeros(64, f)),
            "matrix": (rng.standard_normal((8, 16)).astype(f),
                       np.zeros((8, 16), f)),
            "zeros": (np.zeros((4, 4), f), np.zeros((4, 4), f)),
            "with_error": ((rng.standard_normal((6, 5)) * 0.1).astype(f),
                           (rng.standard_normal((6, 5)) * 1e-3).astype(f))}


def _job(tmp) -> dict:
    jax_runs = {}
    for name, (arch, task, head, remat) in JAX_RUNS.items():
        jtr = _jax_trainer(arch, head)
        jax_runs[name] = {"arch": arch, "task": task, "head": head,
                          "remat": remat, "steps": JAX_STEPS,
                          "params": jax_to_numpy(jtr.init_state(KEY).params)}
    # a JAX checkpoint at step 2 for the meshed resume
    jtr = _jax_trainer("qwen2-0.5b", None, steps=CKPT_STEP,
                       checkpoint_dir=str(tmp / "jax"),
                       checkpoint_every=CKPT_STEP)
    cfg = get_config("qwen2-0.5b").reduced()
    task = make_task("lm", vocab_size=cfg.vocab_size, seq_len=16)
    jtr.fit(jtr.init_state(KEY), lambda i: _jax_batch(get_batch(task, i, 8)),
            log=lambda *_: None)
    return {"archs": ARCH_IDS, "batch": BATCH, "jax": jax_runs,
            "pod": _pod_tensors(),
            "ckpt": {"mesh": str(tmp / "mesh"), "jax": str(tmp / "jax")}}


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("train_mesh")


@pytest.fixture(scope="module")
def runs(tmp):
    """(what each rank returned, the JAX trainer's runs): the ranks train
    in a thread's spawn while this process runs the JAX steps."""
    job = _job(tmp)
    box = {}

    def spawn():
        try:
            box["ranks"] = comm.spawn(2, W.run_train_mesh, (job,),
                                      device="cpu", threads=1,
                                      deadline_s=SPAWN_S)
        except BaseException as e:          # re-raised below
            box["error"] = e
    th = threading.Thread(target=spawn)
    th.start()
    # the CLI's first run goes on beside them
    cli = subprocess.Popen(_cli_argv(tmp, 3), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True,
                           env=dict(os.environ, PYTHONPATH="src"))
    try:
        jax_out = _jax_runs()
    finally:
        th.join()
    if "error" in box:
        cli.kill()
        raise box["error"]
    return box["ranks"], jax_out, cli


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.mark.parametrize("rank", RANKS)
def test_ranks_import_no_jax(ranks, rank):
    assert ranks[rank]["rank"] == rank
    assert ranks[rank]["jax modules"] == []


# ---------------------------------------------------------------------------
# the differentiable collectives
# ---------------------------------------------------------------------------


def _expected(name, x, y):
    """(outputs, input gradients) a rank, from both ranks' x and y."""
    if name == "copy_to":
        return x, [y[0] + y[1]] * 2
    if name == "reduce_from":
        return [x[0] + x[1]] * 2, y
    if name == "gather":
        n = x[0].shape[-1]
        return ([np.concatenate(x, -1)] * 2,
                [y[r][:, r * n:(r + 1) * n] for r in RANKS])
    if name == "all_to_all":
        def swap(t):
            h = t[0].shape[0] // 2
            return [np.concatenate([t[0][r * h:(r + 1) * h],
                                    t[1][r * h:(r + 1) * h]]) for r in RANKS]
        return swap(x), swap(y)
    if name == "fsdp_gather":
        n = x[0].shape[0]
        s = y[0] + y[1]
        return [np.concatenate(x, 0)] * 2, [s[r * n:(r + 1) * n]
                                           for r in RANKS]
    raise KeyError(name)


# name: (the input is replicated, the output is replicated)
COLLECTIVES = {"copy_to": (True, False), "reduce_from": (False, True),
               "gather": (False, True), "all_to_all": (False, False),
               "fsdp_gather": (False, False)}


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_autograd_collective_is_its_adjoint(ranks, name):
    """Forward and backward against the analytic maps, and the adjoint
    identity <f(x), y> = <x, f*(y)>, where a tensor every rank holds whole
    counts once and a rank's own tensors are summed over the ranks."""
    c = [ranks[r]["autograd"][name] for r in RANKS]
    x, y = [c[r]["x"] for r in RANKS], [c[r]["y"] for r in RANKS]
    want_out, want_grad = _expected(name, x, y)
    for r in RANKS:
        np.testing.assert_allclose(c[r]["out"], want_out[r], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(c[r]["grad"], want_grad[r], rtol=1e-6,
                                   atol=1e-6)
    x_rep, out_rep = COLLECTIVES[name]

    def inner(a, b, once):
        return sum(float(np.vdot(a[r], b[r])) for r in RANKS[:1 if once
                                                             else 2])
    lhs = inner([c[r]["out"] for r in RANKS], y, out_rep)
    rhs = inner(x, [c[r]["grad"] for r in RANKS], x_rep)
    assert lhs == pytest.approx(rhs, rel=1e-5)


# ---------------------------------------------------------------------------
# one step of every config
# ---------------------------------------------------------------------------


CASES = [pytest.param(a, t, id=f"{a}-{t}") for a in ARCH_IDS
         for t in TOPOLOGIES]


@pytest.mark.parametrize("arch,topology", CASES)
def test_meshed_gradients_match_unmeshed(ranks, arch, topology):
    rec = ranks[0]["archs"][f"{arch} {topology}"]
    loss, grads = rec["unmeshed"]
    assert ranks[1]["archs"][f"{arch} {topology}"]["loss"] == rec["loss"]
    assert rec["loss"] == pytest.approx(loss, rel=1e-6)
    assert rec["grads"].keys() == grads.keys()
    for n, g in grads.items():
        assert rec["grads"][n].shape == g.shape, n
        assert rel_linf(g, rec["grads"][n]) <= GRAD_BUDGET, n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_data_parallel_is_grad_accum_bit_for_bit(ranks, arch):
    rec = ranks[0]["archs"][f"{arch} 2,1"]
    loss, grads = rec["accum"]
    assert rec["loss"] == loss
    for n, g in grads.items():
        np.testing.assert_array_equal(rec["grads"][n], g, err_msg=n)


@pytest.mark.parametrize("arch,topology", CASES)
def test_mesh_global_norm_matches_unmeshed(ranks, arch, topology):
    """The norm of the sharded gradients (each leaf's squares summed over
    the axes that shard it) against the norm of the gathered tree, on both
    ranks."""
    for r in RANKS:
        rec = ranks[r]["archs"][f"{arch} {topology}"]
        assert rec["norm"] == pytest.approx(
            ranks[0]["archs"][f"{arch} {topology}"]["whole norm"],
            rel=NORM_RTOL)


# ---------------------------------------------------------------------------
# against the JAX trainer
# ---------------------------------------------------------------------------


def _jax_runs() -> dict:
    """JAX_STEPS steps of the JAX package's unmeshed trainer, op by op:
    losses, grad norms and params."""
    out = {}
    for name, (arch, task, head, _) in JAX_RUNS.items():
        jtr = _jax_trainer(arch, head)
        state = jtr.init_state(KEY)
        step = jtr.make_step(jit=False)
        cfg = get_config(arch).reduced()
        t = make_task(task, vocab_size=cfg.vocab_size, seq_len=16)
        losses, norms = [], []
        for i in range(JAX_STEPS):
            p, o, e, m = step(state.params, state.opt_state, None,
                              _jax_batch(get_batch(t, i, 8)))
            state = JaxTrainState(p, o, e)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = (losses, norms, jax_to_numpy(state.params))
    return out


@pytest.mark.parametrize("name,topology", [
    pytest.param(n, t, id=f"{n}-{t}") for n in JAX_RUNS for t in TOPOLOGIES])
def test_meshed_steps_match_jax(runs, name, topology):
    ranks = runs[0]
    losses, norms, jparams = runs[1][name]
    rec = ranks[0]["jax"][f"{name} {topology}"]
    assert rec["step"] == JAX_STEPS
    np.testing.assert_allclose(rec["losses"], losses, rtol=STEP_RTOL)
    np.testing.assert_allclose(rec["norms"], norms, rtol=STEP_RTOL)
    want = dict(flatten_names(jparams))
    got = dict(flatten_names(rec["params"]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# ZeRO-3
# ---------------------------------------------------------------------------


class _FakeMesh:
    shape = {"data": 2, "model": 1}
    axis_names = ("data", "model")


def test_zero3_shard_bytes(ranks):
    """At (2, 1) a rank holds half of each leaf the FSDP rules shard over
    ``data`` and the whole of the others: in params, both moments and the
    error state alike."""
    z = ranks[0]["zero3"]
    cfg = get_config("qwen2-0.5b").reduced()
    specs = Rules(cfg, _FakeMesh()).params_spec(tree_from_names(
        {n: np.zeros(s) for n, s in z["whole"].items()}))
    want = 0
    for n, shape in z["whole"].items():
        numel = int(np.prod(shape))
        sharded = "data" in specs[n]
        assert (z["fsdp"][n] is not None) == sharded, n
        local = int(np.prod(z["local"][n]))
        assert local == (numel // 2 if sharded else numel), n
        want += local * 4
    assert z["params"] == z["mu"] == z["nu"] == z["err"] == want
    full = sum(int(np.prod(s)) * 4 for s in z["whole"].values())
    assert want < 0.6 * full


# ---------------------------------------------------------------------------
# the int8 pod all-reduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", POD_CASES)
def test_compress_allreduce_matches_jax(ranks, case):
    """Two pod ranks holding the same gradient against the JAX package on
    a 1-device (pod, data, model) mesh: the reduced gradient and the error
    state bit for bit."""
    g, err = _pod_tensors()[case]
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         devices=jax.devices()[:1])
    jr, je = jcompression.compress_allreduce(
        jnp.asarray(g), jnp.asarray(err), mesh=mesh, spec=JP(), axis="pod")
    for r in RANKS:
        got_r, got_e = ranks[r]["pod"][case]
        np.testing.assert_array_equal(got_r, np.asarray(jr))
        np.testing.assert_array_equal(got_e, np.asarray(je))


def test_error_feedback_compression_unbiased():
    """``tests/test_trainer.py``'s error-feedback test on the port's plain
    version: the accumulated update over 50 steps converges to the true
    sum, and every step equals the JAX loop's bit for bit."""
    rng = np.random.RandomState(0)
    g_np = rng.randn(64).astype(np.float32)
    g_true = torch.from_numpy(g_np) * 1e-3
    jg = jnp.asarray(g_np) * 1e-3
    err, total = torch.zeros_like(g_true), torch.zeros_like(g_true)
    jerr = jnp.zeros_like(jg)
    for _ in range(50):
        deq, err = compression.compress_allreduce(g_true, err)
        total = total + deq
        gf = jg + jerr
        scale = jax_scale(jnp.max(jnp.abs(gf)))
        jdeq = jnp.clip(jnp.round(gf / scale), -128, 127) * scale
        jerr = gf - jdeq
        np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
        np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    np.testing.assert_allclose(total.numpy(), (g_true * 50).numpy(),
                               rtol=0.02, atol=1e-5)


def test_pod_step_error_state_and_update(ranks):
    """A compressed step on (pod=2, data=1, model=1): the float-reduced
    gradient is the unmeshed port's at ``grad_accum = 2`` bit for bit; the
    error state after step 1 is g - q·scale of it, from the plain version;
    the update is the unmeshed optimizer's on q·scale."""
    for r in RANKS:
        got, want = ranks[r]["pod"]["step"], ranks[r]["pod"]["unmeshed"]
        assert got["loss"] == want["loss"]
        for part in ("grads", "err", "params"):
            assert got[part].keys() == want[part].keys()
            for n, v in want[part].items():
                np.testing.assert_array_equal(got[part][n], v,
                                              err_msg=f"{part} {n}")
    assert any(np.any(v) for v in ranks[0]["pod"]["step"]["err"].values())


# ---------------------------------------------------------------------------
# checkpoints across topologies and packages
# ---------------------------------------------------------------------------


def _assert_trees_equal(a, b):
    fa, fb = dict(flatten_names(a)), dict(flatten_names(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


def test_mesh_checkpoint_resumes_on_another_topology(ranks):
    c = ranks[0]["ckpt"]
    assert c["write logs"][-1].startswith(f"[trainer] step {CKPT_STEP}")
    r = c["mesh to mesh"]
    _assert_trees_equal(r["restored"], c["written"])
    assert f"[trainer] resumed from step {CKPT_STEP}" in r["logs"]
    assert r["step"] == CKPT_STEP + 1
    # rank 1 logs nothing
    assert ranks[1]["ckpt"]["mesh to mesh"]["logs"] == []


def test_mesh_checkpoint_resumes_unmeshed(ranks, tmp):
    """The (2, 1) run's checkpoint read by the unmeshed port equals the
    gathered meshed state bit for bit, and an unmeshed fit resumes from
    the newest meshed checkpoint."""
    ck = str(tmp / "mesh")
    cfg = get_config("qwen2-0.5b").reduced()
    tr = Trainer(cfg, PrecisionPlan.full_float(cfg.num_layers, "float32"),
                 optimizer=AdamW(lr=1e-3),
                 tcfg=TrainConfig(steps=CKPT_STEP + 2, checkpoint_dir=ck,
                                  remat=False, compute_dtype="float32"),
                 device="cpu")
    fresh = tr.init_state(1)
    back = TrainState.from_tree(
        store.restore(ck, CKPT_STEP, fresh.as_tree(tr.plan)), tr.plan, "cpu")
    _assert_trees_equal(back.as_tree(tr.plan), ranks[0]["ckpt"]["written"])
    task = make_task("lm", vocab_size=cfg.vocab_size, seq_len=16)
    logs = []
    end = tr.fit(fresh, lambda i: get_batch(task, i, 8), log=logs.append)
    assert f"[trainer] resumed from step {CKPT_STEP + 1}" in logs
    assert int(end.opt_state.step) == CKPT_STEP + 2


def test_jax_checkpoint_resumes_on_a_mesh(ranks, tmp):
    """The JAX package's checkpoint, restored on (1, 2) ranks and gathered,
    equals its leaves bit for bit; the meshed fit resumes from it."""
    r = ranks[0]["ckpt"]["jax to mesh"]
    leaves = store.load_leaves(str(tmp / "jax"), CKPT_STEP)
    got = dict(flatten_names(r["restored"]))
    assert got.keys() == leaves.keys()
    for k, v in leaves.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert f"[trainer] resumed from step {CKPT_STEP}" in r["logs"]
    assert r["step"] == CKPT_STEP + 1


def test_collectives_are_counted(ranks):
    s = ranks[0]["stats"]
    assert s["calls"] > 0 and s["bytes"] > 0 and s["seconds"] > 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli_argv(tmp, steps: int) -> list:
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen2-0.5b", "--device", "cpu", "--mesh-model", "2", "--ranks",
            "2", "--batch", "4", "--seq", "16", "--ckpt", str(tmp / "cli"),
            "--steps", str(steps)]


def test_train_cli_on_two_ranks_runs_and_resumes(runs, tmp):
    """3 steps (started beside the ranks), then 5, which resumes."""
    first = runs[2]
    out, err = first.communicate(timeout=SPAWN_S)
    assert first.returncode == 0, err[-3000:]
    second = subprocess.run(_cli_argv(tmp, 5), capture_output=True,
                            text=True, timeout=SPAWN_S,
                            env=dict(os.environ, PYTHONPATH="src"))
    assert second.returncode == 0, second.stderr[-3000:]
    assert "[train] done: 3 steps of qwen2-0.5b (reduced) on <ProcessMesh " \
           "data=1,model=2" in out
    assert "resumed" not in out
    assert second.stdout.count("[trainer] resumed from step 3") == 1
    assert "[train] done: 5 steps" in second.stdout
    ckpt = str(tmp / "cli")
    assert store.latest_step(ckpt) == 5
    leaves = store.load_leaves(ckpt, 5)
    assert int(leaves["opt/step"]) == 5
