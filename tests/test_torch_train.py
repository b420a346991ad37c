"""Port parity of training (repro_torch.train against repro.train): AdamW
and its schedules, one step of the Trainer, the JAX trainer tests ported,
remat, zero gradients on unused leaves, the bfloat16 loss and checkpoints
that either package resumes.

Both packages get the same numpy inputs; JAX parameters are carried into
the port with ``interop.params_from_numpy``."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_config as jax_get_config
from repro.core.precision import EncoderPolicy as JaxPolicy
from repro.data import get_batch, make_task
from repro.models import transformer as JT
from repro.train import AdamW as JaxAdamW
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train import cosine_schedule as jax_cosine
from repro.train import linear_schedule as jax_linear
from repro.train.optimizer import global_norm as jax_global_norm
from repro.train.trainer import TrainState as JaxTrainState

from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core.precision import EncoderPolicy
from repro_torch.interop import (flatten_names, params_from_numpy,
                                 params_to_numpy, tree_from_names)
from repro_torch.train import (AdamW, TrainConfig, Trainer, TrainState,
                               cosine_schedule, linear_schedule)
from repro_torch.train.optimizer import global_norm

from test_torch_support import jax_to_numpy, rel_linf

KEY = jax.random.PRNGKey(0)
# float32 rounding of one AdamW step: both packages compute the same
# expression in float32; pow, sqrt and reduction order may differ by ulps
OPT_RTOL = 1e-6
# one bfloat16 rounding (2^-8): JAX casts the embedding output and runs
# every dense in bfloat16, autocast casts only the matmul inputs
BF16_RTOL = 2.0 ** -8


def _names(tree):
    return dict(flatten_names(tree))


def _tree(rng, scale=1.0):
    """A nested numpy tree with the shapes of a small model's leaves."""
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "blk": {"b": (rng.standard_normal(5) * scale).astype(np.float32),
                    "k": [(rng.standard_normal((3, 4)) * scale)
                          .astype(np.float32)]}}


def _torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

OPT_CASES = [
    pytest.param({"clip_norm": 1.0}, 10.0, id="clipping_active"),
    pytest.param({"clip_norm": 1e3}, 0.1, id="clipping_inactive"),
    pytest.param({"clip_norm": None, "weight_decay": 0.1}, 1.0,
                 id="no_clip_decay"),
    pytest.param({"weight_decay": 0.05, "schedule": "cosine"}, 3.0,
                 id="cosine_schedule"),
    pytest.param({"b2": 0.999, "schedule": "linear"}, 0.5,
                 id="linear_schedule"),
]


@pytest.mark.parametrize("kw,grad_scale", OPT_CASES)
def test_adamw_update_matches_jax(kw, grad_scale):
    """Four AdamW steps on the same params and gradients: params and both
    moments within 1e-6 relative (rel-Linf of each leaf: an element near 0
    may differ by one ulp of the leaf's scale), equal int32 step
    counters."""
    kw = dict(kw)
    sched = kw.pop("schedule", None)
    jkw, tkw = dict(kw), dict(kw)
    if sched:
        jf, tf = {"cosine": (jax_cosine, cosine_schedule),
                  "linear": (jax_linear, linear_schedule)}[sched]
        jkw["lr"], tkw["lr"] = jf(1e-2, 2, 4), tf(1e-2, 2, 4)
    jopt, opt = JaxAdamW(**jkw), AdamW(**tkw)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p0), _torch(p0)
    js, ts = jopt.init(jp), opt.init(tp)
    for _ in range(4):
        g = _tree(rng, grad_scale)
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = opt.update(_torch(g), ts, tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step) == 4
    for jt, tt in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
        a, b = _names(jax_to_numpy(jt)), _names(tt)
        assert a.keys() == b.keys()
        for k in a:
            assert rel_linf(a[k], b[k].numpy()) <= OPT_RTOL, k


def test_global_norm_matches_jax():
    g = _tree(np.random.default_rng(1), 3.0)
    want = float(jax_global_norm(jax.tree_util.tree_map(jnp.asarray, g)))
    assert float(global_norm(_torch(g))) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("which", ["cosine", "linear"])
def test_schedules_match_jax_at_every_step(which):
    jf, tf = {"cosine": (jax_cosine, cosine_schedule),
              "linear": (jax_linear, linear_schedule)}[which]
    jlr, lr = jf(3e-4, 10, 100), tf(3e-4, 10, 100)
    for s in range(0, 101):
        want = float(jlr(jnp.int32(s)))
        got = float(lr(torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, warmup=10, total=100)

    def at(s):
        return float(lr(torch.tensor(s, dtype=torch.int32)))
    assert at(0) == 0.0
    assert at(10) == pytest.approx(1.0)
    assert at(100) == pytest.approx(0.1, abs=1e-3)
    assert at(55) > at(90)


# ---------------------------------------------------------------------------
# the trainer: one step against JAX's, and the JAX trainer tests ported
# ---------------------------------------------------------------------------


def _qwen(steps=20, grad_accum=1, ckpt=None, remat=True, lr=3e-3,
          checkpoint_every=5, **kw):
    """Reduced qwen2-0.5b in both packages, with the same TrainConfig, and
    the lm task's numpy batches of 8 x 16."""
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    cfg = get_config("qwen2-0.5b").reduced()
    tk = dict(steps=steps, log_every=100, checkpoint_every=checkpoint_every,
              checkpoint_dir=ckpt, grad_accum=grad_accum, remat=remat,
              compute_dtype="float32", **kw)
    jtr = JaxTrainer(jcfg, JaxPolicy.full_float(jcfg.num_layers, "float32"),
                     optimizer=JaxAdamW(lr=lr), tcfg=JaxTrainConfig(**tk))
    tr = Trainer(cfg, EncoderPolicy.full_float(cfg.num_layers, "float32"),
                 optimizer=AdamW(lr=lr), tcfg=TrainConfig(**tk),
                 device="cpu")
    task = make_task("lm", vocab_size=cfg.vocab_size, seq_len=16)
    return jtr, tr, (lambda i: get_batch(task, i, 8))


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _carried(tr, jstate):
    """The JAX state's params in the port, with fresh moments."""
    params = params_from_numpy(jax_to_numpy(jstate.params), tr.plan, "cpu")
    return TrainState(params, tr.optimizer.init(params))


def _assert_params_close(jparams, tr, params, atol):
    a = _names(jax_to_numpy(jparams))
    b = _names(params_to_numpy(params, tr.plan))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=atol, err_msg=k)


def test_make_step_matches_jax():
    """One eager step of both trainers from the same params and batch: loss
    and grad norm within 1e-5 relative; params within the JAX trainer
    test's budget at lr 1e-3 (the first Adam step moves each weight by
    about lr, so float32 noise in tiny grads shows at a fraction of lr)."""
    jtr, tr, nb = _qwen(steps=1, remat=False, lr=1e-3)
    js = jtr.init_state(KEY)
    ts = _carried(tr, js)
    jp, jo, _, jm = jtr.make_step(jit=False)(js.params, js.opt_state, None,
                                             _jax_batch(nb(0)))
    tp, to, err, m = tr.make_step()(ts.params, ts.opt_state, None, nb(0))
    assert err is None and int(to.step) == int(jo.step) == 1
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-5)
    _assert_params_close(jp, tr, tp, 2e-4)


def test_loss_decreases():
    _, tr, nb = _qwen(steps=30)
    state = tr.init_state(0)
    step = tr.make_step()
    losses = []
    for i in range(30):
        p, o, e, m = step(state.params, state.opt_state, state.err_state,
                          nb(i))
        state = TrainState(p, o, e)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.1, (losses[0], losses[-1])


def test_kill_and_resume_bitwise(tmp_path):
    logs = []
    _, tr, nb = _qwen(steps=10, ckpt=str(tmp_path / "a"))
    s = tr.fit(tr.init_state(0), nb, log=lambda *_: None)
    # interrupted run: 5 steps, then a fresh trainer resumes to 10
    _, tr1, nb1 = _qwen(steps=5, ckpt=str(tmp_path / "b"))
    tr1.fit(tr1.init_state(0), nb1, log=lambda *_: None)
    _, tr2, nb2 = _qwen(steps=10, ckpt=str(tmp_path / "b"))
    s2 = tr2.fit(tr2.init_state(0), nb2, log=logs.append)
    assert "[trainer] resumed from step 5" in logs
    assert store.latest_step(str(tmp_path / "b")) == 10
    assert int(s2.opt_state.step) == 10
    a, b = _names(s.params), _names(s2.params)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-6,
                                   err_msg=k)


def test_grad_accum_matches_big_batch():
    _, _, nb = _qwen(steps=1)
    batch = nb(0)

    def one_step(accum):
        _, tr, _ = _qwen(steps=1, grad_accum=accum, remat=False, lr=1e-3)
        state = tr.init_state(0)
        p, _, _, m = tr.make_step()(state.params, state.opt_state, None,
                                    batch)
        return p, float(m["loss"])

    p1, l1 = one_step(1)
    p2, l2 = one_step(2)
    assert l1 == pytest.approx(l2, rel=1e-5)
    # the first Adam step amplifies reduction-order noise to O(lr)
    a, b = _names(p1), _names(p2)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=2e-4,
                                   err_msg=k)


def test_grad_accum_matches_jax():
    """Two contiguous micro-batches in both packages: loss and grad norm
    within 1e-5 relative."""
    jtr, tr, nb = _qwen(steps=1, grad_accum=2, remat=False, lr=1e-3)
    js = jtr.init_state(KEY)
    ts = _carried(tr, js)
    _, _, _, jm = jtr.make_step()(js.params, js.opt_state, None,
                                  _jax_batch(nb(0)))
    _, _, _, m = tr.make_step()(ts.params, ts.opt_state, None, nb(0))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-5)


def test_straggler_monitor_logs():
    _, tr, _ = _qwen(steps=1)
    msgs = []
    for _ in range(12):
        tr._note_step_time(0.01, 1, msgs.append)
    tr._note_step_time(0.2, 13, msgs.append)
    assert any("STRAGGLER" in m for m in msgs)


def test_fit_logs_every_log_every_steps():
    _, tr, nb = _qwen(steps=4)
    tr.tcfg.log_every = 2
    msgs = []
    tr.fit(tr.init_state(0), nb, log=msgs.append)
    assert [m.split()[2] for m in msgs if "loss=" in m] == ["2", "4"]


def test_remat_gradients_equal_plain_gradients():
    _, tr, nb = _qwen(steps=1, remat=False)
    state = tr.init_state(0)
    batch = tr._on_device(nb(0))
    loss, plain = tr._value_and_grad(state.params, batch)
    tr.tcfg.remat = True
    loss_r, remat = tr._value_and_grad(state.params, batch)
    assert float(loss) == float(loss_r)
    a, b = _names(plain), _names(remat)
    for k in a:
        np.testing.assert_array_equal(b[k].numpy(), a[k].numpy(), err_msg=k)


def test_unused_leaf_gets_zero_grad_and_decay():
    """bert-base with a cls head on a batch without segments: ``embed/seg``
    takes no part in the loss. JAX gives it a zero gradient, so AdamW still
    decays it; the port must too."""
    jcfg = jax_get_config("bert-base").reduced()
    cfg = get_config("bert-base").reduced()
    jpol = JaxPolicy.full_float(jcfg.num_layers, "float32")
    tk = dict(steps=1, remat=False, compute_dtype="float32")
    jtr = JaxTrainer(jcfg, jpol, optimizer=JaxAdamW(lr=1e-2,
                                                    weight_decay=0.1),
                     tcfg=JaxTrainConfig(**tk), head=("cls", 15))
    tr = Trainer(cfg, EncoderPolicy.full_float(cfg.num_layers, "float32"),
                 optimizer=AdamW(lr=1e-2, weight_decay=0.1),
                 tcfg=TrainConfig(**tk), head=("cls", 15), device="cpu")
    b = get_batch(make_task("tnews", vocab_size=cfg.vocab_size, seq_len=16),
                  0, 8)
    b.pop("segments")
    js = jtr.init_state(KEY)
    ts = _carried(tr, js)
    loss, grads = tr._value_and_grad(ts.params, tr._on_device(b))
    assert torch.count_nonzero(grads["embed"]["seg"]) == 0
    jp, _, _, jm = jtr.make_step()(js.params, js.opt_state, None,
                                   _jax_batch(b))
    tp, _, _, m = tr.make_step()(ts.params, ts.opt_state, None, b)
    seg0 = ts.params["embed"]["seg"].numpy()
    want = np.asarray(jp["embed"]["seg"])
    np.testing.assert_allclose(want, seg0 * (1 - 1e-2 * 0.1), rtol=1e-6)
    np.testing.assert_allclose(tp["embed"]["seg"].numpy(), want, rtol=1e-6,
                               atol=1e-9)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-5)


@pytest.mark.parametrize("arch,task,head", [
    ("qwen2-0.5b", "lm", None), ("bert-base", "tnews", ("cls", 15))])
def test_bfloat16_loss_matches_jax(arch, task, head):
    """compute_dtype bfloat16: the port's loss forward under autocast
    against JAX's bfloat16 loss, within one bfloat16 rounding (relative
    2^-8); autocast must actually change the float32 loss."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jpol = JaxPolicy.full_float(jcfg.num_layers, "float32")
    jparams = JT.init_params(KEY, jcfg, jpol, head=head)
    tr = Trainer(cfg, EncoderPolicy.full_float(cfg.num_layers, "float32"),
                 tcfg=TrainConfig(compute_dtype="bfloat16", remat=False),
                 device="cpu")
    params = params_from_numpy(jax_to_numpy(jparams), tr.plan, "cpu")
    b = get_batch(make_task(task, vocab_size=cfg.vocab_size, seq_len=16),
                  0, 8)
    want = float(JT.lm_loss(jparams, _jax_batch(b), jcfg,
                            JT.build_plan(jcfg, jpol),
                            compute_dtype=jnp.bfloat16))
    loss, grads = tr._value_and_grad(params, tr._on_device(b))
    assert float(loss) == pytest.approx(want, rel=BF16_RTOL)
    assert all(g.dtype == torch.float32 for g in _names(grads).values())
    tr.tcfg.compute_dtype = "float32"
    f32, _ = tr._value_and_grad(params, tr._on_device(b))
    assert float(f32) != float(loss)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX trains 5 steps and checkpoints; the port resumes to step 10.
    Against JAX's 10 uninterrupted steps: each of steps 6-10's losses
    within 1e-4 relative, the params within 1e-4 (5 Adam steps at lr 3e-3,
    float32 noise amplified by the first steps' sign-like updates)."""
    ckpt = str(tmp_path / "ck")
    jtr, _, nb = _qwen(steps=10, remat=False)
    js = jtr.init_state(KEY)
    step = jtr.make_step()
    jlosses = []
    state = js
    for i in range(10):
        p, o, e, m = step(state.params, state.opt_state, state.err_state,
                          _jax_batch(nb(i)))
        state = JaxTrainState(p, o, e)
        jlosses.append(float(m["loss"]))
    jtr5, _, _ = _qwen(steps=5, ckpt=ckpt, remat=False)
    jtr5.fit(jtr5.init_state(KEY), lambda i: _jax_batch(nb(i)),
             log=lambda *_: None)
    _, tr, _ = _qwen(steps=10, ckpt=ckpt, remat=False)
    logs = []
    # other weights than JAX's: the resume must replace them
    s = tr.fit(tr.init_state(1), nb, log=logs.append)
    assert "[trainer] resumed from step 5" in logs
    assert int(s.opt_state.step) == 10
    _assert_params_close(state.params, tr, s.params, 1e-4)
    # the same resume, step by step, for the losses of steps 6-10
    r = TrainState.from_tree(store.restore(ckpt, 5, s.as_tree(tr.plan)),
                             tr.plan, "cpu")
    step_fn, losses = tr.make_step(), []
    for i in range(5, 10):
        p, o, e, m = step_fn(r.params, r.opt_state, r.err_state, nb(i))
        r = TrainState(p, o, e)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses[5:], rtol=1e-4)
    for k, v in _names(r.params).items():
        np.testing.assert_array_equal(v.numpy(), _names(s.params)[k].numpy())


def test_port_checkpoint_restores_into_jax_template(tmp_path):
    """A port checkpoint (params, moments, step, and the zero error state
    of compress_pod_grads) read by the JAX store into a JAX TrainState
    template: every leaf bit-equal."""
    ckpt = str(tmp_path / "ck")
    jtr, tr, nb = _qwen(steps=3, ckpt=ckpt, compress_pod_grads=True)
    s = tr.fit(tr.init_state(0), nb, log=lambda *_: None)
    assert all(torch.count_nonzero(e) == 0
               for e in _names(s.err_state).values())
    template = jtr.init_state(KEY).as_tree()
    assert "err" in template
    restored = jstore.restore(ckpt, 3, template)
    want = _names(s.as_tree(tr.plan))
    got = _names(jax_to_numpy(restored))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["opt/step"]) == 3
    # and the port reads it back into its own layout
    back = TrainState.from_tree(store.restore(ckpt, 3, s.as_tree(tr.plan)),
                                tr.plan, "cpu")
    for k, v in _names(back.params).items():
        np.testing.assert_array_equal(v.numpy(), _names(s.params)[k].numpy())


@pytest.mark.parametrize("writer", ["savez", "savez_compressed"])
def test_load_leaves_reads_what_np_load_reads(tmp_path, writer):
    """``store.load_leaves`` reads each stored member of ``leaves.npz`` at
    its offset, and a compressed file through ``np.load``: either way the
    leaves ``np.load`` gives, dtype, shape and memory order included."""
    rng = np.random.default_rng(0)
    leaves = {"a0": rng.standard_normal((3, 5)).astype(np.float32),
              "a1": np.asfortranarray(rng.standard_normal((4, 6))),
              "a2": np.array(7, dtype=np.int32),
              "a3": np.zeros((0, 4), np.float32),
              "a4": rng.standard_normal((2, 3, 4)).astype(np.float16)}
    path = tmp_path / "step_00000001"
    path.mkdir()
    getattr(np, writer)(path / "leaves.npz", **leaves)
    names = ["x", "y/w", "opt/step", "empty", "z"]
    (path / store.MANIFEST).write_text(
        json.dumps({"step": 1, "names": names}))
    got = store.load_leaves(str(tmp_path), 1)
    with np.load(path / "leaves.npz") as want:
        for i, n in enumerate(names):
            w = want[f"a{i}"]
            assert got[n].dtype == w.dtype and got[n].shape == w.shape, n
            assert got[n].flags.f_contiguous == w.flags.f_contiguous, n
            np.testing.assert_array_equal(got[n], w, err_msg=n)


def test_resume_refuses_a_leaf_of_another_shape(tmp_path):
    """A checkpoint whose leaf has another shape than the trainer's is
    refused at resume, naming the leaf."""
    ckpt = tmp_path / "ck"
    _, tr, nb = _qwen(steps=2, ckpt=str(ckpt))
    tr.fit(tr.init_state(0), nb, log=lambda *_: None)
    leaves = store.load_leaves(str(ckpt), 2)
    name = next(n for n in leaves if n.startswith("params/final_norm"))
    leaves[name] = np.concatenate([leaves[name], leaves[name]], axis=-1)
    bad = tmp_path / "bad"
    store.save(str(bad), 2, tree_from_names(leaves))
    _, tr, nb = _qwen(steps=3, ckpt=str(bad))
    with pytest.raises(ValueError, match="checkpoint leaves"):
        tr.fit(tr.init_state(0), nb, log=lambda *_: None)
