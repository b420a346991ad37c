"""Fine-tuning through the port's facade and CLI: ``Pipeline.loss_fn``
against the JAX package's for every built-in target head, ``SAMP.finetune``
(the paper's step 0) on a tiny BERT, and ``python -m
repro_torch.launch.train`` on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.toolkit import Pipeline as JaxPipeline

from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core.precision import make_policy
from repro_torch.data.pipeline import get_batch
from repro_torch.interop import flatten_names, params_from_numpy
from repro_torch.launch import train as train_cli
from repro_torch.toolkit import SAMP, Pipeline

from test_torch_support import jax_to_numpy

KEY = jax.random.PRNGKey(0)
N_CLASSES = 15


def tiny_cfg(num_layers=2):
    return get_config("bert-base").reduced().replace(num_layers=num_layers)


@pytest.mark.parametrize("arch,task,target", [
    ("bert-base", "tnews", "cls"),
    ("bert-base", "afqmc", "pair_matching"),
    ("bert-base", "ner", "seq_labeling"),
    ("qwen2-0.5b", "lm", "lm")])
def test_pipeline_loss_fn_matches_jax(arch, task, target):
    """The same params (JAX's, carried across) and batch through each
    package's ``Pipeline.loss_fn``: losses within 1e-5 relative."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jpipe = JaxPipeline.build(jcfg, task, seq_len=16, float_dtype="float32")
    pipe = Pipeline.build(cfg, task, seq_len=16, float_dtype="float32",
                          device="cpu")
    assert pipe.target.spec.name == jpipe.target.spec.name == target
    jpipe.init_params(KEY)
    params = params_from_numpy(jax_to_numpy(jpipe.params), pipe.plan, "cpu")
    b = get_batch(pipe.task, 0, 8)
    want = float(jpipe.loss_fn()(jpipe.params,
                                 {k: jnp.asarray(v) for k, v in b.items()},
                                 jcfg, jpipe.plan, jpipe.scheme,
                                 compute_dtype=jnp.float32))
    got = float(pipe.loss_fn()(params,
                               {k: torch.from_numpy(v) for k, v in b.items()},
                               cfg, pipe.plan, pipe.scheme))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.fixture(scope="module")
def trained():
    """A briefly fine-tuned 2-layer BERT facade (shared across tests)."""
    samp = SAMP.from_config(tiny_cfg(), task="tnews", seq_len=16,
                            float_dtype="float32", device="cpu")
    logs = []
    samp.finetune(steps=40, batch_size=16, log_every=20, log=logs.append)
    return samp, logs


def test_finetune_beats_chance(trained):
    """40 steps lift dev accuracy above chance (1/15), as the JAX
    facade's 40-step fixture does; the step log comes every
    ``log_every`` steps."""
    samp, logs = trained
    assert [m.split()[2] for m in logs if "loss=" in m] == ["20", "40"]
    acc = samp.eval(batches=4, batch_size=32)
    assert acc > 1.0 / N_CLASSES, acc
    assert not any(p.requires_grad
                   for _, p in flatten_names(samp.pipeline.params))


def test_finetune_invalidates_stale_state():
    """Re-finetuning must drop stats/points/quantized measured on the old
    weights; re-calibrating must drop old sweep points."""
    samp = SAMP.from_config(tiny_cfg(), task="tnews", seq_len=16,
                            float_dtype="float32", device="cpu")
    samp.finetune(steps=2, batch_size=8, log=lambda *_: None)
    samp.calibrate(num_batches=1, batch_size=4)
    samp.sweep(stride=2, eval_batches=1, eval_batch_size=8)
    samp.apply(make_policy(samp.cfg, "ffn", "float32"))
    assert samp.points is not None and samp.quantized is not None
    before = samp.pipeline.params["embed"]["tok"].clone()
    samp.finetune(steps=2, batch_size=8, seed=1, log=lambda *_: None)
    assert samp.stats is None and samp.points is None \
        and samp.quantized is None
    assert not torch.equal(before, samp.pipeline.params["embed"]["tok"])
    samp.calibrate(num_batches=1, batch_size=4)
    samp.sweep(stride=2, eval_batches=1, eval_batch_size=8)
    samp.apply(make_policy(samp.cfg, "ffn", "float32"))
    samp.calibrate(num_batches=1, batch_size=4)
    assert samp.points is None and samp.quantized is None


def test_loaded_facade_refuses_finetune(trained, tmp_path):
    """A facade rebuilt from a bundle has no float model: finetune refuses
    with the deploy-only error, and the deploy surface still works."""
    samp, _ = trained
    bundle = str(tmp_path / "deploy_bundle")
    samp.calibrate(num_batches=1, batch_size=4)
    samp.apply(make_policy(samp.cfg, "ffn", "float32"))
    samp.save(bundle)
    loaded = SAMP.load(bundle, device="cpu")
    with pytest.raises(ValueError, match="deploy-only"):
        loaded.finetune(steps=1)
    assert loaded.predict(get_batch(samp.task, 0, 8, "dev")).shape == (8,)


def test_finetune_without_params_message():
    samp = SAMP.from_config(tiny_cfg(), task="tnews", seq_len=16,
                            float_dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="call finetune"):
        samp.calibrate()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "run")
    argv = ["--arch", "qwen2-0.5b", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--ckpt", ckpt]
    train_cli.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "[train] done: 3 steps of qwen2-0.5b (reduced)" in out
    assert "resumed" not in out and store.latest_step(ckpt) == 3
    train_cli.main(argv + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "[trainer] resumed from step 3" in out
    assert "[train] done: 5 steps" in out and store.latest_step(ckpt) == 5
    leaves = store.load_leaves(ckpt, 5)
    assert int(leaves["opt/step"]) == 5
    assert any(n.startswith("params/groups/0/layers/0/") for n in leaves)


def test_train_cli_audio_frames(capsys):
    """An audio config trains on seeded frames with frame labels."""
    train_cli.main(["--arch", "hubert-xlarge", "--device", "cpu", "--steps",
                    "2", "--batch", "2", "--seq", "8"])
    assert "[train] done: 2 steps of hubert-xlarge" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--device", "cuda"], "CUDA is not available"),
])
def test_train_cli_refusals(argv, match, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=match):
        train_cli.main(["--arch", "qwen2-0.5b", "--steps", "1"] + argv)


def test_pipeline_params_are_not_grad_leaves_after_finetune(trained):
    """Fine-tuned params serve as they are: no autograd state rides along
    into calibration or the bundle."""
    samp, _ = trained
    params = samp.pipeline.params
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in
         samp.pipeline._model_inputs(get_batch(samp.task, 0, 4)).items()}
    logits = samp.pipeline.forward(params, b)
    assert logits.shape == (4, N_CLASSES) and not logits.requires_grad
