"""Port parity for the serving CLIs (``repro_torch.launch`` against
``repro.launch``): the shared flag surface, ``parse_cluster_model`` and
``resolve_task``, the plans ``build_model`` resolves, the port's device and
mesh rules, and both entry points run as subprocesses on the CPU."""
import argparse
import ast
import asyncio
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import cli as JC
from repro.launch import serve as JS

from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch import cli as C
from repro_torch.launch import serve as S
from repro_torch.launch import server as SV
from repro_torch.models import transformer as T

from test_torch_frontend import http_json
from test_torch_support import GOLDEN, jax_to_numpy

ROOT = Path(__file__).resolve().parents[1]
SILENT = lambda *a, **k: None  # noqa: E731
RUN_S = 240                      # one CLI subprocess, start to exit
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}


# ---------------------------------------------------------------------------
# the flag surface
# ---------------------------------------------------------------------------


def _flags(ap: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     a.required, a.type, a.nargs)
            for a in ap._actions if a.dest != "help"}


def test_serving_flags_match_jax_plus_device():
    ours = _flags(C.add_serving_flags(argparse.ArgumentParser()))
    theirs = _flags(JC.add_serving_flags(argparse.ArgumentParser()))
    assert ours.pop("device") == (("--device",), "cuda", None, False, None,
                                  None)
    assert ours == theirs


def _main_flags(path: Path, fn: str) -> dict:
    """The ``add_argument`` calls of ``fn`` in ``path``: option strings and
    literal keyword values (``type=`` by name)."""
    tree = ast.parse(path.read_text())
    func = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == fn)
    out = {}
    for call in ast.walk(func):
        if isinstance(call, ast.Call) and getattr(
                call.func, "attr", "") == "add_argument":
            opts = tuple(ast.literal_eval(a) for a in call.args)
            kw = {k.arg: (k.value.id if isinstance(k.value, ast.Name)
                          else ast.literal_eval(k.value))
                  for k in call.keywords if k.arg != "help"}
            out[opts] = kw
    return out


@pytest.mark.parametrize("module,jax_fn,fn", [("serve", "main", "main"),
                                             ("server", "main",
                                              "make_parser")])
def test_entry_point_flags_match_jax(module, jax_fn, fn):
    theirs = _main_flags(ROOT / "src" / "repro" / "launch" / f"{module}.py",
                         jax_fn)
    ours = _main_flags(ROOT / "src" / "repro_torch" / "launch" /
                       f"{module}.py", fn)
    assert ours == theirs and ours


def test_server_parser_parses_like_jax_server_flags():
    args = SV.make_parser().parse_args(["--arch", "bert-base", "--port", "0"])
    assert (args.host, args.port, args.max_pending, args.max_wait,
            args.deadline_s, args.backend, args.device, args.mesh) == (
        "127.0.0.1", 0, 64, 0.005, None, "reference", "cuda", "1,1")


# ---------------------------------------------------------------------------
# parse_cluster_model and resolve_task
# ---------------------------------------------------------------------------


def _outcome(fn, *args):
    try:
        out = fn(*args)
    except SystemExit as e:
        return ("SystemExit", str(e))
    if out is None or isinstance(out, str):
        return out
    return (type(out).__name__, out.num_clusters, out.to_dict())


@pytest.mark.parametrize("spec", [None, "length:8,16", "length:32",
                                  "task:chat,search", "kmeans:3",
                                  "length:a,b", "kmeans:", "kmeans:x",
                                  "bogus:1", "length"])
def test_parse_cluster_model_matches_jax(spec):
    assert _outcome(C.parse_cluster_model, spec) == \
        _outcome(JC.parse_cluster_model, spec)


@pytest.mark.parametrize("arch", ["bert-base", "qwen2-0.5b"])
@pytest.mark.parametrize("task", [None, "lm", "tnews", "ner"])
def test_resolve_task_matches_jax(arch, task):
    ours = _outcome(C.resolve_task, get_config(arch).reduced(), task)
    assert ours == _outcome(JC.resolve_task,
                            jax_get_config(arch).reduced(), task)


# ---------------------------------------------------------------------------
# the port's rules: device and mesh
# ---------------------------------------------------------------------------


def _args(*argv):
    return SV.make_parser().parse_args(["--arch", "bert-base", *argv])


@pytest.mark.parametrize("spec", ["2,1", "1,2", "4,2"])
def test_mesh_other_than_1_1_exits_naming_item_8(spec):
    """Since slice 16 ``launch.serve`` serves a mesh (``--mesh 1,2`` runs
    in tests/test_torch_mesh.py): the shared flag surface takes it, and
    only the HTTP server still exits, naming ROADMAP item 8c."""
    assert C.check_mesh(spec) == tuple(int(p) for p in spec.split(","))
    cfg, device = C.serving_config(_args("--mesh", spec, "--device", "cpu"))
    assert device.type == "cpu" and cfg == get_config("bert-base").reduced()
    with pytest.raises(SystemExit, match="item 8c"):
        SV.build_frontend(_args("--mesh", spec, "--device", "cpu"),
                          log=SILENT)


@pytest.mark.parametrize("spec", ["2", "a,b", "0,1"])
def test_malformed_mesh_raises_as_jax_parses_it(spec):
    with pytest.raises(ValueError, match="--mesh"):
        C.check_mesh(spec)


def test_device_picks_the_config_and_never_falls_back():
    cfg, device = C.serving_config(_args("--device", "cpu"))
    assert device.type == "cpu" and cfg == get_config("bert-base").reduced()
    if torch.cuda.is_available():
        cfg, device = C.serving_config(_args())
        assert device.type == "cuda" and cfg == get_config("bert-base")
    else:
        with pytest.raises(SystemExit, match="--device cuda"):
            C.serving_config(_args())


# ---------------------------------------------------------------------------
# build_model: the JAX package's plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw", [
    ("bert-base", {"policy_name": "ffn"}),
    ("bert-base", {"policy_name": "full2"}),
    ("bert-base", {"policy_name": "float"}),
    ("qwen2-0.5b", {"plan_file": GOLDEN}),
    ("qwen2-0.5b", {"policy_name": "full"}),
])
def test_build_model_resolves_jax_plans(arch, kw):
    head = ("cls", 15) if arch == "bert-base" else None
    _, jplan, jprec = JS.build_model(jax_get_config(arch).reduced(),
                                     head=head, log=SILENT, **kw)
    params, plan, prec = S.build_model(get_config(arch).reduced(), head=head,
                                       log=SILENT, device="cpu", **kw)
    assert prec.fingerprint() == jprec.fingerprint()
    assert len(plan) == len(jplan)
    assert params["embed"]["tok"].device.type == "cpu"


def test_build_model_strategy_matches_jax(monkeypatch):
    """``--strategy greedy``: both packages calibrate and search on the
    same numpy batches over the same (JAX-initialized) float weights, and
    choose the same plan."""
    cfg, jcfg = (get_config("bert-base").reduced(),
                 jax_get_config("bert-base").reduced())
    head = ("cls", 15)
    rng = np.random.default_rng(7)

    def batches(cfg, *, num_batches=4, batch_size=2, seq_len=32, seed=0):
        out = []
        for i in range(num_batches):
            b = {"tokens": rng.integers(0, cfg.vocab_size,
                                        (batch_size, seq_len), np.int32)}
            b["segments"] = np.zeros_like(b["tokens"])
            out.append(b)
        return out

    fixed = {(n, s): batches(cfg, num_batches=n, seq_len=s)
             for n, s in ((4, 32), (1, 32))}

    def numpy_batches(cfg, *, num_batches=4, batch_size=2, seq_len=32,
                      seed=0):
        return [dict(b) for b in fixed[(num_batches, seq_len)]]

    def jax_batches(cfg, **kw):
        return [{k: jax.numpy.asarray(v) for k, v in b.items()}
                for b in numpy_batches(cfg, **kw)]

    jparams = JS.T.init_params(jax.random.PRNGKey(0), jcfg,
                               JS.SAMPEngine(jcfg, float_dtype="float32")
                               .float_policy, head=head)
    float_plan = S.SAMPEngine(cfg, float_dtype="float32").float_plan
    monkeypatch.setattr(JS, "synthetic_calibration_batches", jax_batches)
    monkeypatch.setattr(S, "synthetic_calibration_batches", numpy_batches)
    monkeypatch.setattr(JS.T, "init_params", lambda *a, **k: jparams)
    monkeypatch.setattr(T, "init_params", lambda *a, **k: params_from_numpy(
        jax_to_numpy(jparams), float_plan, "cpu"))
    jlog, log = [], []
    _, _, jprec = JS.build_model(jcfg, head=head, strategy="greedy",
                                 log=jlog.append)
    _, _, prec = S.build_model(cfg, head=head, strategy="greedy",
                               log=log.append, device="cpu")
    assert prec.fingerprint() == jprec.fingerprint()
    assert prec.num_quant_ffn or prec.num_quant_mha
    chose = [re.sub(r"speedup \S+", "", m) for m in (log[0], jlog[0])]
    assert chose[0] == chose[1]


# ---------------------------------------------------------------------------
# the entry points, as a user starts them, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--arch", "bert-base", "--task", "tnews", "--policy", "ffn",
     "--requests", "6"],
    ["--arch", "qwen2-0.5b", "--plan", GOLDEN, "--page-size", "8",
     "--kv-dtype", "int8_per_token", "--backend", "fused", "--requests",
     "3", "--max-tokens", "4"],
    ["--arch", "bert-base", "--policy", "ffn", "--clusters", "length:8,16",
     "--requests", "4", "--max-len", "32"],
], ids=["bert", "qwen2", "bert_routed"])
def test_serve_cli_runs_on_cpu(argv):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv,
         "--device", "cpu"], capture_output=True, text=True, timeout=RUN_S,
        cwd=ROOT, env=ENV)
    assert out.returncode == 0, out.stderr
    summary = [ln for ln in out.stdout.splitlines()
               if ln.startswith("[serve] ") and " requests" in ln]
    assert summary and "CPU)" in summary[0], out.stdout


def test_server_cli_answers_and_drains_on_sigterm():
    """``python -m repro_torch.launch.server --port 0 --device cpu``: reads
    its port from the ``listening on`` line, answers /healthz and
    /v1/encode, and exits 0 after SIGTERM's drain."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.server", "--arch",
         "bert-base", "--plan", GOLDEN, "--port", "0", "--device", "cpu",
         "--max-wait", "0.01"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT, env=ENV)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"listening on http://[\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        else:
            pytest.fail(f"no listening line: {lines} {proc.stderr.read()}")

        async def scenario():
            return (await http_json(port, "GET", "/healthz"),
                    await http_json(port, "POST", "/v1/encode",
                                    {"tokens": [5, 9, 3, 7]}))
        health, encoded = asyncio.run(asyncio.wait_for(scenario(), RUN_S))
        proc.send_signal(signal.SIGTERM)
        rest, err = proc.communicate(timeout=RUN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(RUN_S)
    assert (health[0], health[2]) == (
        200, {"status": "ok", "engines": {"encoder": True, "decode": False},
              "inflight": 0})
    assert encoded[0] == 200 and len(encoded[2]["logits"]) == 15
    assert proc.returncode == 0, err
    assert "drained; bye" in rest
    assert "kernels loaded" not in "".join(lines)  # nothing to build on CPU


def test_walk_packages_imports_launchers_without_starting_anything():
    code = ("import importlib, pkgutil, sys, threading, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "need = {'repro_torch.launch.server', 'repro_torch.launch.serve',"
            " 'repro_torch.launch.cli', 'repro_torch.serve.frontend.server'}\n"
            "assert need <= set(sys.modules), need - set(sys.modules)\n"
            "assert threading.active_count() == 1, threading.enumerate()\n"
            "assert not [k for k in sys.modules "
            "if k.split('.')[0] in ('jax', 'repro')]\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=RUN_S, env=ENV)
    assert out.returncode == 0, out.stderr
