"""The port's dry-run (``repro_torch.launch.dryrun``, ROADMAP item 8e)
against ``repro.launch.dryrun`` and against real ranks, on the CPU.

* Against ``repro``: one subprocess sets ``XLA_FLAGS`` to 4 host devices
  before it imports JAX, points the module attributes ``get_config`` (the
  reduced configs) and ``SHAPES`` (a decode cell of 8 x 256, a train cell
  of 8 x 64) of ``repro.launch.dryrun`` at the reduced cells, and compiles
  ``build_cell``'s step for reduced qwen2-0.5b on a (data=2, model=2)
  ``jax.make_mesh``. Per device, XLA's ``argument_size_in_bytes`` equals
  the port's argument bytes for the same cell on a
  :class:`~repro_torch.launch.mesh.RecordingMesh` of that shape, under the
  float and the ``ffn`` policies (the ``ffn`` train cell fails in both
  packages: neither differentiates int8 leaves). ``hlo_cost.analyze_hlo``'s
  dot FLOPs equal the port's ``FlopCounterMode`` count exactly: both count
  2 * M * N * K over the same matmuls of the same step (the tolerance is
  0, as measured on these cells; XLA's while-body trip counts are what
  ``analyze_hlo`` corrects, and the eager port runs every layer).
* Against real ranks: the recorder's collective calls and bytes equal
  ``comm.STATS`` of two gloo ranks (``tests/torch_mesh_worker.py``
  ``run_dryrun_mesh``) running the same reduced decode and train steps at
  (data=2, model=1) and (data=1, model=2), rank by rank.
* The CLI at full size: qwen2-0.5b's ``decode_32k`` on both production
  meshes through ``python -m repro_torch.launch.dryrun``, and every cell of
  ``--all --mesh single`` at the reduced configs and cells: ``ok`` but for
  ``cell_supported``'s skips and the cells that cannot run on ``meta``
  (:data:`META_ERRORS`, ROADMAP section 3).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import comm
from repro_torch.launch import dryrun as D
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import RecordingMesh

import torch_mesh_worker as W

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "OMP_NUM_THREADS": "1"}
CELLS = {"decode": (8, 256), "train": (8, 64)}     # (batch, seq)
SHAPE_OF = {"decode": "decode_32k", "train": "train_4k"}
TOPOLOGIES = {"2,1": {"data": 2, "model": 1}, "1,2": {"data": 1, "model": 2}}
RUN_S = 300

#: cells of ``--all`` whose step cannot run on ``meta``: (arch, shape)
META_ERRORS = set()

JAX_CELLS = '''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import get_config
from repro.launch import dryrun as D
from repro.launch.hlo_cost import analyze_hlo
cells = json.loads(sys.argv[1])
D.get_config = lambda arch: get_config(arch).reduced()
D.SH.SHAPES = {name: D.SH.ShapeCell(name, s, b, kind)
               for kind, (name, b, s) in cells.items()}
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for kind, (name, _, _) in cells.items():
    for policy in ("float", "ffn"):
        try:
            fn, args = D.build_cell("qwen2-0.5b", name, mesh, policy)
            with mesh:
                c = fn.lower(*args).compile()
            out[kind + " " + policy] = {
                "argument_bytes":
                    c.memory_analysis().argument_size_in_bytes,
                "flops": analyze_hlo(c.as_text())["flops"]}
        except Exception as e:
            out[kind + " " + policy] = {"error": type(e).__name__}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def jax_cells():
    cells = {k: (SHAPE_OF[k], b, s) for k, (b, s) in CELLS.items()}
    out = subprocess.run([sys.executable, "-c", JAX_CELLS, json.dumps(cells)],
                         capture_output=True, text=True, timeout=RUN_S,
                         env={**ENV, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def _port_cell(kind, policy, shape=None, coords=None):
    cfg = get_config("qwen2-0.5b").reduced()
    B, S = CELLS[kind]
    mesh = RecordingMesh(shape or {"data": 2, "model": 2}, coords)
    return D.build_cell("qwen2-0.5b", SHAPE_OF[kind], mesh, policy,
                        cfg=cfg, cell=SH.ShapeCell(SHAPE_OF[kind], S, B,
                                                   kind))


@pytest.mark.parametrize("kind,policy", [("decode", "float"),
                                         ("decode", "ffn"),
                                         ("train", "float")])
def test_argument_bytes_and_dot_flops_equal_jax(jax_cells, kind, policy):
    want = jax_cells[f"{kind} {policy}"]
    got = _port_cell(kind, policy)
    assert got["memory"]["argument_bytes"] == want["argument_bytes"]
    assert got["flops"] == want["flops"]


def test_quantized_train_cell_fails_in_both_packages(jax_cells):
    assert jax_cells["train ffn"] == {"error": "TypeError"}
    with pytest.raises(RuntimeError, match="floating point"):
        _port_cell("train", "ffn")


# ---------------------------------------------------------------------------
# the recorder against real ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks():
    return comm.spawn(2, W.run_dryrun_mesh,
                      ({"arch": "qwen2-0.5b", "cells": CELLS},),
                      device="cpu", threads=1, deadline_s=RUN_S)


def _coords(topology, rank):
    shape = TOPOLOGIES[topology]
    return {"data": rank if shape["data"] > 1 else 0,
            "model": rank if shape["model"] > 1 else 0}


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("kind", CELLS)
def test_recorded_collectives_equal_a_real_run(ranks, kind, topology, rank):
    real = ranks[rank][f"{kind} {topology}"]
    got = _port_cell(kind, "float", TOPOLOGIES[topology],
                     _coords(topology, rank))
    calls = sum(c["count"] for c in got["collectives"].values())
    assert (calls, got["collective_bytes"]) == (real["calls"],
                                                real["bytes"])
    assert real["calls"] > 0
    assert ranks[rank]["jax modules"] == []


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_writes_ok_records_for_qwen2_decode_on_both_meshes(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", "decode_32k", "--mesh", "both", "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=RUN_S,
        cwd=ROOT, env=ENV)
    assert out.returncode == 0, out.stderr
    for mesh, n in (("single", 256), ("multi", 512)):
        rec = json.loads((tmp_path / f"qwen2-0.5b__decode_32k__{mesh}__"
                          f"float.json").read_text())
        assert rec["status"] == "ok" and rec["num_devices"] == n
        assert rec["memory"]["argument_bytes"] > 0
        assert rec["corrected"]["flops"] > 0
        assert set(rec["collectives"]) == {"all_gather", "all_reduce"}
    # nothing was allocated on a device, and no process group was made
    assert not torch.distributed.is_initialized()


def test_all_single_mesh_cells_at_reduced_size(tmp_path, monkeypatch):
    """``--all --mesh single`` with ``get_config`` giving the reduced
    configs and ``SHAPES`` reduced cells (the step's code paths, at a size
    the CPU runs in seconds)."""
    monkeypatch.setattr(D, "get_config", lambda a: get_config(a).reduced())
    monkeypatch.setattr(SH, "SHAPES", {
        "train_4k": SH.ShapeCell("train_4k", 64, 32, "train"),
        "prefill_32k": SH.ShapeCell("prefill_32k", 128, 32, "prefill"),
        "decode_32k": SH.ShapeCell("decode_32k", 128, 32, "decode"),
        "long_500k": SH.ShapeCell("long_500k", 512, 1, "decode")})
    D.main(["--all", "--mesh", "single", "--out", str(tmp_path)])
    status = {}
    for arch in ARCH_IDS[1:]:
        for shape in SH.SHAPES:
            rec = json.loads((tmp_path / f"{arch}__{shape}__single__"
                              f"float.json").read_text())
            status[(arch, shape)] = rec["status"]
    for (arch, shape), st in status.items():
        ok, _ = SH.cell_supported(get_config(arch), shape)
        want = ("skip" if not ok else "error"
                if (arch, shape) in META_ERRORS else "ok")
        assert st == want, (arch, shape)
    assert all(status[("qwen2-0.5b", s)] == "ok"
               for s in ("train_4k", "prefill_32k", "decode_32k"))
