"""Meshed serving in the port against unmeshed serving, on 2 gloo ranks on
the CPU (``tests/test_mesh_serving.py``'s acceptance test, ported). The JAX
package cannot serve on a mesh (that test raises ``ShardingTypeError`` at
its sharded calibration), so the port is held to the property it states:
a meshed serve equals the unmeshed serve, and through it JAX's unmeshed
``Runtime.encode``.

Ranks are spawned once for the module (``tests/torch_mesh_worker.py``, which
imports no JAX), one torch thread each, and serve reduced BERT (4 layers,
the golden plan) and reduced qwen2 at (data=2, model=1) and (data=1,
model=2): calibration on each mesh equals the unmeshed stats exactly; data
parallel rows equal the unmeshed encode of the rank's rows at the rank's
bucket bit for bit; tensor parallel sums its int8 layers' int32
accumulators (exact) and its float layer's float partials, within the JAX
test's own rtol 1e-5 / atol 1e-6; decode tokens over dense and int8 paged
caches equal the unmeshed run's, with no page in use after. ``launch.serve
--mesh 1,2`` on the CPU predicts as ``--mesh 1,1``.
"""
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.plan import PrecisionPlan as JaxPlan
from repro.models import transformer as JT
from repro.quant import ptq as jptq
from repro.serve import Runtime as JaxRuntime

from repro_torch.configs import get_config
from repro_torch.core.calibration import synthetic_calibration_batches
from repro_torch.distributed import comm

import torch_mesh_worker as W
from test_torch_support import GOLDEN, N_CLASSES, jax_to_numpy, rel_linf
from test_torch_support import to_jax_batches

ROOT = Path(__file__).resolve().parents[1]
TOPOLOGIES = W.TOPOLOGIES
BUDGET = 5e-3            # the encoder's ±1-code budget against JAX
SPAWN_S = 240.0


def _cli(mesh: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "bert-base", "--device", "cpu", "--mesh", mesh, "--requests", "6"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})


@pytest.fixture(scope="module")
def run():
    """Spawn the ranks once; meanwhile JAX computes its unmeshed reference
    and both CLI runs go. Returns (ranks' results, the JAX logits, the
    CLIs' (returncode, stdout, stderr) by mesh)."""
    jcfg = jax_get_config("bert-base").reduced()
    jplan = JaxPlan.load(GOLDEN)
    jfloat = JaxPlan.full_float(jcfg.num_layers, "float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, jfloat,
                             head=("cls", N_CLASSES))
    cfg = get_config("bert-base").reduced()
    batches = synthetic_calibration_batches(cfg, num_batches=2, seq_len=16)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, size=(3, 12)).astype(np.int32)
    inputs = {"tokens": toks, "segments": np.zeros_like(toks)}
    lengths = np.asarray([5, 12, 9], np.int32)
    qcfg = get_config("qwen2-0.5b").reduced()
    job = {"bert": {"params": jax_to_numpy(jparams), "batches": batches,
                    "inputs": inputs, "lengths": lengths},
           "qwen": {"batches": synthetic_calibration_batches(
                        qcfg, num_batches=2, seq_len=16),
                    "prompts": [rng.integers(1, qcfg.vocab_size,
                                             int(n)).tolist()
                                for n in rng.integers(2, 9, 6)],
                    "max_tokens": 6}}
    clis = {m: _cli(m) for m in ("1,1", "1,2")}
    box = {}

    def spawn():
        try:
            box["ranks"] = comm.spawn(2, W.run, (job,), device="cpu",
                                      threads=1, deadline_s=SPAWN_S)
        except BaseException as e:       # re-raised in the test thread
            box["error"] = e
    t = threading.Thread(target=spawn)
    t.start()
    jfloat_plan = JT.build_plan(jcfg, jfloat)
    jstats = jptq.capture_stats(jparams, to_jax_batches(batches), jcfg,
                                jfloat_plan, precision=jplan)
    jq, jqplan = jptq.apply_plan(jparams, jcfg, jplan, jstats,
                                 float_plan=jfloat_plan)
    rt = JaxRuntime(jcfg, jqplan, precision=jplan,
                    head=lambda p, h: JT.apply_head(h, p, "cls"))
    want = np.asarray(rt.encode(jq, inputs, lengths))
    t.join()
    outs = {m: (p.wait(timeout=SPAWN_S), *p.communicate(timeout=30))
            for m, p in clis.items()}
    if "error" in box:
        raise box["error"]
    return box["ranks"], want, outs


RANKS = (0, 1)


@pytest.mark.parametrize("rank", RANKS)
def test_ranks_import_no_jax_and_use_gloo(run, rank):
    r = run[0][rank]
    assert r["rank"] == rank and r["backend"] == "gloo"
    assert r["jax modules"] == []


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("rank", RANKS)
def test_mesh_stats_equal_unmeshed_stats(run, rank, topology):
    b = run[0][rank]["bert"]
    assert b[f"stats {topology}"] == b["stats"]


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("rank", RANKS)
def test_dp_rows_equal_the_unmeshed_rows_at_the_rank_bucket(run, rank,
                                                            backend):
    b = run[0][rank]["bert"]
    lo, hi = b[f"{backend} rank rows"]
    assert (lo, hi) == ((0, 2) if rank == 0 else (2, 3))
    np.testing.assert_array_equal(b[f"{backend} 2,1"][lo:hi],
                                  b[f"{backend} rank rows unmeshed"])
    # and every rank returns the whole output
    np.testing.assert_array_equal(b[f"{backend} 2,1"],
                                  run[0][1 - rank]["bert"][f"{backend} 2,1"])


@pytest.mark.parametrize("key", ["reference 1,2", "fused 1,2",
                                 "dynamic 1,2"])
@pytest.mark.parametrize("rank", RANKS)
def test_tp_encode_matches_unmeshed(run, rank, key):
    """Tensor parallel within the JAX test's own tolerance of the unmeshed
    encode; ``dynamic`` quantizes every block at per-token scales (the
    row-parallel GEMMs code at the whole row's scale, the attention's int8
    matmuls at the whole tensor's amax, reduced over the ranks)."""
    b = run[0][rank]["bert"]
    unmeshed = b[key.split()[0] + " unmeshed"]
    np.testing.assert_allclose(b[key], unmeshed, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(b[key], run[0][1 - rank]["bert"][key])


@pytest.mark.parametrize("rank", RANKS)
def test_dp_dynamic_scales_span_every_rank(run, rank):
    """Data parallel under per-token plans: the attention's dynamic
    per-tensor amax covers every rank's rows, so each row is the unmeshed
    encode's of the whole batch (not of the rank's rows alone)."""
    b = run[0][rank]["bert"]
    np.testing.assert_allclose(b["dynamic 2,1"], b["dynamic unmeshed"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("topology", ("unmeshed",) + TOPOLOGIES)
def test_meshed_encode_within_budget_of_jax(run, backend, topology):
    got = run[0][0]["bert"][f"{backend} {topology}"]
    assert rel_linf(run[1], got) <= BUDGET
    assert (got.argmax(-1) == run[1].argmax(-1)).all()


def test_one_cache_entry_per_topology(run):
    b = run[0][0]["bert"]
    assert b["reference cache"] == (3, 3) and b["fused cache"] == (3, 3)
    assert b["identity 1,2"]["mesh"] == "data=1,model=2"
    assert b["identity 2,1"]["mesh"] == "data=2,model=1"


@pytest.mark.parametrize("rank", RANKS)
def test_meshed_engine_predicts_the_reference_argmax(run, rank):
    b = run[0][rank]["bert"]
    want = run[1].argmax(-1)
    assert b["engine predictions"] == {i: int(want[i])
                                       for i in range(len(want))}


def test_engine_holds_only_its_block(run):
    """The DP engine's wq is whole (the model axis is 1); the rules' spec
    for it shards nothing on a (2, 1) mesh."""
    assert run[0][0]["bert"]["sharded leaf"] == (64, 64)


@pytest.mark.parametrize("cache", ["dense", "int8 pages"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("rank", RANKS)
def test_decode_tokens_equal_unmeshed(run, rank, topology, cache):
    q = run[0][rank]["qwen"]
    want = q[f"{cache} unmeshed"]
    assert sorted(want) == list(range(6))
    assert all(len(o) == 6 for o in want.values())
    assert q[f"{cache} {topology}"] == want
    assert q[f"{cache} {topology} pages"] == 0
    # data parallel holds half the slots, tensor parallel all of them
    assert q[f"{cache} {topology} slots"] == (2 if topology == "2,1" else 4)


@pytest.mark.parametrize("rank", RANKS)
def test_tp_decode_on_the_row_parallel_route(run, rank):
    """Per-token plans on int8 pages: the row-parallel GEMMs and the
    attention's dynamic scales under tensor parallelism keep every token;
    a rank holds one of the two KV heads."""
    q = run[0][rank]["qwen"]
    assert q["dynamic 1,2"] == q["dynamic unmeshed"]
    assert q["kv heads 1,2"][2] == 1


@pytest.mark.parametrize("rank", RANKS)
def test_dp_decode_dynamic_scales_span_every_rank(run, rank):
    q = run[0][rank]["qwen"]
    assert q["dynamic unmeshed"] and all(
        len(o) == 6 for o in q["dynamic unmeshed"].values())
    assert q["dynamic 2,1"] == q["dynamic unmeshed"]


@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-20b"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_dense_decoders_decode_on_a_mesh_as_unmeshed(run, arch, topology):
    a = run[0][0]["archs"]
    assert a[f"{arch} unmeshed"] and all(
        len(o) == 4 for o in a[f"{arch} unmeshed"].values())
    assert a[f"{arch} {topology}"] == a[f"{arch} unmeshed"]
    assert run[0][1]["archs"][f"{arch} {topology}"] == a[f"{arch} unmeshed"]


def _predictions(out: str) -> list:
    return re.findall(r"^  req(\d+): \d+ tokens -> (\S+)$", out, re.M)


@pytest.mark.parametrize("mesh", ["1,1", "1,2"])
def test_launch_serve_on_a_mesh_predicts_as_unmeshed(run, mesh):
    rc, out, err = run[2][mesh]
    assert rc == 0, err[-2000:]
    preds = _predictions(out)
    assert len(preds) == 6
    assert preds == _predictions(run[2]["1,1"][1])
    summary = [ln for ln in out.splitlines() if ln.startswith("[serve] ")
               and " requests" in ln]
    assert summary and ("mesh=unmeshed" if mesh == "1,1"
                        else "mesh=data=1,model=2") in summary[0]
    if mesh != "1,1":
        assert "process group gloo" in out
