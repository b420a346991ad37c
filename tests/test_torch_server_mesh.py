"""The HTTP server on a mesh: ``launch.server --mesh dp,tp`` (ROADMAP item
8c), on gloo ranks on the CPU.

Two ranks are spawned once for the module (``tests/torch_mesh_worker.py``
``run_server_mesh``, which imports no JAX). At (data=2, model=1) and
(data=1, model=2) rank 0 serves reduced BERT-base and reduced qwen2-0.5b
over HTTP through ``launch.server.build_frontend``; rank 1 builds the same
engines (``build_engines``) and replays the engine operations rank 0's
driver publishes (``driver.follow``). Held:

* each rank's encoder logits bit for bit those of ``launch.serve
  --mesh``'s meshed engine fed the micro-batches rank 0's batcher made
  (the follower's batches equal to rank 0's), rank 0's HTTP answers too,
  and within the encoder's 5e-3 of the JAX package's unmeshed
  ``Runtime.encode`` on the same weights and batches;
* SSE tokens equal to ``launch.serve --mesh``'s meshed ``ServeEngine`` on
  the same prompts, no page in use after on any rank;
* 429 at ``max_pending``, 504 past a deadline with the request evicted on
  every rank, and a drain: 200 in flight, 503 new.

The CLI runs as a subprocess at ``--mesh 2,1``: it answers, and after
SIGTERM every rank returns and it exits 0. A follower that raises on its
first step makes it exit non-zero, naming the rank, without a hang. And
the op lists a driver publishes, replayed on a second engine, form rank
0's micro-batches whatever the second engine's clock reads.
"""
import asyncio
import os
import re
import signal
import subprocess
import sys
import time
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
from repro_torch.core.plan import PrecisionPlan
from repro_torch.distributed import comm
from repro_torch.launch import serve as S
from repro_torch.models import transformer as T
from repro_torch.serve import EncoderServeEngine
from repro_torch.serve import scheduler
from repro_torch.serve.frontend import HTTPFrontend
from repro_torch.serve.frontend.driver import follow

import torch_mesh_worker as W
from test_torch_support import GOLDEN, jax_to_numpy, rel_linf
from test_torch_support import to_jax_batches

ROOT = Path(__file__).resolve().parents[1]
TOPOLOGIES = W.TOPOLOGIES
RANKS = (0, 1)
BUDGET = 5e-3            # the encoder's +-1-code budget against JAX
SPAWN_S = 300.0
CLI_S = 120.0
MAX_TOKENS = 5


def _jax_bert():
    """The JAX package's reduced BERT-base with the tnews head (PRNGKey 0),
    which the ranks serve."""
    jcfg = jax_get_config("bert-base").reduced()
    _, head = S.encoder_head(get_config("bert-base").reduced(), "tnews",
                             128)
    jfloat = JaxPlan.full_float(jcfg.num_layers, "float32")
    return jcfg, jfloat, JT.init_params(jax.random.PRNGKey(0), jcfg, jfloat,
                                        head=head)


@pytest.fixture(scope="module")
def job():
    rng = np.random.default_rng(3)
    bert, qwen = (get_config(a).reduced() for a in ("bert-base",
                                                    "qwen2-0.5b"))
    return {"bert_params": jax_to_numpy(_jax_bert()[2]),
            "requests": [rng.integers(1, bert.vocab_size, int(n)).tolist()
                         for n in rng.integers(3, 40, 10)],
            "prompts": [rng.integers(1, qwen.vocab_size, int(n)).tolist()
                        for n in rng.integers(2, 9, 6)],
            "max_tokens": MAX_TOKENS}


@pytest.fixture(scope="module")
def ranks(job):
    return comm.spawn(2, W.run_server_mesh, (job,), device="cpu", threads=1,
                      deadline_s=SPAWN_S)


@pytest.mark.parametrize("rank", RANKS)
def test_ranks_import_no_jax(ranks, rank):
    assert ranks[rank]["rank"] == rank
    assert ranks[rank]["jax modules"] == []


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("rank", RANKS)
def test_encode_equals_launch_serve_meshed_engine_bit_for_bit(ranks, rank,
                                                              topology):
    e = ranks[rank][f"encode {topology}"]
    assert e["batches"] == e["rank0_batches"]
    assert e["direct_forwards"] == [1] * len(e["rank0_batches"])
    assert sorted(e["served"]) == sorted(e["direct"]) \
        == sorted(e["tokens"])
    for uid, want in e["direct"].items():
        np.testing.assert_array_equal(e["served"][uid], want)
    if rank == 0:
        assert [s for s, _ in e["http"]] == [200] * len(e["http"])
        for _, o in e["http"]:
            np.testing.assert_array_equal(
                np.asarray(o["logits"], np.float32), e["direct"][o["uid"]])
            assert o["prediction"] == int(np.argmax(e["direct"][o["uid"]]))
    else:
        assert e["replayed"]["submit"] == len(e["tokens"])
        assert e["replayed"]["stop"] == 1


def _jax_encode(groups, tokens):
    """The JAX package's unmeshed ``Runtime.encode`` of each micro-batch,
    over the ranks' weights calibrated on ``launch.serve``'s batches under
    the golden plan."""
    jcfg, jfloat, jparams = _jax_bert()
    jplan = JaxPlan.load(GOLDEN)
    jfloat = JT.build_plan(jcfg, jfloat)
    stats = jptq.capture_stats(
        jparams, to_jax_batches(synthetic_calibration_batches(
            get_config("bert-base").reduced(), seed=0)),
        jcfg, jfloat, precision=jplan)
    jq, jqplan = jptq.apply_plan(jparams, jcfg, jplan, stats,
                                 float_plan=jfloat)
    rt = JaxRuntime(jcfg, jqplan, precision=jplan,
                    head=lambda p, h: JT.apply_head(h, p, "cls"))
    out = {}
    for group in groups:
        lens = np.asarray([len(tokens[u]) for u in group], np.int32)
        toks = np.zeros((len(group), int(lens.max())), np.int32)
        for i, u in enumerate(group):
            toks[i, :lens[i]] = tokens[u]
        got = np.asarray(rt.encode(jq, {"tokens": toks,
                                        "segments": np.zeros_like(toks)},
                                   lens))
        out.update(zip(group, got))
    return out


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_http_encode_within_budget_of_jax_unmeshed(ranks, topology):
    e = ranks[0][f"encode {topology}"]
    want = _jax_encode(e["rank0_batches"], e["tokens"])
    for _, o in e["http"]:
        assert rel_linf(np.asarray(o["logits"], np.float32),
                        want[o["uid"]]) <= BUDGET


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("rank", RANKS)
def test_sse_tokens_equal_launch_serve_meshed_engine(ranks, rank, topology,
                                                     job):
    g = ranks[rank][f"generate {topology}"]
    assert g["pages_in_use"] == g["direct_pages_in_use"] == 0
    assert sorted(g["direct"]) == list(range(len(job["prompts"])))
    if rank == 1:
        assert g["replayed"]["submit"] == len(job["prompts"])
        assert g["replayed"]["decode_step"] > MAX_TOKENS
        return
    for i, (status, events) in enumerate(g["streams"]):
        toks = [d["token"] for e, d in events if e == "token"]
        done = [d for e, d in events if e == "done"]
        assert status == 200 and len(done) == 1
        assert toks == done[0]["tokens"] == g["direct"][i]
        assert [d["index"] for e, d in events if e == "token"] \
            == list(range(MAX_TOKENS))


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("rank", RANKS)
def test_admission_deadline_and_drain_on_every_rank(ranks, rank, topology):
    a = ranks[rank][f"admission {topology}"]
    # every rank batched the two admitted requests, none of the rejected
    assert a["burst_batches"] >= 1
    assert a["deadline_evicted"] == 1 and a["deadline_batches"] == 0
    assert a["drain_batches"] == 1
    if rank == 1:
        assert a["burst"]["replayed"]["submit"] == 2
        assert a["deadline"]["replayed"]["cancel"] == 1
        return
    assert a["burst"] == {"statuses": [200, 200, 429, 429, 429, 429],
                          "retry": ["1"]}
    assert a["deadline"]["status"] == 504
    assert "deadline" in a["deadline"]["error"]
    assert a["drain"] == {"inflight": 200, "new": 503, "retry": "5"}


# ---------------------------------------------------------------------------
# the published operations, replayed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clock", [0.0, 1e9])
def test_replayed_op_lists_form_rank_0s_batches_whatever_the_clock(
        monkeypatch, clock):
    """A front-end whose driver publishes into a list, ageing micro-batches
    over 50 ms while requests arrive in waves (one past its deadline):
    the lists replayed on a second engine, whose clock is stuck at
    ``clock``, form the same batches and the same logits."""
    cfg = get_config("bert-base").reduced()
    plan = PrecisionPlan.full_float(cfg.num_layers, "float32")
    params = T.init_params(cfg, plan, seed=0, head=("cls", 15),
                           device="cpu")

    def engine():
        return EncoderServeEngine(cfg, params, T.build_plan(cfg, plan),
                                  max_batch=4, max_wait=0.05, max_len=64,
                                  device="cpu")
    lists, served, replica = [], engine(), engine()
    seen = {id(e): W._Batches(e) for e in (served, replica)}
    fe = HTTPFrontend(encoder=served, port=0, publish=lists.append,
                      log=lambda *a, **k: None)
    rng = np.random.default_rng(0)

    async def scenario():
        await fe.start()
        try:
            out = []
            for wave in (3, 6, 1):
                out += await asyncio.gather(
                    *(W.http(fe.port, "POST", "/v1/encode", {
                        "tokens": rng.integers(1, 99, int(n)).tolist()})
                      for n in rng.integers(3, 40, wave)),
                    W.http(fe.port, "POST", "/v1/encode", {
                        "tokens": [5, 6, 7], "deadline_ms": 1}))
                await asyncio.sleep(0.02)
            return out
        finally:
            await fe.stop()
    got = asyncio.run(scenario())
    assert sorted(s for s, _, _ in got).count(504) >= 1
    assert lists[-1] == [("stop",)]
    monkeypatch.setattr(scheduler.time, "monotonic", lambda: clock)
    replayed = follow(encoder=replica, receive=iter(lists).__next__)
    rank0, follower = seen[id(served)], seen[id(replica)]
    assert len(rank0.batches) > 1
    assert follower.batches == rank0.batches
    assert replayed["cancel"] == replica.batcher.evicted >= 1
    for uid, want in rank0.logits.items():
        np.testing.assert_array_equal(follower.logits[uid], want)


# ---------------------------------------------------------------------------
# the CLI, as a user starts it
# ---------------------------------------------------------------------------


def _env(**extra):
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [*extra.pop("path", []), str(ROOT / "src")]),
        "OMP_NUM_THREADS": "1", **extra}


def _children(pid: int) -> list[int]:
    out = []
    for d in os.listdir("/proc"):
        try:
            with open(f"/proc/{d}/stat") as f:
                if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                    out.append(int(d))
        except (OSError, ValueError, IndexError):
            continue
    return out


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie, exited but not yet reaped, does
    not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def _start(env) -> tuple[subprocess.Popen, int, list]:
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.server", "--arch",
         "bert-base", "--plan", GOLDEN, "--port", "0", "--device", "cpu",
         "--mesh", "2,1", "--max-wait", "0.01"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env,
        start_new_session=True)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        m = re.search(r"listening on http://[\d.]+:(\d+)", line)
        if m:
            return proc, int(m.group(1)), lines
    _kill(proc)
    pytest.fail(f"no listening line: {lines} {proc.stderr.read()}")


def _kill(proc) -> None:
    """SIGKILL the server's session, its ranks with it."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(CLI_S)


def test_server_cli_on_a_mesh_answers_and_exits_0_on_sigterm():
    proc, port, lines = _start(_env())
    try:
        ranks = _children(proc.pid)

        async def scenario():
            return (await W.http(port, "GET", "/healthz"),
                    await W.http(port, "POST", "/v1/encode",
                                 {"tokens": [5, 9, 3, 7]}),
                    await W.http(port, "GET", "/metrics"))
        health, encoded, metrics = asyncio.run(
            asyncio.wait_for(scenario(), CLI_S))
        proc.send_signal(signal.SIGTERM)
        rest, err = proc.communicate(timeout=CLI_S)
    finally:
        _kill(proc)
    assert health[0] == 200 and health[2]["status"] == "ok"
    assert encoded[0] == 200 and len(encoded[2]["logits"]) == 15
    assert 'mesh="data=2,model=1"' in metrics[2]
    assert proc.returncode == 0, err
    assert rest.rstrip().endswith("drained; bye")
    assert len(ranks) >= 2          # the ranks (and the resource tracker)
    assert not [p for p in ranks if _alive(p)]


def test_ranks_end_when_the_server_process_is_killed():
    """SIGKILL to the launching process alone, which can forward nothing:
    its ranks see their parent gone and end within seconds."""
    proc, _, _ = _start(_env())
    ranks = _children(proc.pid)
    try:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(CLI_S)
        end = time.monotonic() + 30.0
        while time.monotonic() < end and any(map(_alive, ranks)):
            time.sleep(0.2)
        left = [p for p in ranks if _alive(p)]
    finally:
        for p in ranks:
            if _alive(p):
                os.kill(p, signal.SIGKILL)
    assert len(ranks) >= 2 and left == []


FAULT = '''\
import repro_torch.serve.encoder as E
_step = E.EncoderServeEngine.step


def _faulty(self, now=None, force=False):
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_rank() == 1:
        raise RuntimeError("injected follower fault")
    return _step(self, now, force)


E.EncoderServeEngine.step = _faulty
'''


def test_follower_fault_exits_non_zero_without_hanging(tmp_path):
    """A follower whose first step raises (patched in every process of the
    run through a ``sitecustomize`` module): the server exits non-zero
    within the spawn's grace period, naming rank 1 and its traceback."""
    (tmp_path / "sitecustomize.py").write_text(FAULT)
    proc, port, _ = _start(_env(path=[str(tmp_path)]))
    try:
        t = time.monotonic()

        async def request():
            try:
                return await W.http(port, "POST", "/v1/encode",
                                    {"tokens": [5, 9, 3, 7]})
            except (ConnectionError, ValueError, IndexError):
                return None
        asyncio.run(asyncio.wait_for(request(), CLI_S))
        _, err = proc.communicate(timeout=CLI_S)
        took = time.monotonic() - t
    finally:
        _kill(proc)
    assert proc.returncode not in (0, None)
    assert "rank 1 failed" in err and "injected follower fault" in err
    assert took < 60.0
