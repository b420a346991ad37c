"""Whole runs on the CPU at tiny widths, past the harness's look for a
card: what the harness imports, a workload and a metric added as files
alone, and ``correct`` falling when the timed path is broken underneath."""
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import core
from portbench.harness.manifest import Tree
from portbench.tests.tiny_tree import make_tree

REPO = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 99


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return Tree(make_tree(tmp_path_factory.mktemp("portbench")))


def run(tree, cell, traced=False, fault=None, seconds=1.0):
    return core.run_cell(tree, cell, SEED, seconds, traced,
                         t_start=time.perf_counter(), device="cpu",
                         fault=fault)


def test_forbidden_modules_compare_whole_top_level_names():
    assert core.forbidden_modules(["repro_torch.serve", "jaxtyping",
                                   "reproduce", "numpy"]) == []
    assert core.forbidden_modules(["repro.core", "jax.numpy", "flax",
                                   "jaxlib.xla"]) == ["flax", "jax",
                                                      "jaxlib", "repro"]


def test_a_whole_run_loads_no_jax_and_no_jax_package(tree):
    # the pytest process has imported jax already: look from a fresh one
    code = textwrap.dedent(f"""
        import sys, time, json
        sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]
        from portbench.harness import core
        from portbench.harness.manifest import Tree
        res, _ = core.run_cell(Tree({str(tree.root)!r}), "tiny.docs",
                               {SEED}, 0.5, True,
                               t_start=time.perf_counter(), device="cpu")
        print(json.dumps({{"bad": core.forbidden_modules(),
                          "correct": res["correct"],
                          "ref": sorted(m for m in sys.modules
                                        if m.startswith("portbench"))}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tree.root))
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["correct"] is True


def test_the_reference_imports_nothing_of_the_program():
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(REPO)!r}]
        import portbench.reference.bert, portbench.reference.mixtral
        print(sorted({{m.split('.')[0] for m in sys.modules}}
                     & {{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("cell", ["tiny.docs", "tiny.online", "tiny.chat"])
def test_a_sound_run_is_correct_and_reports_its_metrics(tree, cell):
    res, checks = run(tree, cell)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in
                                   tree.metrics_of(cell, "end_to_end")}
    assert list(res)[-1] == "checks"
    assert all(v <= lim for v, lim in checks.values())
    res, _ = run(tree, cell, traced=True)
    assert "setup_s" not in res["metrics"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_a_new_cell_and_metric_are_files_alone(tmp_path):
    root = make_tree(tmp_path)
    wl = json.loads((root / "portbench/workloads/tiny.docs.json").read_text())
    wl.update(name="tiny.scratch", why="a scratch mix, added as data")
    wl["mix"].update(clients=2, pairs=0.5)
    (root / "portbench/workloads/tiny.scratch.json").write_text(
        json.dumps(wl))
    (root / "portbench/metrics/scratch_passes.rps.py").write_text(
        'LAYER = "engine (serve/encoder.py)"\nUNIT = "passes"\n'
        'BETTER = "higher"\nSOURCE = "program_span"\nMOVES = "encode_rps"\n'
        '\n\ndef read(run):\n    return len(run.passes(traced=False))\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.scratch", "config": "tiny",
                               "traffic": "closed_loop", "chips": 1,
                               "why": wl["why"]})
    for m in bench["end_to_end"]:
        if m["name"] == "encode_rps":
            m["workloads"].append("tiny.scratch")
    bench["per_layer"].append({"name": "scratch_passes.rps",
                               "unit": "passes", "better": "higher",
                               "source": "program_span",
                               "layer": "engine (serve/encoder.py)",
                               "moves": "encode_rps",
                               "workloads": ["tiny.scratch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res, _ = run(Tree(root), "tiny.scratch", traced=True)
    assert res["metrics"]["scratch_passes.rps"]["value"] >= 1
    assert res["correct"] is True


def alter_one_answer(system):
    """A logit altered where the answers are produced."""
    rt = system.engine.runtime
    inner = rt.encode

    def encode(params, inputs, lengths=None):
        out = np.array(inner(params, inputs, lengths))
        out[0, 0] += 1.0 + abs(out[0]).max()
        return out
    rt.encode = encode


def swap_rows(system):
    """A micro-batch's answers handed to the wrong requests."""
    rt = system.engine.runtime
    inner = rt.encode

    def encode(params, inputs, lengths=None):
        return np.roll(np.array(inner(params, inputs, lengths)), 1, axis=0)
    rt.encode = encode


def drop_layer(system):
    """A layer of the timed path skipped (its residual update lost)."""
    params = system.engine.params
    params["layers"][1] = params["layers"][0]


@pytest.mark.parametrize("fault", [alter_one_answer, swap_rows, drop_layer],
                         ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(tree, fault):
    res, checks = run(tree, "tiny.docs", fault=fault)
    assert res["correct"] is False
    assert checks["logit_rel_linf"][0] > checks["logit_rel_linf"][1]


def alter_logits(system):
    """The decode step's logits altered where they are produced: every
    slot's next token moves."""
    eng = system.engine
    inner = eng._decode

    def decode(*a, **kw):
        logits, caches = inner(*a, **kw)
        return logits.roll(1, dims=-1), caches
    eng._decode = decode


def lose_a_layer(system):
    params = system.engine.params
    params["layers"][1] = params["layers"][0]


@pytest.mark.parametrize("fault", [alter_logits, lose_a_layer],
                         ids=lambda f: f.__name__)
def test_a_broken_decode_path_is_not_correct(tree, fault):
    res, checks = run(tree, "tiny.chat", fault=fault)
    assert res["correct"] is False
    share = checks["mean_logit_gap"]
    assert share[0] > share[1]


def control_in_place(system):
    """The control in the program's place: the plain reference with every
    int8 quantity in 4 bits and float32 matmuls in TF32 answers each pass
    (encoder) or gives each tick's logits (decoder)."""
    ref, low = system.reference(4)
    eng = system.engine
    if hasattr(eng, "_decode"):
        inner = eng._decode

        def decode(params, caches, tokens, pos, active, pages):
            logits, caches = inner(params, caches, tokens, pos, active,
                                   pages)
            out = logits.clone()
            for s in np.flatnonzero(active):
                req = eng.sched.active[s]
                seq = (list(req.prompt) + list(req.output))[:pos[s] + 1]
                out[s] = ref.logits(low, seq, tf32=True)[-1].to(out.dtype)
            return out, caches
        eng._decode = decode
        return
    rt = eng.runtime

    def encode(params, inputs, lengths=None):
        segs = inputs.get("segments", np.zeros_like(inputs["tokens"]))
        return np.stack([ref.logits(low, inputs["tokens"][i, :n],
                                    segs[i, :n], tf32=True).cpu().numpy()
                         for i, n in enumerate(lengths)])
    rt.encode = encode


@pytest.mark.parametrize("cell", ["tiny.docs", "tiny.chat"])
def test_the_control_in_the_programs_place_is_not_correct(tree, cell):
    res, checks = run(tree, cell, fault=control_in_place)
    assert res["correct"] is False
    name = "logit_rel_linf" if cell == "tiny.docs" else "mean_logit_gap"
    assert checks[name][0] > checks[name][1]


def test_a_tick_counts_what_the_engine_did(tree):
    seen = {"requests": []}

    def spy(system):
        seen["system"] = system
        inner = system.submit

        def submit(r, now):
            inner(r, now)
            seen["requests"].append(r)
        system.submit = submit
    run(tree, "tiny.chat", fault=spy)
    system = seen["system"]
    # every generated token is counted once, in the tick that made it
    assert sum(n for _, n in system.generated) == \
        sum(len(r.output) for r in seen["requests"])
    # each tick's positions are the slots' cursors: a request's fed
    # positions run 0, 1, ... over its prompt and its outputs but the last
    fed = sum(len(p[3]) for p in system.passes)
    assert fed == sum(r.length + len(r.output) - 1
                      for r in seen["requests"])
    assert all(p[2] == len(p[3]) and (p[3] >= 0).all()
               for p in system.passes)
