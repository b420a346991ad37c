"""A copy of the benchmark's files at tiny widths, for CPU tests: the
bert-base configuration cut to one period of its plan (4 layers) at width
32, and its two cells as ``tiny.docs`` and ``tiny.online`` at small loads,
added to a copy of BENCHMARK.json by the same rules as the real cells."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = dict(num_layers=4, d_model=32, num_heads=2, num_kv_heads=2,
            head_dim=16, d_ff=64, vocab_size=97, max_position=64,
            num_segments=2)
TINY_MOE = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                head_dim=8, d_ff=48, vocab_size=101, sliding_window=4096,
                rope_theta=10000.0,
                moe={"num_experts": 4, "top_k": 2, "d_ff_expert": 48,
                     "num_shared": 0, "first_dense": 0,
                     "capacity_factor": 2.0})


def plan_fingerprint(path) -> str:
    from repro_torch.core.plan import PrecisionPlan
    return PrecisionPlan.load(str(path)).fingerprint()


def make_tree(dst) -> Path:
    dst = Path(dst)
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__",
                                                  "_cache", "_local"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    span = json.loads((REPO / "portbench/plans/bert-base.span.json")
                      .read_text())
    span["layers"] = span["layers"][:4]
    plan = dst / "portbench/plans/tiny.json"
    plan.write_text(json.dumps(span))
    c = json.loads((REPO / "portbench/configs/bert-base.json").read_text())
    c.update(name="tiny", config=dict(TINY), plan="portbench/plans/tiny.json",
             plan_fingerprint=plan_fingerprint(plan),
             calibration={"batches": 2, "batch_size": 2, "seq_len": 64})
    (dst / "portbench/configs/tiny.json").write_text(json.dumps(c))
    for kind in ("docs", "online"):
        wl = json.loads((REPO / f"portbench/workloads/bert-base.{kind}.json")
                        .read_text())
        wl.update(name=f"tiny.{kind}", config="tiny",
                  trace={"start_s": 0.2, "length_s": 0.3})
        wl["engine"].update(max_len=64, max_batch=4)
        L = wl["mix"]["lengths"]
        L.update(max=min(L["max"], 64), min=min(L["min"], 16),
                 median=min(L["median"], 30))
        if kind == "docs":
            wl["mix"]["clients"] = 8
        else:
            wl["mix"]["rate"] = 40.0
        wl["correct"]["sample"] = 8
        (dst / f"portbench/workloads/tiny.{kind}.json").write_text(
            json.dumps(wl))
        real = f"bert-base.{kind}"
        cell = dict(next(w for w in bench["workloads"] if w["name"] == real),
                    name=f"tiny.{kind}", config="tiny")
        bench["workloads"].append(cell)
        for section in ("end_to_end", "per_layer"):
            for m in bench[section]:
                if real in m.get("workloads", []):
                    m["workloads"].append(f"tiny.{kind}")
    c = json.loads((REPO / "portbench/configs/mixtral-8x22b.json")
                   .read_text())
    c.update(name="tiny-moe", config=dict(TINY_MOE),
             calibration={"batches": 2, "batch_size": 2, "seq_len": 16})
    (dst / "portbench/configs/tiny-moe.json").write_text(json.dumps(c))
    wl = json.loads((REPO / "portbench/workloads/mixtral-8x22b.chat.json")
                    .read_text())
    wl.update(name="tiny.chat", config="tiny-moe",
              trace={"start_s": 0.2, "length_s": 0.3},
              engine={"slots": 4, "max_len": 48})
    wl["mix"].update(clients=4, lengths={"median": 8, "sigma": 0.5,
                                         "min": 4, "max": 16},
                     outputs={"median": 6, "sigma": 0.5, "min": 2,
                              "max": 12})
    # at width 32 the program's tokens are the reference's to rounding (the
    # mean gap reads 0.0), so the tiny cell holds a tighter limit than the
    # full-width cell's, which routing near-ties set
    wl["correct"].update(sample=4, mean_logit_gap=0.01)
    (dst / "portbench/workloads/tiny.chat.json").write_text(json.dumps(wl))
    real = "mixtral-8x22b.chat"
    bench["workloads"].append(dict(
        next(w for w in bench["workloads"] if w["name"] == real),
        name="tiny.chat", config="tiny-moe"))
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if real in m.get("workloads", []):
                m["workloads"].append("tiny.chat")
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst
