"""The benchmark's plain reference against the port's own reference
backend, at tiny widths on the CPU: the same calibration statistics, the
same logits to float rounding, and the control (one precision lower) far
from both."""
import dataclasses
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.drivers import encoder
from portbench.reference import bert, quant as Q
from portbench.tests.tiny_tree import TINY

PLAN = Path(__file__).resolve().parents[1] / "plans/bert-base.span.json"
CAL = {"batches": 2, "batch_size": 2, "seq_len": 48}


@pytest.fixture(scope="module")
def tiny():
    from repro_torch.configs import get_config
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import transformer as T
    from repro_torch.quant import ptq
    cfg = dataclasses.replace(get_config("bert-base"), **TINY)
    full = PrecisionPlan.load(str(PLAN))
    plan = PrecisionPlan(full.layers[:4], full.float_dtype)
    params = encoder.make_params(TINY, 5, 2 ** 31 + 7, "cpu")
    batches = encoder.calibration_batches(TINY, CAL, 2 ** 31 + 7, "cpu")
    float_plan = T.build_plan(cfg, PrecisionPlan.full_float(4, "float32"))
    stats = ptq.capture_stats(params, [{k: v.numpy() for k, v in b.items()}
                                       for b in batches],
                              cfg, float_plan, precision=plan)
    qparams, qplan = ptq.apply_plan(params, cfg, plan, stats,
                                    float_plan=float_plan)
    ref_plan = Q.load_plan(PLAN)[:4]
    return dict(cfg=cfg, params=params, batches=batches, stats=stats,
                qparams=qparams, qplan=qplan, plan=ref_plan)


def test_calibration_matches_the_port(tiny):
    amax = bert.calibrate(tiny["params"], TINY, tiny["plan"],
                          tiny["batches"])
    for i in range(4):
        port = tiny["stats"][f"layer{i}"]
        for site, a in amax[i].items():
            assert a == pytest.approx(port[site], rel=1e-5), (i, site)


def test_reference_logits_match_the_ports_reference_backend(tiny):
    from repro_torch.serve.runtime import Runtime
    from repro_torch.toolkit.targets import get_target
    target = get_target("cls")
    rt = Runtime(tiny["cfg"], tiny["qplan"], backend="reference",
                 device="cpu", max_len=64,
                 head=lambda p, h: target.apply(p, h, tiny["cfg"]))
    amax = bert.calibrate(tiny["params"], TINY, tiny["plan"],
                          tiny["batches"])
    model = bert.prepare(tiny["params"], TINY, tiny["plan"], amax)
    low = bert.prepare(tiny["params"], TINY, tiny["plan"], amax, bits=4)
    rng = np.random.default_rng(3)
    gaps, ctrl = [], []
    for n in (5, 9, 17, 30, 33, 48, 64, 12):
        toks = rng.integers(1, 97, n)
        segs = np.zeros(n, np.int64)
        segs[n // 2:] = n % 2
        port = rt.encode(tiny["qparams"], {"tokens": toks[None],
                                           "segments": segs[None]})[0]
        want = bert.logits(model, toks, segs).double().numpy()
        got4 = bert.logits(low, toks, segs).double().numpy()
        scale = np.abs(want).max()
        gaps.append(np.abs(port - want).max() / scale)
        ctrl.append(np.abs(got4 - want).max() / scale)
    # ties may flip an int8 code (reference sums in another order), so one
    # request may move by a few percent; most agree to float rounding
    assert statistics.median(gaps) < 1e-4
    assert max(gaps) < 5e-2
    assert min(ctrl) > 10 * statistics.median(gaps)
    assert statistics.median(ctrl) > 0.1


def test_decoder_reference_matches_the_ports_calibration_and_tokens():
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import transformer as T
    from repro_torch.quant import ptq
    from repro_torch.serve.engine import Request, ServeEngine
    from portbench.drivers import decoder
    from portbench.reference import mixtral
    from portbench.tests.tiny_tree import TINY_MOE
    plan_path = PLAN.parent / "mixtral-8x22b.v4-first2.json"
    cfg = decoder.program_config({"program_config": "mixtral-8x22b",
                                  "config": TINY_MOE})
    plan = PrecisionPlan.load(str(plan_path))
    seed = 2 ** 31 + 11
    params = decoder.make_params(TINY_MOE, seed, "cpu")
    batches = decoder.calibration_batches(
        TINY_MOE, {"batches": 2, "batch_size": 2, "seq_len": 16}, seed,
        "cpu")
    float_plan = T.build_plan(cfg, PrecisionPlan.full_float(2, "float32"))
    stats = ptq.capture_stats(params, [{"tokens": b["tokens"].numpy()}
                                       for b in batches], cfg, float_plan,
                              precision=plan)
    ref_plan = Q.load_plan(plan_path)
    amax = mixtral.calibrate(params, TINY_MOE, ref_plan, batches)
    for i in range(2):
        for site, a in amax[i].items():
            np.testing.assert_allclose(a, stats[f"layer{i}"][site],
                                       rtol=1e-5, err_msg=f"{i} {site}")
    qparams, qplan = ptq.apply_plan(params, cfg, plan, stats,
                                    float_plan=float_plan)
    eng = ServeEngine(cfg, qparams, qplan, precision=plan, batch_slots=3,
                      max_len=40, backend="reference", device="cpu")
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, prompt=rng.integers(1, 101, n).tolist(),
                    max_tokens=m) for i, (n, m) in
            enumerate([(7, 9), (12, 5), (3, 14), (9, 8)])]
    for r in reqs:
        eng.submit(r)
    eng.run()
    model = mixtral.prepare(params, TINY_MOE, ref_plan, amax)
    low = mixtral.prepare(params, TINY_MOE, ref_plan, amax, bits=4)
    gaps, ctrl = [], []
    for r in reqs:
        seq = np.asarray(r.prompt + r.output[:-1])
        want = mixtral.logits(model, seq)[len(r.prompt) - 1:]
        best = want.max(dim=-1).values
        served = want.gather(1, torch.tensor(r.output)[:, None])[:, 0]
        gaps.append(best - served)
        pick = mixtral.logits(low, seq)[len(r.prompt) - 1:].argmax(-1)
        ctrl.append(best - want.gather(1, pick[:, None])[:, 0])
    gaps, ctrl = torch.cat(gaps), torch.cat(ctrl)
    # every served token is the reference's best; the control (4 bits)
    # picks another token at a share of the positions
    assert float(gaps.max()) < 1e-3
    assert float((gaps > 0).float().mean()) == 0.0
    assert float((ctrl > 0).float().mean()) > 0.1, ctrl
