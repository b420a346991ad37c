"""Rates, percentiles and the rule for requests that never answer, with
the roofline and MFU arithmetic against shapes worked by hand."""
from pathlib import Path

import pytest

from portbench.harness import flops, loadgen, stats
from portbench.reference import quant as Q

SPAN = Path(__file__).resolve().parents[1] / "plans/bert-base.span.json"


def req(due, done):
    r = loadgen.Request(0, [1], [0])
    r.due, r.done = due, done
    return r


@pytest.mark.parametrize("q,want", [(50, 50), (95, 95), (99, 99),
                                    (100, 100), (1, 1)])
def test_percentile_is_the_nearest_rank(q, want):
    assert stats.percentile(list(range(100, 0, -1)), q) == want


def test_percentile_of_an_empty_sample_is_refused():
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_and_completions_in_the_window():
    done = [0.5, 1.0, 9.99, 10.0, None, 12.0]
    assert stats.completed_in(done, 0.0, 10.0) == 3
    assert stats.rate(3, 10.0) == 0.3
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_an_unanswered_request_counts_at_its_age_and_as_failed():
    # a stall inside the window: three requests wait on it, one never
    # answers before the deadline, one answers after it
    reqs = [req(0.0, 0.01), req(1.0, 3.0), req(1.5, 3.0), req(2.0, None),
            req(2.5, 70.0)]
    lat, failed = stats.latencies(reqs, deadline=62.0)
    assert failed == 2
    assert lat == pytest.approx([0.01, 2.0, 1.5, 60.0, 59.5])
    assert stats.percentile(lat, 95) == pytest.approx(60.0)


def test_gemm_bound_by_hand():
    # 2 * 4096 * 768 * 768 = 4.83e9 ops: 2.44 us at 1978.9 TOP/s; bytes
    # 4096*768 + 768*768 + 4*768 + 4*4096*768 = 16.3 MB: 4.87 us at 3.35 TB/s
    t = flops.gemm_bound_s(4096, 768, 768)
    nbytes = 4096 * 768 + 768 * 768 + 4 * 768 + 4 * 4096 * 768
    assert t == pytest.approx(nbytes / 3.35e12)
    assert nbytes / 3.35e12 > 2 * 4096 * 768 * 768 / 1978.9e12
    # compute-bound when the output is int8 and M is large
    big = flops.gemm_bound_s(65536, 3072, 3072, out_bytes=1)
    assert big == pytest.approx(2 * 65536 * 3072 ** 2 / 1978.9e12)


def test_the_span_plan_has_the_ports_42_quant_linear_calls():
    plan = Q.load_plan(SPAN)
    cfg = {"d_model": 768, "d_ff": 3072, "num_heads": 12, "head_dim": 64}
    calls = flops.encoder_gemms(cfg, plan)
    assert len(calls) == 42
    assert sum(1 for c in calls if c[2] == 1) == 12     # requantized out
    assert sum(1 for c in calls if c[3]) == 6           # per-token rows


def test_request_bound_of_a_float_layer_by_hand():
    float_layer = {b: dict(Q.FLOAT) for b in Q.BLOCKS}
    float_layer.update(norm="float", softmax="float", kv_cache="float")
    cfg = {"d_model": 8, "d_ff": 16, "num_heads": 2, "head_dim": 4}
    n = 10
    ops = (2 * n * 8 * 8 * 3 + 2 * 2 * n * n * 8 + 2 * n * 8 * 8
           + 2 * n * 8 * 16 * 2)
    head = 2 * (8 * 8 + 8 * 3)
    assert flops.encoder_request_bound_s(cfg, [float_layer], n, 3) == \
        pytest.approx((ops + head) / 66.9e12)
