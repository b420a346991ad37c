"""Accuracy-decay-aware allocation — the paper's Algorithm 1 plus the
Appendix-A threshold modes (port of ``repro.core.allocator``, whole: pure
Python, copied so the port imports nothing of the JAX package).

Inputs are parallel arrays indexed by candidate i (i = number of quantized
layers in the paper's grid; any candidate list works):

* ``accuracy[i]`` — task metric on the dev set for candidate i
* ``latency[i]``  — inference latency for candidate i (seconds, or any
                    monotone latency proxy — the roofline-model estimate, or
                    the wall clock of the forward on the card)

Candidate 0 MUST be the float (Fully-FP16/bf16) baseline, matching the
paper's ``A_fp16 = A_0, L_fp16 = L_0`` initialization.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Recommendation:
    index: int              # chosen candidate index (paper's returned L)
    accuracy: float
    latency: float
    speedup: float          # latency[0] / latency[index]
    accuracy_drop: float    # accuracy[0] - accuracy[index]


def _validate(accuracy: Sequence[float], latency: Sequence[float]) -> None:
    if len(accuracy) != len(latency):
        raise ValueError("accuracy and latency must be parallel arrays")
    if len(accuracy) == 0:
        raise ValueError("empty candidate list")
    if any(l <= 0 for l in latency):
        raise ValueError("latencies must be positive")


def accuracy_decay_aware(accuracy: Sequence[float],
                         latency: Sequence[float]) -> Recommendation:
    """Paper Algorithm 1, verbatim semantics.

    Walk candidates i = 0..N. Relative to the last *accepted* point
    (A_rec, L_rec), compute the decay rate

        dr = (A_i - A_rec) / (L_i - L_rec)

    Quantizing more layers lowers latency (L_i < L_rec) and usually lowers
    accuracy (A_i < A_rec), so dr is typically positive: accuracy lost per
    second saved. Accept candidate i when dr < 0 (accuracy improved — free
    win) or dr < dr_min (cheapest decay so far), updating (A_rec, L_rec) and
    the running dr_min. Return the last accepted index.
    """
    _validate(accuracy, latency)
    dr_min = math.inf
    a_rec, l_rec = accuracy[0], latency[0]
    chosen = 0
    for i in range(1, len(accuracy)):
        dl = latency[i] - l_rec
        if dl == 0:
            # Same latency: accept only a strict accuracy improvement.
            if accuracy[i] > a_rec:
                a_rec, chosen = accuracy[i], i
            continue
        dr = (accuracy[i] - a_rec) / dl
        if dr < 0 or dr < dr_min:
            dr_min = dr
            a_rec, l_rec = accuracy[i], latency[i]
            chosen = i
    return Recommendation(
        index=chosen, accuracy=accuracy[chosen], latency=latency[chosen],
        speedup=latency[0] / latency[chosen],
        accuracy_drop=accuracy[0] - accuracy[chosen])


def under_latency_ceiling(accuracy: Sequence[float], latency: Sequence[float],
                          max_latency: float) -> Recommendation:
    """Appendix A: 'If highest time cost threshold is set, SAMP will recommend
    the setting with the highest accuracy whose time cost is lower than the
    threshold.' Falls back to the fastest candidate if none qualifies."""
    _validate(accuracy, latency)
    feasible = [i for i in range(len(latency)) if latency[i] <= max_latency]
    if not feasible:
        i = min(range(len(latency)), key=lambda j: latency[j])
    else:
        i = max(feasible, key=lambda j: (accuracy[j], -latency[j]))
    return Recommendation(i, accuracy[i], latency[i],
                          latency[0] / latency[i], accuracy[0] - accuracy[i])


def above_accuracy_floor(accuracy: Sequence[float], latency: Sequence[float],
                         min_accuracy: float) -> Recommendation:
    """Appendix A: 'If the lowest accuracy threshold is set, SAMP will
    recommend the setting with the lowest time cost whose accuracy is higher
    than the threshold.' Falls back to the most accurate candidate."""
    _validate(accuracy, latency)
    feasible = [i for i in range(len(accuracy)) if accuracy[i] >= min_accuracy]
    if not feasible:
        i = max(range(len(accuracy)), key=lambda j: accuracy[j])
    else:
        i = min(feasible, key=lambda j: (latency[j], -accuracy[j]))
    return Recommendation(i, accuracy[i], latency[i],
                          latency[0] / latency[i], accuracy[0] - accuracy[i])


def top_k_by_efficiency(accuracy: Sequence[float], latency: Sequence[float],
                        k: int = 5) -> list[Recommendation]:
    """Appendix A: 'If neither is set, SAMP will recommend top-5 appropriate
    settings based on the ratio of speedup / accuracy-loss.'"""
    _validate(accuracy, latency)
    base_a, base_l = accuracy[0], latency[0]

    def ratio(i: int) -> float:
        speedup = base_l / latency[i]
        loss = max(base_a - accuracy[i], 1e-9)   # avoid /0 on no-loss configs
        return speedup / loss

    order = sorted(range(1, len(accuracy)), key=ratio, reverse=True)[:k]
    return [Recommendation(i, accuracy[i], latency[i], base_l / latency[i],
                           base_a - accuracy[i]) for i in order]


def recommend(accuracy: Sequence[float], latency: Sequence[float],
              max_latency: float | None = None,
              min_accuracy: float | None = None):
    """SAMP's front door: dispatch to the right policy given user thresholds
    (Appendix A), or Algorithm 1 when the user 'cannot directly give clear
    requirements' (§3.2)."""
    if max_latency is not None and min_accuracy is not None:
        rec = under_latency_ceiling(accuracy, latency, max_latency)
        if rec.accuracy >= min_accuracy:
            return rec
        return above_accuracy_floor(accuracy, latency, min_accuracy)
    if max_latency is not None:
        return under_latency_ceiling(accuracy, latency, max_latency)
    if min_accuracy is not None:
        return above_accuracy_floor(accuracy, latency, min_accuracy)
    return accuracy_decay_aware(accuracy, latency)


# ---------------------------------------------------------------------------
# Beyond-paper: arbitrary-subset greedy allocation.
# The paper only searches prefix-k policies. Layers are not equally
# quantization-sensitive, so choosing *which* layers (not just how many)
# dominates the prefix policy at equal latency. Greedy: repeatedly quantize
# the layer with the smallest measured per-layer accuracy cost.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SubsetStep:
    layers: tuple[int, ...]
    accuracy: float
    latency: float


def greedy_subset_schedule(
        per_layer_accuracy: Sequence[float],
        base_accuracy: float,
        per_layer_latency_gain: Sequence[float],
        base_latency: float) -> list[SubsetStep]:
    """Build a quantization order from single-layer probes.

    ``per_layer_accuracy[j]`` = dev accuracy with ONLY layer j quantized;
    ``per_layer_latency_gain[j]`` = latency saved by quantizing layer j.
    Returns the greedy schedule: step t quantizes the t cheapest layers by
    measured accuracy cost (additivity assumption, validated in tests).
    The schedule's (accuracy, latency) arrays feed ``recommend`` unchanged.
    """
    n = len(per_layer_accuracy)
    if n != len(per_layer_latency_gain):
        raise ValueError("parallel per-layer arrays required")
    costs = [base_accuracy - a for a in per_layer_accuracy]
    order = sorted(range(n), key=lambda j: costs[j])
    steps: list[SubsetStep] = [SubsetStep((), base_accuracy, base_latency)]
    acc, lat, chosen = base_accuracy, base_latency, []
    for j in order:
        chosen.append(j)
        acc -= costs[j]
        lat -= per_layer_latency_gain[j]
        steps.append(SubsetStep(tuple(sorted(chosen)), acc, max(lat, 1e-9)))
    return steps
