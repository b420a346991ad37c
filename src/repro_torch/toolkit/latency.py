"""Latency backends and the analytic H100 roofline model (port of
``repro.toolkit.latency``).

This is the latency axis of the SAMP tradeoff (Table 2, Figure 3), behind a
swappable backend interface in the ``LATENCY_BACKENDS`` registry:

* ``roofline``  — analytic: every GEMM and bandwidth-bound elementwise pass
  of one encoder layer is priced as

      t_op = max(flops / peak_rate(precision), bytes / hbm_bw)

  and summed over the layer inventory given the per-layer SAMP mode (the
  same op inventory as the JAX package's).
* ``wallclock`` — measured: times the forward of each candidate on its
  device, on the compute backend the deployment runs (the fused CUDA
  kernels on the card), as the median of ``reps`` forwards after
  ``warmup`` untimed ones, each between ``torch.cuda.synchronize()``
  calls.

``bind`` returns the ``(qparams, plan, policy) -> seconds`` callable the
search consumes, marked ``analytic = True`` (priced from the plan alone, so
``latency_budget`` may call it before quantizing a candidate) or
``analytic = False`` (needs the quantized params).

Hardware constants: data sheet numbers of the NVIDIA H100 80GB HBM3 (SXM5)
at its 700.00 W limit, dense. float32 is priced at the CUDA cores' 67
TFLOP/s, since the port serves float32 with TF32 off
(:func:`repro_torch.core.device.full_float32`); bfloat16 and float16 at
989.4 TFLOP/s, int8 at 1978.9 TOP/s, HBM3 at 3.35 TB/s.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import full_float32, resolve_device
from repro_torch.core.precision import EncoderPolicy, LayerMode
from repro_torch.kernels.backend import get_backend
from repro_torch.models import transformer as T
from repro_torch.toolkit.registry import register_latency_backend

# H100 SXM5 data sheet (700 W), dense tensor-core rates; float32 without
# TF32 runs on the CUDA cores
PEAK = {"float32": 67e12, "bfloat16": 989.4e12, "float16": 989.4e12,
        "int8": 1978.9e12}
HBM_BW = 3.35e12
BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}

LatencyFn = Callable[[dict, tuple, EncoderPolicy], float]


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    flops: float
    bytes: float
    precision: str

    @property
    def seconds(self) -> float:
        return max(self.flops / PEAK[self.precision], self.bytes / HBM_BW)


def _gemm(name: str, m: int, k: int, n: int, precision: str) -> Op:
    b = BYTES[precision]
    # activations in + weights + activations out (out in same precision for
    # int8 inter-layer dataflow; float otherwise)
    byts = m * k * b + k * n * b + m * n * b
    return Op(name, 2.0 * m * k * n, byts, precision)


def _elementwise(name: str, elems: int, passes: int, precision: str) -> Op:
    return Op(name, elems, passes * elems * BYTES[precision], precision)


def layer_ops(cfg: ArchConfig, mode: LayerMode, batch: int, seq: int,
              float_dtype: str = "bfloat16") -> list[Op]:
    """GEMM + bandwidth inventory of ONE encoder layer under ``mode``."""
    M = batch * seq
    D = cfg.d_model
    mha_p = "int8" if mode.quant_mha else float_dtype
    ffn_p = "int8" if mode.quant_ffn else float_dtype
    ops: list[Op] = []
    # --- MHA group ----------------------------------------------------------
    if cfg.attention != "none":
        ops += [_gemm("wq", M, D, cfg.q_dim, mha_p),
                _gemm("wk", M, D, cfg.kv_dim, mha_p),
                _gemm("wv", M, D, cfg.kv_dim, mha_p),
                _gemm("wo", M, cfg.q_dim, D, mha_p)]
        # batched score/value matmuls: window-bounded if sliding
        kv_len = min(seq, cfg.sliding_window) \
            if cfg.attention == "sliding" else seq
        H, hd = cfg.num_heads, cfg.head_dim
        ops.append(Op("qk^T", 2.0 * batch * H * seq * kv_len * hd,
                      batch * H * seq * kv_len * BYTES[mha_p], mha_p))
        ops.append(Op("pv", 2.0 * batch * H * seq * kv_len * hd,
                      batch * H * seq * kv_len * BYTES[mha_p], mha_p))
        ops.append(_elementwise("softmax", batch * H * seq * kv_len, 3,
                                float_dtype))
    # --- FFN group -----------------------------------------------------------
    d_ff = cfg.d_ff or int(cfg.proj_factor * D) * 2
    n_mats = 3 if cfg.ffn_kind == "glu" else 2
    if cfg.moe is not None:
        # active expert compute per token: top_k routed + shared
        f = cfg.moe.d_ff_expert
        act = cfg.moe.top_k + cfg.moe.num_shared
        ops += [_gemm(f"moe_up[{act}]", M * act, D, f, ffn_p),
                _gemm(f"moe_gate[{act}]", M * act, D, f, ffn_p),
                _gemm(f"moe_down[{act}]", M * act, f, D, ffn_p)]
    elif d_ff:
        for i in range(n_mats - 1):
            ops.append(_gemm(f"ffn_in{i}", M, D, d_ff, ffn_p))
        ops.append(_gemm("ffn_out", M, d_ff, D, ffn_p))
    # --- norms/residuals (always bandwidth-bound, float) ---------------------
    ops.append(_elementwise("norms+residual", M * D, 6, float_dtype))
    return ops


def encoder_latency(cfg: ArchConfig, policy, *, batch: int,
                    seq: int, chips: int = 1) -> float:
    """Modeled seconds for one forward pass of the whole encoder stack.
    ``policy`` is any precision description exposing ``.modes`` and
    ``.float_dtype`` — an ``EncoderPolicy`` or a
    :class:`~repro_torch.core.plan.PrecisionPlan` (priced via its per-layer
    derived modes)."""
    total = 0.0
    for mode in policy.modes:
        for op in layer_ops(cfg, mode, batch, seq, policy.float_dtype):
            total += op.seconds
    return total / chips


def layer_latency(cfg: ArchConfig, mode: LayerMode, *, batch: int, seq: int,
                  float_dtype: str = "bfloat16") -> float:
    return sum(op.seconds
               for op in layer_ops(cfg, mode, batch, seq, float_dtype))


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


class LatencyBackend:
    """A latency source. ``bind`` closes over the measurement point (model
    config, batch geometry, an example batch, the compute backend and the
    device for measured backends) and returns the ``(qparams, plan, policy)
    -> seconds`` callable that :meth:`repro_torch.core.samp.SAMPEngine.search`
    consumes, with its ``analytic`` attribute set."""

    name = "?"

    def bind(self, cfg: ArchConfig, *, batch: int, seq: int,
             example_batch: Optional[dict] = None, scheme=None,
             backend=None, device="cuda") -> LatencyFn:
        raise NotImplementedError


@register_latency_backend("roofline")
class RooflineBackend(LatencyBackend):
    """Analytic roofline estimate; ignores params entirely."""

    name = "roofline"

    def __init__(self, chips: int = 1):
        self.chips = chips

    def bind(self, cfg, *, batch, seq, example_batch=None, scheme=None,
             backend=None, device="cuda") -> LatencyFn:
        def fn(qparams, plan, policy) -> float:
            return encoder_latency(cfg, policy, batch=batch, seq=seq,
                                   chips=self.chips)
        fn.analytic = True
        return fn


@register_latency_backend("wallclock")
class WallclockBackend(LatencyBackend):
    """Measured wall clock of each candidate's forward (final-norm hidden
    states, no head) on the deployment's compute backend and device.
    Building a candidate's callables and the kernels' first launches are
    kept out by ``warmup`` untimed forwards; the median of ``reps`` timed
    forwards is returned, and every timed forward of the last measurement
    of each plan is kept in ``samples`` (plan fingerprint -> sorted
    seconds)."""

    name = "wallclock"

    def __init__(self, reps: int = 5, warmup: int = 1):
        self.reps = reps
        self.warmup = warmup
        self.samples: dict[str, list[float]] = {}

    def bind(self, cfg, *, batch, seq, example_batch=None, scheme=None,
             backend=None, device="cuda") -> LatencyFn:
        device = resolve_device(device)
        scheme = scheme or T.QuantScheme()
        backend = get_backend(backend)
        if example_batch is None:
            gen = torch.Generator(device=device).manual_seed(0)
            example_batch = {"tokens": torch.randint(
                0, cfg.vocab_size, (batch, seq), generator=gen,
                device=device, dtype=torch.int32)}
            if cfg.num_segments:
                example_batch["segments"] = torch.zeros(
                    (batch, seq), dtype=torch.int32, device=device)
        example_batch = {k: (v if torch.is_tensor(v) else
                             torch.from_numpy(np.asarray(v))).to(device)
                         for k, v in example_batch.items()}
        if device.type == "cuda":
            full_float32()          # time the numerics the port serves
            sync = torch.cuda.synchronize
        else:
            def sync():
                pass

        def fn(qparams, plan, policy) -> float:
            def fwd():
                with torch.inference_mode():
                    return T.forward(qparams, example_batch, cfg, plan,
                                     scheme, return_hidden=True,
                                     backend=backend)
            for _ in range(max(self.warmup, 1)):
                fwd()
            sync()
            times = []
            for _ in range(self.reps):
                t0 = time.perf_counter()
                fwd()
                sync()
                times.append(time.perf_counter() - t0)
            times.sort()
            if hasattr(policy, "fingerprint"):
                self.samples[policy.fingerprint()] = times
            return times[len(times) // 2]
        fn.analytic = False
        return fn
