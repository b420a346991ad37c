#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and hold
its CUDA kernels against their plain PyTorch versions.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It prints the card's name and power limit (``nvidia-smi``), then one JSON
line per phase:

* ``build``: compiles ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``
  for ``sm_90a`` (one process per source) and prints the ptxas report;
* ``main_path``: full-width BERT-base (random weights from a seed, a 15-way
  ``cls`` head) under the golden plan tiled 3x to 12 layers: calibrated with
  ``capture_stats``, quantized with ``apply_plan``, and 32 requests served
  through ``EncoderServeEngine(backend="fused")``, with every kernel's launch
  counter zeroed just before and read just after; the same requests through
  ``backend="reference"`` on the card must give identical predictions and
  logits within rel-Linf 5e-3 (the JAX package's fused-vs-reference budget);
* ``kernel``: each kernel against its plain version at every shape the
  main path gave it, and at the (8, 128) bucket its time, its plain
  version's and a PyTorch library call's (CUDA events, median of 25, L2
  flushed), beside its bound: the larger of its bytes over 3.35 TB/s and its
  operations over 1979 TOP/s (int8) or 67 TFLOP/s (float32);
* ``profile``: ``torch.profiler`` over forwards at the (8, 128) bucket:
  device-busy ms per forward, idle share, ms per forward of each ported
  kernel and the top device kernels.

Then the kernel summary line and, last, ``{"ok": true, "device": ...}``.
A failed check or a missing CUDA device exits non-zero before the ok line.
"""
from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN_PLAN = ROOT / "tests" / "data" / "golden_plan.json"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12         # dense int8 tensor-core peak
F32_OPS_PER_S = 67e12            # float32 outside the tensor cores
TILE = 3                         # golden plan (4 layers) x 3 = 12 layers
N_REQUESTS = 32
PROFILE_BUCKET = (8, 128)
REL_LINF_BUDGET = 5e-3

KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "quant_linear": ("src/repro_torch/kernels/csrc/quant_linear.cu",
                     "src/repro/kernels/quant_linear.py:81"),
    "addnorm_quant": ("src/repro_torch/kernels/csrc/addnorm_quant.cu",
                      "src/repro/kernels/addnorm_quant.py:53"),
    "dynamic_quant": ("src/repro_torch/kernels/csrc/dynamic_quant.cu",
                      "src/repro/kernels/dynamic_quant.py:31"),
    "fused_embed": ("src/repro_torch/kernels/csrc/fused_embed.cu",
                    "src/repro/kernels/fused_embed.py:36"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rel_linf(a, b) -> float:
    import torch
    a, b = a.to(torch.float32), b.to(torch.float32)
    return float((a - b).abs().max() / (a.abs().max() + 1e-9))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """Median CUDA-event time of a callable, with the 50 MB L2 flushed
    before each run (a forward streams ~85 MB of int8 weights, so the real
    caller finds them cold)."""

    def __init__(self, device, reps: int = 25):
        import torch
        self.reps = reps
        self.flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)

    def ms(self, fn) -> float:
        import torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(nbytes: float, int8_ops: float = 0.0, f32_ops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int8_ops / INT8_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return t_bytes, t_ops


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import build
    info = build.build()
    emit({"phase": "build", "seconds": info.seconds,
          "compiled": info.compiled,
          "library": str(info.library.relative_to(ROOT)),
          "nvcc_flags": list(build.NVCC_FLAGS), "ptxas": list(info.ptxas)})


def phase_main_path(device):
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import synthetic_calibration_batches
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import transformer as T
    from repro_torch.quant import ptq
    from repro_torch.serve import EncoderRequest, EncoderServeEngine

    cfg = get_config("bert-base")
    golden = PrecisionPlan.load(str(GOLDEN_PLAN))
    plan = PrecisionPlan(golden.layers * TILE, golden.float_dtype)
    if plan.num_layers != cfg.num_layers:
        fail(f"tiled plan has {plan.num_layers} layers, bert-base "
             f"{cfg.num_layers}")
    t0 = time.perf_counter()
    float_policy = PrecisionPlan.full_float(cfg.num_layers, "float32")
    float_plan = T.build_plan(cfg, float_policy)
    params = T.init_params(cfg, float_policy, seed=0, head=("cls", 15),
                           device=device)
    batches = synthetic_calibration_batches(cfg, num_batches=2, batch_size=4,
                                            seq_len=128, seed=0)
    stats = ptq.capture_stats(params, batches, cfg, float_plan,
                              precision=plan)
    qparams, qplan = ptq.apply_plan(params, cfg, plan, stats,
                                    float_plan=float_plan)
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    lengths = rng.integers(8, 129, N_REQUESTS)
    requests = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
                for n in lengths]

    def serve(engine):
        for i, toks in enumerate(requests):
            engine.submit(EncoderRequest(uid=i, tokens=toks))
        t = time.perf_counter()
        done = sorted(engine.run(), key=lambda r: r.uid)
        return done, time.perf_counter() - t

    fused = EncoderServeEngine(cfg, qparams, qplan, backend="fused",
                               max_batch=8, device=device)
    serve(fused)                                   # warm-up, not counted
    calls_before = fused.runtime.stats["calls"]
    kernels.reset_launches()
    done, wall = serve(fused)
    launches = kernels.launch_counts()
    forwards = fused.runtime.stats["calls"] - calls_before

    reference = EncoderServeEngine(cfg, qparams, qplan, backend="reference",
                                   max_batch=8, device=device)
    ref_done, ref_wall = serve(reference)

    logits = torch.from_numpy(np.stack([r.logits for r in done]))
    ref_logits = torch.from_numpy(np.stack([r.logits for r in ref_done]))
    if logits.shape != (N_REQUESTS, 15) or not torch.isfinite(logits).all():
        fail(f"fused logits: shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    err = rel_linf(ref_logits, logits)
    preds = [int(r.prediction) for r in done]
    ref_preds = [int(r.prediction) for r in ref_done]
    per_fwd = collections.Counter()
    for key, case in kernel_cases(cfg, plan).items():
        per_fwd[key[0]] += case["count"]
    want = {k: per_fwd[k] * forwards for k in launches}
    tokens = int(lengths.sum())
    emit({"phase": "main_path", "model": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "plan": plan.describe(),
          "plan_fingerprint": plan.fingerprint(), "setup_s": setup_s,
          "requests": N_REQUESTS, "tokens": tokens, "forwards": forwards,
          "buckets": fused.runtime.stats["buckets"],
          "wall_s": wall, "requests_per_s": N_REQUESTS / wall,
          "tokens_per_s": tokens / wall, "reference_wall_s": ref_wall,
          "launches": launches, "expected_launches": want,
          "launches_per_forward": dict(per_fwd),
          "fused_vs_reference_rel_linf": err,
          "predictions_equal": preds == ref_preds})
    if err > REL_LINF_BUDGET:
        fail(f"fused vs reference rel-Linf {err} > {REL_LINF_BUDGET}")
    if preds != ref_preds:
        fail("fused and reference predictions differ")
    if dict(per_fwd) != {"quant_linear": 42, "addnorm_quant": 6,
                         "dynamic_quant": 6, "fused_embed": 1}:
        fail(f"the tiled golden plan implies {dict(per_fwd)} launches per "
             f"forward, not 42 / 6 / 6 / 1")
    if launches != want or min(launches.values()) == 0:
        fail(f"launch counts {launches} != plan-implied {want}")
    return cfg, plan, qparams, fused, launches, per_fwd


def kernel_cases(cfg, plan):
    """The kernel calls one forward of the fused backend makes under
    ``plan``, grouped by shape class, each with its count per forward and
    the layer whose parameters it reads."""
    D, F = cfg.d_model, cfg.d_ff
    cases = collections.OrderedDict()

    def add(key, layer, n=1):
        if key not in cases:
            cases[key] = {"layer": layer, "count": 0}
        cases[key]["count"] += n

    for i, lp in enumerate(plan.layers):
        for block, n, K, N, act, path in (
                ("qkv", 3, D, D, None, ("attn", "wq")),
                ("attn_out", 1, D, D, None, ("attn", "wo")),
                ("ffn_in", 1, D, F, "gelu", ("ffn", "wi")),
                ("ffn_out", 1, F, D, None, ("ffn", "wo"))):
            spec = lp.spec(block)
            if not spec.quantized:
                continue
            token = not spec.static_acts
            add(("quant_linear", K, N, act, token, path), i, n)
            if token:
                add(("dynamic_quant", K), i, n)
        if lp.ffn_in.quantized and lp.ffn_in.static_acts:
            add(("addnorm_quant", D), i)
    add(("fused_embed", D), 0)
    return cases


def run_case(key, layer, bucket, qparams, device, timer=None):
    """Check one kernel call of shape class ``key`` at a (batch, length)
    bucket against its plain version; with ``timer``, also time kernel,
    plain and library."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import (addnorm_quant, dynamic_quant,
                                     fused_embed, quant_linear)
    Bb, Sb = bucket
    M = Bb * Sb
    gen = torch.Generator(device=device).manual_seed(M)
    rec = {"phase": "kernel", "kernel": key[0], "bucket": [Bb, Sb], "M": M}
    lp = qparams["layers"][layer]
    lib = None
    if key[0] == "quant_linear":
        _, K, N, act, token, path = key
        p = lp[path[0]][path[1]]
        w = p["w"]
        ws = w.scale.reshape(-1).expand(N).contiguous()
        x_q = torch.randint(-128, 128, (M, K), generator=gen, device=device,
                            dtype=torch.int8)
        if token:
            xs = torch.rand((M, 1), generator=gen, device=device) * 0.05 \
                + 1e-3
        else:
            xs = p["xs"]
        b = p.get("b")
        args = (x_q, w.values, ws, xs)
        kw = dict(bias=b, act=act)
        kern = lambda: quant_linear.quant_linear(*args, **kw)       # noqa
        plain = lambda: quant_linear.quant_linear_plain(*args, **kw)  # noqa
        y, y_ref = kern(), plain()
        err = float((y - y_ref).abs().max())
        rel = rel_linf(y_ref, y)
        ok = rel <= 1e-6
        rec.update(K=K, N=N, act=act, per_token_scales=token,
                   max_abs_err=err, rel_linf=rel,
                   tolerance="float out rel-Linf <= 1e-6")
        # the requantizing epilogue (int8 out within one code)
        os_ = torch.tensor(float(y_ref.abs().max()) / 127.0, device=device)
        q, q_ref = (quant_linear.quant_linear(*args, **kw, out_scale=os_),
                    quant_linear.quant_linear_plain(*args, **kw,
                                                    out_scale=os_))
        code = int((q.to(torch.int32) - q_ref.to(torch.int32)).abs().max())
        rec.update(out_scale_max_code_diff=code)
        ok = ok and code <= 1
        nbytes = (M * K + K * N + 4 * N + 4 * (M if token else 1)
                  + (4 * N if b is not None else 0) + 4 * M * N)
        t_bytes, t_ops = bound(nbytes, int8_ops=2.0 * M * N * K,
                               f32_ops=(13.0 if act else 3.0) * M * N)
        if M > 16:
            bias = b if b is not None else torch.zeros(N, device=device)

            def lib():
                acc = torch._int_mm(x_q, w.values)
                out = acc.to(torch.float32) * (xs * ws) + bias
                return Fn.gelu(out, approximate="tanh") if act else out
    elif key[0] == "dynamic_quant":
        K = key[1]
        x = torch.randn((M, K), generator=gen, device=device)
        kern = lambda: dynamic_quant.dynamic_quant(x)               # noqa
        plain = lambda: dynamic_quant.dynamic_quant_plain(x)         # noqa
        (q, s), (q_ref, s_ref) = kern(), plain()
        err = max(float((q.to(torch.int32) - q_ref.to(torch.int32)).abs()
                        .max()), float((s - s_ref).abs().max()))
        ok = err == 0.0
        rec.update(D=K, max_abs_err=err, tolerance="codes and scales exact")
        t_bytes, t_ops = bound(5.0 * M * K + 4 * M, f32_ops=6.0 * M * K)
    elif key[0] == "addnorm_quant":
        D = key[1]
        x = torch.randn((M, D), generator=gen, device=device)
        res = torch.randn((M, D), generator=gen, device=device) * 2.0
        bias = torch.zeros(D, device=device)
        gamma = 1.0 + 0.1 * torch.randn(D, generator=gen, device=device)
        beta = 0.1 * torch.randn(D, generator=gen, device=device)
        s = lp["ffn"]["wi"]["xs"]
        args = (x, res, bias, gamma, beta, s)
        kern = lambda: addnorm_quant.addnorm_quant(*args)            # noqa
        plain = lambda: addnorm_quant.addnorm_quant_plain(*args)      # noqa
        (h, q), (h_ref, q_ref) = kern(), plain()
        diff = (q.to(torch.int32) - q_ref.to(torch.int32)).abs()
        flipped = float((diff > 0).to(torch.float32).mean())
        err = float((h - h_ref).abs().max())
        ok = (rel_linf(h_ref, h) <= 1e-6 and flipped < 0.005
              and int(diff.max()) <= 1)
        rec.update(D=D, max_abs_err=err, h_rel_linf=rel_linf(h_ref, h),
                   q_flipped_share=flipped, q_max_code_diff=int(diff.max()),
                   tolerance="h rel-Linf <= 1e-6; < 0.5% of codes flipped, "
                             "each by <= 1")
        t_bytes, t_ops = bound(13.0 * M * D + 12 * D + 4,
                               f32_ops=16.0 * M * D)

        def lib():
            hh = x + res + bias
            y = Fn.layer_norm(hh, (D,), gamma, beta, eps=1e-6)
            return hh, torch.clamp(torch.round(y / s), -128, 127).to(
                torch.int8)
    else:
        emb = qparams["embed"]
        tok, pos, seg = emb["tok"], emb["pos"], emb["seg"]
        ids = torch.randint(0, tok.shape[0], (M,), generator=gen,
                            device=device, dtype=torch.int32)
        positions = torch.arange(M, device=device, dtype=torch.int32) % Sb
        segs = torch.randint(0, seg.shape[0], (M,), generator=gen,
                             device=device, dtype=torch.int32)
        args = (ids, tok, pos, seg, segs)
        kern = lambda: fused_embed.fused_embed(*args,                # noqa
                                               positions=positions)
        plain = lambda: fused_embed.fused_embed_plain(*args,         # noqa
                                                      positions=positions)
        err = float((kern() - plain()).abs().max())
        ok = err == 0.0
        rows = (int(torch.unique(ids).numel())
                + int(torch.unique(positions).numel())
                + int(torch.unique(segs).numel()))
        rec.update(D=key[1], max_abs_err=err, distinct_rows=rows,
                   tolerance="exact")
        t_bytes, t_ops = bound(12.0 * M + 4.0 * key[1] * (rows + M),
                               f32_ops=2.0 * M * key[1])
        lib_ids = (ids.long(), positions.long(), segs.long())

        def lib():
            return (Fn.embedding(lib_ids[0], tok)
                    + Fn.embedding(lib_ids[1], pos)
                    + Fn.embedding(lib_ids[2], seg))
    torch.cuda.synchronize()
    rec["bound_ms"] = max(t_bytes, t_ops)
    rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    if timer is not None:
        rec["ms"] = timer.ms(kern)
        rec["plain_ms"] = timer.ms(plain)
        rec["library_ms"] = timer.ms(lib) if lib is not None else None
    emit(rec)
    if not ok:
        fail(f"{key[0]} at M={M} disagrees with its plain version: {rec}")
    return rec, (t_bytes, t_ops)


def phase_kernels(cfg, plan, qparams, fused, launches, per_fwd, device):
    """Every kernel against its plain version at every shape the main path
    gave it (each shape class at each served bucket), timed at the profile
    bucket; returns the per-kernel summary entries."""
    cases = kernel_cases(cfg, plan)
    buckets = sorted(set(map(tuple, fused.runtime.stats["buckets"]))
                     | {PROFILE_BUCKET})
    timer = Timer(device)
    summary = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "launches": launches[name],
                      "launches_per_forward": per_fwd[name],
                      "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "library_ms": 0.0,
                      "t_bytes": 0.0, "t_ops": 0.0}
               for name, (src, rep) in KERNELS.items()}
    for key, case in cases.items():
        for bucket in buckets:
            timed = bucket == PROFILE_BUCKET
            rec, (t_bytes, t_ops) = run_case(
                key, case["layer"], bucket, qparams, device,
                timer if timed else None)
            s = summary[key[0]]
            s["max_abs_err"] = max(s["max_abs_err"], rec["max_abs_err"])
            if timed:
                n = case["count"]
                s["ms"] += n * rec["ms"]
                s["plain_ms"] += n * rec["plain_ms"]
                s["bound_ms"] += n * rec["bound_ms"]
                s["t_bytes"] += n * t_bytes
                s["t_ops"] += n * t_ops
                s["library_ms"] = (None if rec["library_ms"] is None
                                   or s["library_ms"] is None
                                   else s["library_ms"] + n * rec["library_ms"])
    out = []
    for s in summary.values():
        s["bound_by"] = "bytes" if s.pop("t_bytes") >= s.pop("t_ops") \
            else "operations"
        s["per"] = (f"one forward at bucket {PROFILE_BUCKET}: the sum over "
                    f"that forward's launches")
        out.append(s)
    return out


def phase_profile(fused, qparams, device):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    B, S = PROFILE_BUCKET
    rng = np.random.default_rng(1)
    inputs = {"tokens": rng.integers(1, fused.cfg.vocab_size, (B, S),
                                     dtype=np.int32)}
    lengths = np.full((B,), S, np.int32)
    rt = fused.runtime
    for _ in range(3):
        rt.encode(qparams, inputs, lengths)
    n = 5
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        rt.encode(qparams, inputs, lengths)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            rt.encode(qparams, inputs, lengths)
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values()) / n
    if busy <= 0.0:
        fail("the profiler recorded no device time")
    ported = {k: sum(v for name, v in by_name.items()
                     if f"{k}_kernel" in name) / n for k in KERNELS}
    top = [{"kernel": name[:100], "ms_per_forward": v / n,
            "share_of_busy": v / n / busy}
           for name, v in by_name.most_common(8)]
    emit({"phase": "profile", "bucket": list(PROFILE_BUCKET),
          "forward_wall_ms": wall_ms, "device_busy_ms_per_forward": busy,
          "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
          "ported_kernels_ms_per_forward": ported,
          "top_device_kernels": top})


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} holds no src/repro_torch: run from a checkout of the "
             f"repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device = torch.device("cuda", 0)
    phase_build()
    cfg, plan, qparams, fused, launches, per_fwd = phase_main_path(device)
    summary = phase_kernels(cfg, plan, qparams, fused, launches, per_fwd,
                            device)
    phase_profile(fused, qparams, device)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
