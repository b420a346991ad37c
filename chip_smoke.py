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
* ``span_path``: the same model, weights and requests under the whole-layer
  int8 span, the tiled golden plan passed through ``int8_dataflow_variant``
  (schema v3: ``softmax='uint8'`` + ``norm='int8'`` on layers 0, 3, 4, 7, 8
  and 11), with the same checks, the plan's fingerprint (which must be the
  JAX package's), and the launches per forward with their sub-counts:
  ``quant_flash_attention`` with ``o_scale``, requantizing ``quant_linear``
  and int8-input ``addnorm_quant``;
* ``kernel``: each kernel against its plain version at every shape either
  path gave it, and at the (8, 128) bucket its time, its plain version's and
  a PyTorch library call's where one computes the same function (CUDA
  events, median of 25, L2 flushed), beside its bound: the larger of its
  bytes over 3.35 TB/s and its operations over 1979 TOP/s (int8) or 67
  TFLOP/s (float32);
* ``profile``: ``torch.profiler`` over forwards of each path at the (8, 128)
  bucket: device-busy ms per forward, idle share, ms per forward of each
  ported kernel and the top device kernels.

Then the kernel summary line (per kernel, its sums over one forward of
the span path at (8, 128), and over one forward of each path under
``by_path``) and, last, ``{"ok": true, "device": ...}``. A failed check or a
missing CUDA device exits non-zero before the ok line.
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
# the JAX package's fingerprint of int8_dataflow_variant(golden x 3)
SPAN_FINGERPRINT = ("b93bbe742882640bd8f7f33f32a317dc"
                    "1e33de5a595a6666fb2382e7879cbea8")
# launches per forward each plan implies, with the span's sub-counts
EXPECTED = {
    "main_path": {"quant_linear": 42, "addnorm_quant": 6, "dynamic_quant": 6,
                  "fused_embed": 1},
    "span_path": {"quant_linear": 42, "addnorm_quant": 6, "dynamic_quant": 6,
                  "fused_embed": 1, "quant_flash_attention": 6},
}
EXPECTED_SUB = {"quant_flash_attention with o_scale": 6,
                "quant_linear with out_scale": 12,
                "addnorm_quant with an int8 delta": 6}

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
    "quant_flash_attention": (
        "src/repro_torch/kernels/csrc/quant_flash_attention.cu",
        "src/repro/kernels/flash_attention.py:131"),
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




def setup_model(device):
    """Full-width BERT-base with seeded float weights, the tiled golden
    plan and the calibration batches: what both served paths start from."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import synthetic_calibration_batches
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import transformer as T

    cfg = get_config("bert-base")
    golden = PrecisionPlan.load(str(GOLDEN_PLAN))
    plan = PrecisionPlan(golden.layers * TILE, golden.float_dtype)
    if plan.num_layers != cfg.num_layers:
        fail(f"tiled plan has {plan.num_layers} layers, bert-base "
             f"{cfg.num_layers}")
    t0 = time.perf_counter()
    float_policy = PrecisionPlan.full_float(cfg.num_layers, "float32")
    params = T.init_params(cfg, float_policy, seed=0, head=("cls", 15),
                           device=device)
    batches = synthetic_calibration_batches(cfg, num_batches=2, batch_size=4,
                                            seq_len=128, seed=0)
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    lengths = rng.integers(8, 129, N_REQUESTS)
    requests = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
                for n in lengths]
    return {"cfg": cfg, "plan": plan, "params": params, "batches": batches,
            "float_plan": T.build_plan(cfg, float_policy),
            "requests": requests, "tokens": int(lengths.sum()),
            "init_s": time.perf_counter() - t0}


def serve(engine, requests):
    """Submit every request, run the engine dry; (done by uid, wall s)."""
    from repro_torch.serve import EncoderRequest
    for i, toks in enumerate(requests):
        engine.submit(EncoderRequest(uid=i, tokens=toks))
    t = time.perf_counter()
    done = sorted(engine.run(), key=lambda r: r.uid)
    return done, time.perf_counter() - t


class SubCounts:
    """Counts, over one served run, the fused backend's calls of the span's
    kernel variants (on CUDA tensors every call launches): spies around the
    wrappers the backend module calls, removed on exit."""

    NAMES = ("quant_flash_attention", "quant_linear", "addnorm_quant")

    def __enter__(self):
        import torch
        from repro_torch.kernels import backend as B
        self.B, self.counts = B, collections.Counter()
        self.orig = {n: getattr(B, n) for n in self.NAMES}
        orig, c = self.orig, self.counts

        def flash(*a, **kw):
            c["quant_flash_attention with o_scale"] += \
                kw.get("o_scale") is not None
            return orig["quant_flash_attention"](*a, **kw)

        def linear(*a, **kw):
            c["quant_linear with out_scale"] += kw.get("out_scale") is not None
            return orig["quant_linear"](*a, **kw)

        def addnorm(x, *a, **kw):
            c["addnorm_quant with an int8 delta"] += x.dtype == torch.int8
            return orig["addnorm_quant"](x, *a, **kw)

        B.quant_flash_attention, B.quant_linear, B.addnorm_quant = \
            flash, linear, addnorm
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.B, n, f)


def phase_serve(name, model, plan, device):
    """Calibrate and quantize ``model`` under ``plan``, serve the requests
    on the fused backend (launch counters zeroed just before the counted
    run, read just after) and on the reference backend, and check them."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.quant import ptq
    from repro_torch.serve import EncoderServeEngine

    cfg = model["cfg"]
    t0 = time.perf_counter()
    stats = ptq.capture_stats(model["params"], model["batches"], cfg,
                              model["float_plan"], precision=plan)
    qparams, qplan = ptq.apply_plan(model["params"], cfg, plan, stats,
                                    float_plan=model["float_plan"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    requests = model["requests"]
    fused = EncoderServeEngine(cfg, qparams, qplan, backend="fused",
                               max_batch=8, device=device)
    serve(fused, requests)                         # warm-up, not counted
    calls_before = fused.runtime.stats["calls"]
    with SubCounts() as sub:
        kernels.reset_launches()
        done, wall = serve(fused, requests)
        launches = kernels.launch_counts()
    forwards = fused.runtime.stats["calls"] - calls_before

    reference = EncoderServeEngine(cfg, qparams, qplan, backend="reference",
                                   max_batch=8, device=device)
    ref_done, ref_wall = serve(reference, requests)

    logits = torch.from_numpy(np.stack([r.logits for r in done]))
    ref_logits = torch.from_numpy(np.stack([r.logits for r in ref_done]))
    if logits.shape != (N_REQUESTS, 15) or not torch.isfinite(logits).all():
        fail(f"{name}: fused logits: shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    err = rel_linf(ref_logits, logits)
    preds = [int(r.prediction) for r in done]
    ref_preds = [int(r.prediction) for r in ref_done]
    cases = kernel_cases(cfg, plan)
    per_fwd, sub_fwd = collections.Counter(), collections.Counter()
    for key, case in cases.items():
        per_fwd[key[0]] += case["count"]
        if case["sub"]:
            sub_fwd[case["sub"]] += case["count"]
    want = {k: per_fwd[k] * forwards for k in launches}
    tokens = model["tokens"]
    rec = {"phase": name, "model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "plan": plan.describe(),
           "plan_fingerprint": plan.fingerprint(), "setup_s": setup_s,
           "requests": N_REQUESTS, "tokens": tokens, "forwards": forwards,
           "buckets": fused.runtime.stats["buckets"],
           "wall_s": wall, "requests_per_s": N_REQUESTS / wall,
           "tokens_per_s": tokens / wall, "reference_wall_s": ref_wall,
           "launches": launches, "expected_launches": want,
           "launches_per_forward": dict(per_fwd),
           "sub_counts": dict(sub.counts),
           "sub_counts_per_forward": dict(sub_fwd),
           "fused_vs_reference_rel_linf": err,
           "predictions_equal": preds == ref_preds}
    emit(rec)
    if err > REL_LINF_BUDGET:
        fail(f"{name}: fused vs reference rel-Linf {err} > "
             f"{REL_LINF_BUDGET}")
    if preds != ref_preds:
        fail(f"{name}: fused and reference predictions differ")
    if dict(per_fwd) != EXPECTED[name]:
        fail(f"{name}: the plan implies {dict(per_fwd)} launches per "
             f"forward, not {EXPECTED[name]}")
    if launches != want or any(launches[k] == 0 for k in EXPECTED[name]):
        fail(f"{name}: launch counts {launches} != plan-implied {want}")
    if name == "span_path":
        if plan.fingerprint() != SPAN_FINGERPRINT:
            fail(f"span plan fingerprint {plan.fingerprint()} is not the "
                 f"JAX package's {SPAN_FINGERPRINT}")
        if dict(sub_fwd) != EXPECTED_SUB or dict(sub.counts) != {
                k: n * forwards for k, n in EXPECTED_SUB.items()}:
            fail(f"span sub-counts {dict(sub.counts)} over {forwards} "
                 f"forwards; the plan implies {dict(sub_fwd)} per forward, "
                 f"expected {EXPECTED_SUB}")
    return {"name": name, "qparams": qparams, "fused": fused,
            "launches": launches, "per_fwd": per_fwd, "cases": cases}


def kernel_cases(cfg, plan):
    """The kernel calls one forward of the fused backend makes under
    ``plan``, grouped by shape class and variant, each with its count per
    forward, the layer whose parameters it reads and the span variant it
    is (``sub``, or None)."""
    D, F = cfg.d_model, cfg.d_ff
    cases = collections.OrderedDict()

    def add(key, layer, n=1, sub=None):
        if key not in cases:
            cases[key] = {"layer": layer, "count": 0, "sub": sub}
        cases[key]["count"] += n

    for i, lp in enumerate(plan.layers):
        span = lp.norm == "int8"
        ffn_out_static = lp.ffn_out.quantized and lp.ffn_out.static_acts
        for block, n, K, N, act, path in (
                ("qkv", 3, D, D, None, ("attn", "wq")),
                ("attn_out", 1, D, D, None, ("attn", "wo")),
                ("ffn_in", 1, D, F, "gelu", ("ffn", "wi")),
                ("ffn_out", 1, F, D, None, ("ffn", "wo"))):
            spec = lp.spec(block)
            if not spec.quantized:
                continue
            token = not spec.static_acts
            out = span and (block == "attn_out" or (block == "ffn_in"
                                                    and ffn_out_static))
            add(("quant_linear", K, N, act, token, path, out), i, n,
                "quant_linear with out_scale" if out else None)
            if token:
                add(("dynamic_quant", K), i, n)
        if lp.ffn_in.quantized and lp.ffn_in.static_acts:
            add(("addnorm_quant", D, span), i, 1,
                "addnorm_quant with an int8 delta" if span else None)
        if (lp.softmax == "uint8" and lp.qkv.quantized
                and lp.qkv.static_acts):
            requant = lp.attn_out.quantized and lp.attn_out.static_acts
            add(("quant_flash_attention", requant), i, 1,
                "quant_flash_attention with o_scale" if requant else None)
    add(("fused_embed", D), 0)
    return cases


def _codes(shape, gen, device, std=32.0):
    import torch
    x = torch.randn(shape, generator=gen, device=device) * std
    return torch.clamp(torch.round(x), -128, 127).to(torch.int8)


def run_case(cfg, key, layer, bucket, qparams, device, timer=None):
    """Check one kernel call of shape class ``key`` at a (batch, length)
    bucket against its plain version; with ``timer``, also time kernel,
    plain and library."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import (addnorm_quant, dynamic_quant,
                                     flash_attention, fused_embed,
                                     quant_linear)
    Bb, Sb = bucket
    M = Bb * Sb
    gen = torch.Generator(device=device).manual_seed(M)
    rec = {"phase": "kernel", "kernel": key[0], "bucket": [Bb, Sb], "M": M}
    lp = qparams["layers"][layer]
    lib = None
    aside = None
    if key[0] == "quant_linear":
        _, K, N, act, token, path, out = key
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
        y = quant_linear.quant_linear(*args, **kw)
        y_ref = quant_linear.quant_linear_plain(*args, **kw)
        err = float((y - y_ref).abs().max())
        rel = rel_linf(y_ref, y)
        ok = rel <= 1e-6
        rec.update(K=K, N=N, act=act, per_token_scales=token, out_scale=out,
                   max_abs_err=err, rel_linf=rel,
                   tolerance="float out rel-Linf <= 1e-6; int8 out within "
                             "one code")
        # the requantizing epilogue (int8 out within one code): at the
        # calibrated out_xs where the span gives one
        os_ = (p["out_xs"] if out else torch.tensor(
            float(y_ref.abs().max()) / 127.0, device=device))
        kw_q = dict(kw, out_scale=os_)
        q = quant_linear.quant_linear(*args, **kw_q)
        q_ref = quant_linear.quant_linear_plain(*args, **kw_q)
        code = int((q.to(torch.int32) - q_ref.to(torch.int32)).abs().max())
        rec.update(out_scale_max_code_diff=code)
        ok = ok and code <= 1
        kw_t = kw_q if out else kw
        kern = lambda: quant_linear.quant_linear(*args, **kw_t)       # noqa
        plain = lambda: quant_linear.quant_linear_plain(*args, **kw_t)  # noqa
        nbytes = (M * K + K * N + 4 * N + 4 * (M if token else 1)
                  + (4 * N if b is not None else 0)
                  + (M * N + 4 if out else 4 * M * N))
        t_bytes, t_ops = bound(nbytes, int8_ops=2.0 * M * N * K,
                               f32_ops=(13.0 if act else 3.0) * M * N)
        if M > 16:
            bias = b if b is not None else torch.zeros(N, device=device)

            def lib():
                acc = torch._int_mm(x_q, w.values)
                y = acc.to(torch.float32) * (xs * ws) + bias
                y = Fn.gelu(y, approximate="tanh") if act else y
                if out:
                    return torch.clamp(torch.round(y / os_), -128, 127).to(
                        torch.int8)
                return y
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
        D, int8_in = key[1], key[2]
        if int8_in:
            x = torch.randint(-128, 128, (M, D), generator=gen,
                              device=device, dtype=torch.int8)
            x_in = lp["attn"]["wo"]["out_xs"]
        else:
            x = torch.randn((M, D), generator=gen, device=device)
            x_in = None
        res = torch.randn((M, D), generator=gen, device=device) * 2.0
        bias = torch.zeros(D, device=device)
        gamma = 1.0 + 0.1 * torch.randn(D, generator=gen, device=device)
        beta = 0.1 * torch.randn(D, generator=gen, device=device)
        s = lp["ffn"]["wi"]["xs"]
        args = (x, res, bias, gamma, beta, s)
        kern = lambda: addnorm_quant.addnorm_quant(       # noqa
            *args, x_in_scale=x_in)
        plain = lambda: addnorm_quant.addnorm_quant_plain(  # noqa
            *args, x_in_scale=x_in)
        (h, q), (h_ref, q_ref) = kern(), plain()
        diff = (q.to(torch.int32) - q_ref.to(torch.int32)).abs()
        flipped = float((diff > 0).to(torch.float32).mean())
        err = float((h - h_ref).abs().max())
        ok = (rel_linf(h_ref, h) <= 1e-6 and flipped < 0.005
              and int(diff.max()) <= 1)
        rec.update(D=D, int8_delta=int8_in, max_abs_err=err,
                   h_rel_linf=rel_linf(h_ref, h),
                   q_flipped_share=flipped, q_max_code_diff=int(diff.max()),
                   tolerance="h rel-Linf <= 1e-6; < 0.5% of codes flipped, "
                             "each by <= 1")
        t_bytes, t_ops = bound((1.0 if int8_in else 4.0) * M * D
                               + 9.0 * M * D + 12 * D + 8,
                               f32_ops=16.0 * M * D)

        def lib():
            xf = x.to(torch.float32) * x_in if int8_in else x
            hh = xf + res + bias
            y = Fn.layer_norm(hh, (D,), gamma, beta, eps=1e-6)
            return hh, torch.clamp(torch.round(y / s), -128, 127).to(
                torch.int8)
    elif key[0] == "quant_flash_attention":
        requant = key[1]
        attn = lp["attn"]
        H, Hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q_ = _codes((Bb, H, Sb, d), gen, device)
        k_, v_ = (_codes((Bb, Hkv, Sb, d), gen, device) for _ in range(2))
        lens = torch.randint(1, Sb + 1, (Bb,), generator=gen, device=device)
        idx = torch.arange(Sb, device=device, dtype=torch.int32)
        k_pos = torch.where(idx[None] < lens[:, None], idx[None],
                            -1).to(torch.int32)
        scales = {n: attn[f"{n}_scale"] for n in ("q", "k", "p", "v")}
        kw = {f"{n}_scale": x for n, x in scales.items()}
        args = (q_, k_, v_, k_pos)
        o_scale = attn["wo"]["xs"]
        o = flash_attention.quant_flash_attention(*args, **kw)
        o_ref = flash_attention.quant_flash_attention_plain(*args, **kw)
        oq = flash_attention.quant_flash_attention(*args, **kw,
                                                   o_scale=o_scale)
        oq_ref = flash_attention.quant_flash_attention_plain(
            *args, **kw, o_scale=o_scale)
        err = float((o - o_ref).abs().max())
        diff = (oq.to(torch.int32) - oq_ref.to(torch.int32)).abs()
        share = float((diff > 0).to(torch.float32).mean())
        ok = (rel_linf(o_ref, o) <= REL_LINF_BUDGET and int(diff.max()) <= 1
              and share <= 0.005)
        rec.update(heads=H, head_dim=d, valid_keys=int(lens.sum()),
                   max_abs_err=err, rel_linf=rel_linf(o_ref, o),
                   float_out_exact=err == 0.0,
                   o_scale_max_code_diff=int(diff.max()),
                   o_scale_codes_differing_share=share,
                   tolerance="int8 out within one code on <= 0.5% of "
                             "elements; float out rel-Linf <= 5e-3")
        kw_t = dict(kw, o_scale=o_scale) if requant else kw
        kern = lambda: flash_attention.quant_flash_attention(  # noqa
            *args, **kw_t)
        plain = lambda: flash_attention.quant_flash_attention_plain(  # noqa
            *args, **kw_t)
        n_out, n_kv = Bb * H * Sb * d, Bb * Hkv * Sb * d
        # each input read once, the output written once; the operations
        # this data needs: two int8 products over the valid keys, and
        # about ten float32 operations per valid score (dequantize, mask,
        # max, exp, sum, two divides, round) plus four per output
        pairs = H * Sb * int(lens.sum())
        t_bytes, t_ops = bound(n_out + 2.0 * n_kv + 4.0 * Bb * Sb + 20
                               + (1.0 if requant else 4.0) * n_out,
                               int8_ops=4.0 * pairs * d,
                               f32_ops=10.0 * pairs + 4.0 * n_out)
        # not the same function (a float softmax, no uint8 codes): an aside
        # to set the kernel beside, used nowhere in the port
        qf, kf, vf = (t.to(torch.float32) * scales[n]
                      for t, n in ((q_, "q"), (k_, "k"), (v_, "v")))
        kf, vf = (t.repeat_interleave(H // Hkv, dim=1) for t in (kf, vf))
        mask = (k_pos >= 0)[:, None, None, :]

        def aside():
            return Fn.scaled_dot_product_attention(qf, kf, vf,
                                                   attn_mask=mask, scale=1.0)
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
        if aside is not None:
            rec["sdpa_float_aside_ms"] = timer.ms(aside)
    emit(rec)
    if not ok:
        fail(f"{key[0]} at M={M} disagrees with its plain version: {rec}")
    return rec, (t_bytes, t_ops)


def phase_kernels(cfg, paths, device):
    """Every kernel against its plain version at every shape either path
    gave it (each shape class at each served bucket), timed at the profile
    bucket; returns the per-kernel summary entries: sums over one forward
    of the span path, and of each path under ``by_path``."""
    buckets = set()
    for path in paths:
        buckets |= set(map(tuple, path["fused"].runtime.stats["buckets"]))
    buckets = sorted(buckets | {PROFILE_BUCKET})
    classes = collections.OrderedDict()
    for path in paths:
        for key, case in path["cases"].items():
            classes.setdefault(key, (case["layer"], path["qparams"]))
    timer = Timer(device)
    timed, max_err = {}, collections.defaultdict(float)
    for key, (layer, qparams) in classes.items():
        for bucket in buckets:
            rec, tb = run_case(cfg, key, layer, bucket, qparams, device,
                               timer if bucket == PROFILE_BUCKET else None)
            max_err[key[0]] = max(max_err[key[0]], rec["max_abs_err"])
            if bucket == PROFILE_BUCKET:
                timed[key] = (rec, tb)

    def sums(path, name):
        out = {"launches": path["launches"][name],
               "launches_per_forward": path["per_fwd"][name], "ms": 0.0,
               "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
        t_bytes = t_ops = 0.0
        for key, case in path["cases"].items():
            if key[0] != name:
                continue
            rec, (tb, to) = timed[key]
            n = case["count"]
            for f in ("ms", "plain_ms", "bound_ms"):
                out[f] += n * rec[f]
            t_bytes += n * tb
            t_ops += n * to
            out["library_ms"] = (None if rec["library_ms"] is None
                                 or out["library_ms"] is None
                                 else out["library_ms"]
                                 + n * rec["library_ms"])
        out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        return out

    summary = []
    for name, (src, rep) in KERNELS.items():
        by_path = {p["name"]: sums(p, name) for p in paths
                   if p["per_fwd"][name]}
        span = by_path["span_path"]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep,
                 "launches": sum(b["launches"] for b in by_path.values()),
                 "max_abs_err": max_err[name]}
        entry.update({f: span[f] for f in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "launches_per_forward")})
        entry["by_path"] = by_path
        entry["per"] = (f"one forward at bucket {PROFILE_BUCKET}: the sum "
                        f"over that forward's launches (span path; "
                        f"by_path for each path); launches: the counted "
                        f"runs of both paths")
        summary.append(entry)
    return summary


def phase_profile(model, paths, device):
    """Forwards of each path at the (8, 128) bucket and serving passes of
    the requests, both timed on the host in turns (main, span, span, main,
    twice: one call's host is shared and drifts), then ``torch.profiler`` over
    forwards of each path: device-busy ms, idle share, ms of each ported
    kernel, the top device kernels and the top host ops by self time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    B, S = PROFILE_BUCKET
    rng = np.random.default_rng(1)
    inputs = {"tokens": rng.integers(1, model["cfg"].vocab_size, (B, S),
                                     dtype=np.int32)}
    lengths = np.full((B,), S, np.int32)
    n = 5

    def forwards(path):
        for _ in range(n):
            path["fused"].runtime.encode(path["qparams"], inputs, lengths)

    for path in paths:
        for _ in range(3):
            path["fused"].runtime.encode(path["qparams"], inputs, lengths)
    walls = collections.defaultdict(list)
    rates = collections.defaultdict(list)
    for path in (paths + paths[::-1]) * 2:
        torch.cuda.synchronize()
        t = time.perf_counter()
        forwards(path)
        torch.cuda.synchronize()
        walls[path["name"]].append((time.perf_counter() - t) * 1e3 / n)
        _, wall = serve(path["fused"], model["requests"])
        rates[path["name"]].append(N_REQUESTS / wall)
    for path in paths:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            forwards(path)
            torch.cuda.synchronize()
        by_name, kernels_run = collections.Counter(), 0
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
                kernels_run += 1
        busy = sum(by_name.values()) / n
        if busy <= 0.0:
            fail("the profiler recorded no device time")
        wall_ms = statistics.median(walls[path["name"]])
        ported = {k: sum(v for name, v in by_name.items()
                         if f"{k}_kernel" in name) / n for k in KERNELS}
        top = [{"kernel": name[:100], "ms_per_forward": v / n,
                "share_of_busy": v / n / busy}
               for name, v in by_name.most_common(8)]
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        top_host = [{"op": e.key[:80], "calls_per_forward": e.count / n,
                     "self_ms_per_forward": e.self_cpu_time_total / 1e3 / n}
                    for e in host[:8]]
        emit({"phase": "profile", "path": path["name"],
              "bucket": list(PROFILE_BUCKET), "forward_wall_ms": wall_ms,
              "forward_wall_ms_runs": walls[path["name"]],
              "requests_per_s_runs": rates[path["name"]],
              "device_busy_ms_per_forward": busy,
              "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
              "device_kernels_per_forward": kernels_run / n,
              "ported_kernels_ms_per_forward": ported,
              "top_device_kernels": top, "top_host_ops": top_host})


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
    from repro_torch.core.samp import int8_dataflow_variant
    model = setup_model(device)
    paths = [phase_serve("main_path", model, model["plan"], device),
             phase_serve("span_path", model,
                         int8_dataflow_variant(model["plan"]), device)]
    summary = phase_kernels(model["cfg"], paths, device)
    phase_profile(model, paths, device)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
