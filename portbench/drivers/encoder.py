"""The system under test for encoder cells: the port's
``EncoderServeEngine`` over ``Runtime.encode`` on the fused backend, set up
as a deployment would be (the float weights calibrated and quantized under
the plan), and what the benchmark hands both it and the reference.

The benchmark makes the float weights and the calibration batches itself,
on the device, from the seed: one ``torch.Generator`` on the card and a
few large draws, in float32 (the configuration's master precision), laid
out as the port's params are. Linear weights are N(0, 1/fan_in), biases
and tables N(0, 0.02^2), norms 1 and 0.
"""
from __future__ import annotations

import dataclasses
import importlib
import itertools
import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.harness import loadgen
from portbench.reference import quant as Q


def make_params(c: dict, n_out: int, seed: int, device) -> dict:
    """The float tree of a BERT encoder with a ``cls`` head."""
    L, D, F = c["num_layers"], c["d_model"], c["d_ff"]
    qd = c["num_heads"] * c["head_dim"]
    if qd != D:
        raise ValueError("the encoder's attention width must be d_model")
    g = torch.Generator(device=device).manual_seed(int(seed))
    f = dict(generator=g, device=device, dtype=torch.float32)
    attn = torch.randn((L, 4, D, D), **f) / math.sqrt(D)
    wi = torch.randn((L, D, F), **f) / math.sqrt(D)
    wo = torch.randn((L, F, D), **f) / math.sqrt(F)
    bias = torch.randn((L, F + D), **f) * 0.02
    tables = torch.randn((c["vocab_size"] + c["max_position"]
                          + c["num_segments"], D), **f) * 0.02
    pool = torch.randn((D, D), **f) / math.sqrt(D)
    out = torch.randn((D, n_out), **f) / math.sqrt(D)
    hb = torch.randn((D + n_out,), **f) * 0.02
    ones = torch.ones((2 * L + 2, D), device=device)
    zeros = torch.zeros((2 * L + 2, D), device=device)

    def norm(i):
        return {"scale": ones[i], "bias": zeros[i]}
    V, P = c["vocab_size"], c["max_position"]
    layers = [{"norm1": norm(2 * i),
               "attn": {n: {"w": attn[i, j]}
                        for j, n in enumerate(("wq", "wk", "wv", "wo"))},
               "norm2": norm(2 * i + 1),
               "ffn": {"wi": {"w": wi[i], "b": bias[i, :F]},
                       "wo": {"w": wo[i], "b": bias[i, F:]}}}
              for i in range(L)]
    return {"embed": {"tok": tables[:V], "pos": tables[V:V + P],
                      "seg": tables[V + P:], "emb_norm": norm(2 * L)},
            "layers": layers, "final_norm": norm(2 * L + 1),
            "head": {"pool": {"w": pool, "b": hb[:D]},
                     "out": {"w": out, "b": hb[D:]}}}


def calibration_batches(c: dict, cal: dict, seed: int, device) -> list:
    """Uniform tokens over the vocabulary, one segment, full length."""
    g = torch.Generator(device=device).manual_seed(int(seed) + 1)
    toks = torch.randint(0, c["vocab_size"], (cal["batches"],
                         cal["batch_size"], cal["seq_len"]), generator=g,
                         device=device, dtype=torch.int32)
    return [{"tokens": t, "segments": torch.zeros_like(t)} for t in toks]


def pow2_upto(n: int, lo: int = 1) -> list[int]:
    out, b = [], lo
    while b < n:
        out.append(b)
        b *= 2
    return out + [b]


class System:
    """One deployment of the program, fed by the load generator."""

    def __init__(self, config: dict, workload: dict, plan_path, seed: int,
                 device, backend: str = "fused"):
        self.config, self.workload = config, workload
        self.c = config["config"]
        self.n_out = int(config["head_classes"])
        self.vocab = self.c["vocab_size"]
        self.plan_path = plan_path
        self.plan = Q.load_plan(plan_path)
        self.seed, self.device = seed, torch.device(device)
        self.backend = backend
        eng = workload["engine"]
        self.max_batch = int(eng["max_batch"])
        self.max_wait = float(eng["max_wait_s"])
        self.max_len = int(eng["max_len"])
        self.passes: list = []      # (start, end, rows, lengths)
        self.live: dict = {}

    # -- set-up --------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.configs import get_config
        from repro_torch.core.plan import PrecisionPlan
        from repro_torch.models import transformer as T
        from repro_torch.quant import ptq
        from repro_torch.serve import EncoderServeEngine

        self.params = make_params(self.c, self.n_out, self.seed, self.device)
        self.batches = calibration_batches(self.c, self.config["calibration"],
                                           self.seed, self.device)
        base = get_config(self.config["program_config"])
        cfg = dataclasses.replace(base, **self.c)
        plan = PrecisionPlan.load(str(self.plan_path))
        want = self.config["plan_fingerprint"]
        if plan.fingerprint() != want:
            raise RuntimeError(f"plan fingerprint {plan.fingerprint()} is "
                               f"not the configuration's {want}")
        float_plan = T.build_plan(
            cfg, PrecisionPlan.full_float(cfg.num_layers, "float32"))
        host = [{k: v.cpu().numpy() for k, v in b.items()}
                for b in self.batches]
        stats = ptq.capture_stats(self.params, host, cfg, float_plan,
                                  precision=plan)
        qparams, qplan = ptq.apply_plan(self.params, cfg, plan, stats,
                                        float_plan=float_plan)
        self.engine = EncoderServeEngine(
            cfg, qparams, qplan, target="cls", backend=self.backend,
            max_batch=self.max_batch, max_wait=self.max_wait,
            max_len=self.max_len, device=self.device)
        self._wrap_encode()
        self.warm()

    def _wrap_encode(self) -> None:
        """A benchmark span around each pass the engine runs."""
        rt = self.engine.runtime
        inner = rt.encode

        def encode(params, inputs, lengths=None):
            t = time.monotonic()
            with record_function("portbench.pass"):
                out = inner(params, inputs, lengths)
            self.passes.append((t, time.monotonic(), len(lengths),
                                np.asarray(lengths).copy()))
            return out
        rt.encode = encode

    def buckets(self) -> list[tuple[int, int]]:
        """Every (rows, length) bucket the cell's traffic can reach."""
        L = self.workload["mix"]["lengths"]
        lens = [b for b in pow2_upto(self.max_len, 8) if b >= L["min"]]
        lens = [b for b in lens if b // 2 < L["max"]]
        return list(itertools.product(pow2_upto(self.max_batch), lens))

    def warm(self) -> None:
        """One pass at every bucket of the cell, so nothing is built or
        first called inside the window."""
        from repro_torch.serve import EncoderRequest
        g = loadgen.rng(self.seed, 9)
        for rows, blen in self.buckets():
            for j in range(rows):
                self.engine.submit(EncoderRequest(
                    uid=-1 - j, tokens=g.integers(1, self.vocab,
                                                  blen).tolist()))
            self.engine.step(force=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.passes.clear()

    # -- serving -------------------------------------------------------
    def submit(self, r: loadgen.Request, now: float) -> None:
        from repro_torch.serve import EncoderRequest
        seg = r.segments.tolist() if r.segments.any() else None
        self.engine.submit(EncoderRequest(uid=r.uid, tokens=r.tokens.tolist(),
                                          segments=seg), now)
        self.live[r.uid] = r

    def step(self, now: float, force: bool = False) -> list:
        out = []
        for er in self.engine.step(now, force=force):
            r = self.live.pop(er.uid)
            r.logits = np.asarray(er.logits, np.float32)
            out.append(r)
        return out

    def bucket_of(self, p) -> tuple[int, int]:
        """The (rows, length) bucket a recorded pass ran at."""
        blen = max(pow2_upto(int(max(p[3])), 8)[-1], 8)
        return pow2_upto(p[2])[-1], min(blen, self.max_len)

    def outstanding(self) -> int:
        return len(self.live)

    def counters(self) -> dict:
        s = self.engine.stats
        return {k: s[k] for k in ("batches", "batched_rows",
                                  "runtime_real_tokens",
                                  "runtime_padded_tokens", "runtime_calls",
                                  "completed", "queue_depth")}

    def release(self) -> None:
        """Drop the program's state; the float weights and batches stay
        for the reference."""
        del self.engine
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correct -------------------------------------------------------
    def reference(self, bits: int = 8):
        ref = importlib.import_module(
            f"portbench.reference.{self.config['reference']}")
        if getattr(self, "_amax", None) is None:
            self._amax = ref.calibrate(self.params, self.c, self.plan,
                                       self.batches)
        return ref, ref.prepare(self.params, self.c, self.plan, self._amax,
                                bits=bits)


def compare(system: System, sample: list, *, bits: int = 8,
            tf32: bool = False, against=None) -> dict:
    """The widest relative gap over ``sample``: max |a - r| / max |r| of
    each request's logits. ``a`` is what the program answered, or, with
    ``bits`` < 8 or ``tf32``, the reference computed at that lower
    precision (the control); ``r`` the reference. ``against`` reuses a
    reference already prepared."""
    ref, model = against or system.reference(8)
    low = None
    if bits != 8 or tf32:
        low = system.reference(bits)[1] if bits != 8 else model
    worst = 0.0
    for r in sample:
        want = ref.logits(model, r.tokens, r.segments).double().cpu()
        got = (torch.from_numpy(r.logits).double() if low is None else
               ref.logits(low, r.tokens, r.segments, tf32=tf32)
               .double().cpu())
        gap = float((got - want).abs().max() / want.abs().max())
        worst = max(worst, gap)
    return {"logit_rel_linf": worst}
