"""The system under test for decode cells: the port's ``ServeEngine``
(continuous batching, one token a live slot a tick, prompts fed a token a
tick) over ``Runtime.decode_fn`` on the fused backend, set up as a
deployment would be: the float weights calibrated and quantized under the
plan.

The benchmark makes the float weights and calibration batches itself, on
the device, from the seed, in a few large draws in float32, laid out as the
port's params are: linears N(0, 1/fan_in) (the experts' stacks and the
router too), the token table N(0, 0.02^2), norms 1.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.harness import loadgen
from portbench.reference import quant as Q


def make_params(c: dict, seed: int, device) -> dict:
    """The float tree of a Mixtral decoder (every layer an MoE layer)."""
    L, D, V = c["num_layers"], c["d_model"], c["vocab_size"]
    qd = c["num_heads"] * c["head_dim"]
    kvd = c["num_kv_heads"] * c["head_dim"]
    E, Fe = c["moe"]["num_experts"], c["moe"]["d_ff_expert"]
    g = torch.Generator(device=device).manual_seed(int(seed))

    def draw(shape, std):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float32).mul_(std)
    wq, wk, wv = (draw((L, D, n), 1 / math.sqrt(D)) for n in (qd, kvd, kvd))
    wo = draw((L, qd, D), 1 / math.sqrt(qd))
    router = draw((L, D, E), 1 / math.sqrt(D))
    wg, wu = (draw((L, E, D, Fe), 1 / math.sqrt(D)) for _ in range(2))
    wd = draw((L, E, Fe, D), 1 / math.sqrt(Fe))
    tok = draw((V, D), 0.02)
    head = draw((D, V), 1 / math.sqrt(D))
    ones = torch.ones((2 * L + 1, D), device=device)
    layers = [{"norm1": {"scale": ones[2 * i]},
               "attn": {"wq": {"w": wq[i]}, "wk": {"w": wk[i]},
                        "wv": {"w": wv[i]}, "wo": {"w": wo[i]}},
               "norm2": {"scale": ones[2 * i + 1]},
               "ffn": {"router": {"w": router[i]}, "wg": {"w": wg[i]},
                       "wu": {"w": wu[i]}, "wd": {"w": wd[i]}}}
              for i in range(L)]
    return {"embed": {"tok": tok}, "layers": layers,
            "final_norm": {"scale": ones[2 * L]}, "lm_head": {"w": head}}


def calibration_batches(c: dict, cal: dict, seed: int, device) -> list:
    g = torch.Generator(device=device).manual_seed(int(seed) + 1)
    toks = torch.randint(0, c["vocab_size"], (cal["batches"],
                         cal["batch_size"], cal["seq_len"]), generator=g,
                         device=device, dtype=torch.int32)
    return [{"tokens": t} for t in toks]


def program_config(config: dict):
    """The port's ArchConfig with the configuration's sizes (nested
    groups, such as ``moe``, replaced field by field)."""
    from repro_torch.configs import get_config
    base = get_config(config["program_config"])
    kw = {}
    for k, v in config["config"].items():
        cur = getattr(base, k)
        kw[k] = (dataclasses.replace(cur, **v)
                 if dataclasses.is_dataclass(cur) else v)
    return dataclasses.replace(base, **kw)


class System:
    """One deployment of the program, fed by the load generator."""

    max_wait = 0.0

    def __init__(self, config: dict, workload: dict, plan_path, seed: int,
                 device, backend: str = "fused"):
        self.config, self.workload = config, workload
        self.c = config["config"]
        self.vocab = self.c["vocab_size"]
        self.plan_path = plan_path
        self.plan = Q.load_plan(plan_path)
        self.seed, self.device = seed, torch.device(device)
        self.backend = backend
        eng = workload["engine"]
        self.slots = int(eng["slots"])
        self.max_len = int(eng["max_len"])
        # a tick is this cell's pass: (start, end, live slots, positions)
        self.passes: list = []
        self.live: dict = {}
        self.generated: list = []   # (tick end, tokens generated)

    def setup(self) -> None:
        from repro_torch.core.plan import PrecisionPlan
        from repro_torch.models import transformer as T
        from repro_torch.quant import ptq
        from repro_torch.serve import ServeEngine

        self.params = make_params(self.c, self.seed, self.device)
        self.batches = calibration_batches(self.c, self.config["calibration"],
                                           self.seed, self.device)
        cfg = program_config(self.config)
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
        self.engine = ServeEngine(cfg, qparams, qplan, precision=plan,
                                  batch_slots=self.slots,
                                  max_len=self.max_len, backend=self.backend,
                                  device=self.device)
        self.warm()

    def warm(self) -> None:
        """Every slot live for a few ticks: the one shape the cell runs."""
        from repro_torch.serve.engine import Request as EngineRequest
        g = loadgen.rng(self.seed, 9)
        for j in range(self.slots):
            self.engine.submit(EngineRequest(
                uid=-1 - j, prompt=g.integers(1, self.vocab, 2).tolist(),
                max_tokens=2))
        self.engine.run()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- serving -------------------------------------------------------
    def submit(self, r: loadgen.Request, now: float) -> None:
        from repro_torch.serve.engine import Request as EngineRequest
        er = EngineRequest(uid=r.uid, prompt=r.tokens.tolist(),
                           max_tokens=r.max_tokens)
        self.engine.submit(er)
        r.output = er.output
        self.live[r.uid] = r

    def step(self, now: float, force: bool = False) -> list:
        """One tick. What it did is read from the engine: the tokens each
        request generated (the growth of its ``output``) and the position
        each slot fed (its cursor, less one, in the slots that ran: a slot
        that stalled holds its cursor)."""
        sched = self.engine.sched
        had = {uid: len(r.output) for uid, r in self.live.items()}
        held = [id(a) for a in sched.active]
        cur = sched.cursor.copy()
        before = self.engine.stats["tokens"]
        t = time.monotonic()
        with record_function("portbench.pass"):
            retired = self.engine.step()
        done = time.monotonic()
        gone = {id(er) for er in retired}

        def ran_in(s):
            a = sched.active[s]
            if a is None:
                return held[s] in gone
            if id(a) == held[s]:
                return sched.cursor[s] > cur[s]
            return sched.cursor[s] > 0      # admitted this tick
        ran = [s for s in range(self.slots) if ran_in(s)]
        if len(ran) != self.engine.stats["tokens"] - before:
            raise RuntimeError("the slots that ran are not the engine's "
                               "count of tokens fed")
        pos = np.array([int(sched.cursor[s]) - 1 for s in ran], np.int64)
        self.passes.append((t, done, len(ran), pos))
        made = 0
        for r in self.live.values():
            made += len(r.output) - had[r.uid]
            if r.output and r.first_token is None:
                r.first_token = done
        self.generated.append((done, made))
        return [self.live.pop(er.uid) for er in retired]

    def outstanding(self) -> int:
        return len(self.live)

    def counters(self) -> dict:
        s = self.engine.stats
        return {k: s[k] for k in ("ticks", "tokens", "retired",
                                  "occupancy", "queue_depth")}

    def release(self) -> None:
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
    """Every generated token of ``sample`` against the reference, run once
    over each prompt and its served tokens: the share of served tokens
    that are not the reference's best (``token_mismatch_share``, %), and
    the widest gap by which a served token's logit lies below the
    reference's best (``logit_gap``), and that gap's mean over the served
    tokens (``mean_logit_gap``). With ``bits`` < 8 or ``tf32`` the
    reference at that lower precision (the control) stands in the
    program's place: its first token at each position is read instead."""
    ref, model = against or system.reference(8)
    low = None
    if bits != 8 or tf32:
        low = system.reference(bits)[1] if bits != 8 else model
    worst, missed, total, summed = 0.0, 0, 0, 0.0
    for r in sample:
        out = list(r.output)
        seq = np.concatenate([r.tokens, np.asarray(out[:-1], np.int64)])
        n = len(r.tokens)
        want = ref.logits(model, seq)[n - 1:]
        if low is None:
            pick = torch.as_tensor(out, device=want.device)
        else:
            pick = ref.logits(low, seq, tf32=tf32)[n - 1:].argmax(dim=-1)
        gap = want.max(dim=-1).values - want.gather(1, pick[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        missed += int((gap > 0).sum())
        summed += float(gap.sum())
        total += len(out)
    return {"token_mismatch_share": 100.0 * missed / max(total, 1),
            "mean_logit_gap": summed / max(total, 1), "logit_gap": worst}
