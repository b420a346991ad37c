"""Serving launcher CLI: SAMP-quantized serving for BOTH workload types
(port of ``repro.launch.serve``).

    # token-level continuous-batching generation (decode-capable archs)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --policy ffn --backend fused --requests 8 --max-tokens 16

    # encoder micro-batch serving (the paper's CLUE-style workload)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch bert-base \
        --task tnews --policy ffn --backend fused --requests 16

    # a saved PrecisionPlan, or an on-the-fly strategy search
    ... --plan plan.json
    ... --strategy greedy            # prefix_grid | greedy | latency_budget

    # compute backend for the quantized blocks (docs/architecture.md)
    ... --backend fused              # reference | fused | auto

    # input-adaptive precision (docs/adaptive-precision.md): per-cluster
    # calibration scales + request routing
    ... --clusters length:8,16      # length:<edges> | task:<labels> | kmeans:K

    # the reduced config through the kernels' plain versions, on the CPU
    ... --device cpu

    # mesh-sharded serving: dp-way data parallel x tp-way tensor parallel;
    # dp * tp ranks, round-robin on the cards (gloo where they share one)
    ... --mesh 2,1
    ... --mesh 1,2

Instantiates the full config on the card (``--device cuda``, the default)
or the reduced one on the CPU (``--device cpu``, the JAX CLI's container
path), PTQ-calibrates on synthetic batches, applies the requested
precision — a named mode policy (``--policy``), a saved declarative plan
(``--plan plan.json``), or the winner of a search strategy (``--strategy``,
accuracy proxied by closeness to the float forward, latency from the H100
roofline model) — and serves a batch of random requests through the
continuous-batching decode engine (``--task lm``) or the dynamic
micro-batching encoder engine. ``--mesh dp,tp`` other than ``1,1`` spawns
``dp * tp`` ranks (:func:`repro_torch.distributed.comm.spawn`) that each
build the same model and serve the same requests SPMD; rank 0 prints.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import sys
import time

import numpy as np
import torch

from repro_torch.core.calibration import synthetic_calibration_batches
from repro_torch.core.plan import (PlanSet, PrecisionPlan,
                                   load_plan_or_planset, plan_from_policy)
from repro_torch.core.precision import make_policy
from repro_torch.core.samp import SAMPEngine
from repro_torch.data.pipeline import make_task
from repro_torch.distributed.sharding import mesh_fingerprint
from repro_torch.launch.cli import (add_serving_flags, check_mesh,
                                    parse_cluster_model, resolve_task,
                                    serving_config)
from repro_torch.models import transformer as T
from repro_torch.serve import (EncoderRequest, EncoderServeEngine, Request,
                               ServeEngine)
from repro_torch.toolkit.registry import get_target
from repro_torch.toolkit.targets import TARGET_FOR_TASK_KIND


def _to_device(device, batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def search_plan(cfg, eng: SAMPEngine, params, stats, strategy: str, *,
                seed: int = 0, seq: int = 32, max_latency=None,
                device="cuda", log=print) -> PrecisionPlan:
    """Pick a PrecisionPlan with a registered search strategy: accuracy is
    proxied by closeness of the quantized forward to the float forward on a
    synthetic batch (randomly initialized weights have no task accuracy);
    latency comes from the roofline backend."""
    from repro_torch.toolkit.latency import RooflineBackend
    batch = _to_device(device, synthetic_calibration_batches(
        cfg, num_batches=1, seq_len=seq, seed=seed)[0])
    with torch.inference_mode():
        ref = T.forward(params, batch, cfg, eng.float_plan)

    def eval_fn(qp, plan, pol):
        with torch.inference_mode():
            out = T.forward(qp, batch, cfg, plan, eng.scheme)
            return 1.0 - float(torch.mean(torch.abs(out - ref))
                               / (torch.mean(torch.abs(ref)) + 1e-9))

    latency_fn = RooflineBackend().bind(cfg, batch=8, seq=seq)
    kw = {}
    if strategy == "latency_budget":
        if max_latency is None:
            # default budget: 80% of the float roofline
            max_latency = 0.8 * latency_fn(None, None, eng.float_precision)
        kw["max_latency"] = max_latency
    points = eng.search(strategy, params, stats, eval_fn, latency_fn, **kw)
    recs = eng.recommend(points, max_latency=max_latency)
    chosen = next((r for r in recs if r.mode_name == "quant_ffn_only"),
                  recs[0] if recs else None)
    if chosen is None:
        log(f"[serve] strategy {strategy!r} found no quantized candidate; "
            f"serving float")
        return eng.float_precision
    log(f"[serve] strategy {strategy!r} chose {chosen.plan.describe()} "
        f"(speedup {chosen.recommendation.speedup:.3f}x)")
    return chosen.plan


def build_model(cfg, policy_name: str = "float", *, seed: int = 0,
                head=None, log=print, plan_file=None, strategy=None,
                max_latency=None, device="cuda", mesh=None):
    """Float init + optional SAMP PTQ on ``device``. Precision comes from,
    in precedence order: a saved plan file, a search strategy, or the named
    mode policy. Returns ``(params, execution_plan, precision)`` — the
    PrecisionPlan rides along so engines can read per-layer KV-cache
    schemes (``precision.kv_schemes``). On a ``mesh`` every rank builds the
    whole tree and calibrates data-parallel over the ranks."""
    eng = SAMPEngine(cfg, float_dtype="float32")
    params = T.init_params(cfg, eng.float_precision, seed=seed, head=head,
                           device=device)
    precision = None
    if plan_file is not None:
        precision = PrecisionPlan.load(plan_file)
        log(f"[serve] loaded plan {plan_file}: {precision.describe()}")
    elif strategy is None:
        precision = plan_from_policy(make_policy(cfg, policy_name))
    if precision is not None and not (precision.num_quant_ffn
                                      or precision.num_quant_mha
                                      or precision.num_quant_kv):
        return params, eng.float_plan, precision
    batches = synthetic_calibration_batches(cfg, seed=seed)
    stats = eng.calibrate(params, batches, precision=precision, mesh=mesh)
    if strategy is not None and precision is None:
        precision = search_plan(cfg, eng, params, stats, strategy,
                                seed=seed, max_latency=max_latency,
                                device=device, log=log)
        if not (precision.num_quant_ffn or precision.num_quant_mha
                or precision.num_quant_kv):
            return params, eng.float_plan, precision
    params, plan = eng.apply(params, stats, precision)
    log(f"[serve] applied SAMP plan: {precision.describe()}")
    return params, plan, precision


def build_routed_model(cfg, policy_name: str, cluster_model, *,
                       seed: int = 0, head=None, plan_file=None,
                       max_len: int = 64, backend=None, device="cuda",
                       log=print):
    """Input-adaptive build: fit the cluster model, calibrate
    cluster-conditional scales on a synthetic stream that covers every
    cluster, and assemble a :class:`~repro_torch.adaptive.PlanRouter`.

    The PlanSet comes from ``--plan`` (a PlanSet file routes as-is; a
    single-plan file deploys uniformly) or from the named policy deployed
    uniformly — per-cluster *scales* still differ, which is the paper's
    self-adaptive point. ``backend`` is the compute backend an
    EmbeddingKMeans model embeds through. Returns ``(router,
    default_entry)``; the default entry seeds the engine's constructor
    arguments.
    """
    from repro_torch import adaptive

    eng = SAMPEngine(cfg, float_dtype="float32")
    params = T.init_params(cfg, eng.float_precision, seed=seed, head=head,
                           device=device)
    batches, classes = adaptive.clustered_synthetic_batches(
        cfg, cluster_model, seed=seed, max_len=max_len)
    adaptive.fit_cluster_model(cluster_model, params, batches, cfg,
                               backend=backend)
    stats = eng.calibrate(
        params, batches,
        clusters=adaptive.batch_clusters(cluster_model, batches,
                                         batch_classes=classes))
    cids = range(cluster_model.num_clusters)
    if plan_file is not None:
        loaded = load_plan_or_planset(plan_file)
        planset = (loaded if isinstance(loaded, PlanSet)
                   else PlanSet.uniform(loaded, cids))
        log(f"[serve] loaded {plan_file}: {planset.describe()}")
    else:
        planset = PlanSet.uniform(
            plan_from_policy(make_policy(cfg, policy_name)), cids)
    router = adaptive.build_router(cfg, params, planset, stats,
                                   cluster_model=cluster_model,
                                   scheme=eng.scheme,
                                   float_plan=eng.float_plan,
                                   backend=backend)
    log(f"[serve] {router.describe()}")
    return router, router.entry(planset.default)


def _traffic_class_for(router, i: int):
    """Synthetic traffic-class tag for request ``i``: TaskLabel routing is
    caller-declared, so the demo loop cycles the labels; content-routed
    models (length, kmeans) need no tag."""
    if router is None or not hasattr(router.model, "label_for"):
        return None
    return router.model.label_for(i % router.num_clusters)


def _device_name(device) -> str:
    """The card's name, or "CPU", for a run's summary line."""
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "CPU")


def serve_decode(cfg, args, device, mesh=None) -> None:
    router = None
    if args.clusters is not None:
        model = parse_cluster_model(args.clusters)
        router, entry = build_routed_model(
            cfg, args.policy, model, seed=args.seed, plan_file=args.plan,
            max_len=args.max_len, backend=args.backend, device=device)
        params, plan, precision = entry.params, entry.plan, entry.precision
    else:
        params, plan, precision = build_model(
            cfg, args.policy, seed=args.seed, plan_file=args.plan,
            strategy=args.strategy, max_latency=args.max_latency,
            device=device, mesh=mesh)
    server = ServeEngine(cfg, params, plan, batch_slots=args.slots,
                         max_len=args.max_len, seed=args.seed,
                         backend=args.backend, page_size=args.page_size,
                         kv_cache=args.kv_dtype, precision=precision,
                         router=router, device=device, mesh=mesh)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = int(rng.integers(2, 9))
        prompt = rng.integers(1, cfg.vocab_size, size=plen).tolist()
        server.submit(Request(uid=i, prompt=prompt,
                              max_tokens=args.max_tokens,
                              temperature=args.temperature,
                              traffic_class=_traffic_class_for(router, i)))
    t0 = time.perf_counter()
    done = server.run()
    dt = time.perf_counter() - t0
    for req in sorted(done, key=lambda r: r.uid):
        print(f"  req{req.uid}: prompt={req.prompt} -> {req.output}")
    s = server.stats
    print(f"[serve] backend={server.runtime.backend.name} "
          f"mesh={mesh_fingerprint(server.runtime.mesh)}: "
          f"{s['retired']} requests, {s['tokens']} tokens in "
          f"{s['ticks']} ticks, {dt:.2f}s "
          f"({s['tokens'] / max(dt, 1e-9):.1f} tok/s "
          f"{_device_name(device)}); "
          f"{s['runtime_traces']} build(s) / "
          f"{s['runtime_executables']} cached callable(s)")
    if router is not None:
        print(f"[serve] clusters: {dict(router.requests_by_cluster)} "
              f"({router.active_plans} active plan(s))")


def encoder_head(cfg, task_name: str, max_len: int):
    """The target spec and ``(head kind, classes)`` of an encoder task."""
    task = make_task(task_name, vocab_size=cfg.vocab_size, seq_len=max_len)
    spec = get_target(TARGET_FOR_TASK_KIND[task.kind])
    head_kind = "ner" if spec.token_level else "cls"
    return spec, (head_kind, max(task.n_classes, 1))


def serve_encoder(cfg, args, device, mesh=None) -> None:
    spec, head = encoder_head(cfg, args.task, args.max_len)
    router = None
    if args.clusters is not None:
        model = parse_cluster_model(args.clusters)
        router, entry = build_routed_model(
            cfg, args.policy, model, seed=args.seed, head=head,
            plan_file=args.plan, max_len=args.max_len, backend=args.backend,
            device=device)
        params, plan = entry.params, entry.plan
    else:
        params, plan, _ = build_model(cfg, args.policy, seed=args.seed,
                                      head=head, plan_file=args.plan,
                                      strategy=args.strategy,
                                      max_latency=args.max_latency,
                                      device=device, mesh=mesh)
    server = EncoderServeEngine(cfg, params, plan, target=spec,
                                max_batch=args.slots, max_len=args.max_len,
                                backend=args.backend, router=router,
                                device=device, mesh=mesh)
    if cfg.frontend == "audio":
        _serve_frames(cfg, args, server, spec, device)
        return
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        n = int(rng.integers(4, args.max_len // 2))
        server.submit(EncoderRequest(
            uid=i, tokens=rng.integers(1, cfg.vocab_size, size=n).tolist(),
            traffic_class=_traffic_class_for(router, i)))
    t0 = time.perf_counter()
    done = server.run()               # flush full + partial micro-batches
    dt = time.perf_counter() - t0
    for req in sorted(done, key=lambda r: r.uid):
        print(f"  req{req.uid}: {len(req.tokens)} tokens -> "
              f"{np.asarray(req.prediction).tolist()}")
    s = server.stats
    print(f"[serve] task={args.task} target={spec.name} "
          f"backend={server.runtime.backend.name} "
          f"mesh={mesh_fingerprint(server.runtime.mesh)}: {s['retired']} "
          f"requests in {s['batches']} micro-batches, {dt:.2f}s "
          f"({s['retired'] / max(dt, 1e-9):.1f} req/s "
          f"{_device_name(device)}); "
          f"{s['runtime_traces']} build(s) / "
          f"{s['runtime_executables']} cached callable(s)")
    if router is not None:
        print(f"[serve] clusters: {dict(router.requests_by_cluster)} "
              f"({router.active_plans} active plan(s))")


def request_frames(cfg, args) -> list:
    """An audio config's requests: request ``i`` has as many frames as the
    token requests' lengths draw, its unit-normal features from
    ``np.random.default_rng(seed + i)``, as ``launch/train.py`` seeds a
    batch's frames."""
    rng = np.random.default_rng(args.seed)
    out = []
    for i in range(args.requests):
        n = int(rng.integers(4, args.max_len // 2))
        out.append(np.random.default_rng(args.seed + i).standard_normal(
            (n, cfg.frontend_dim), np.float32))
    return out


def _serve_frames(cfg, args, server, spec, device) -> None:
    """Serve an audio config: the micro-batcher queues token lists, so the
    requests' frames go through the engine's runtime in batches of
    ``--slots``, each zero-padded to its longest request."""
    frames = request_frames(cfg, args)
    t0 = time.perf_counter()
    preds, batches = [], 0
    for lo in range(0, len(frames), args.slots):
        group = frames[lo:lo + args.slots]
        lengths = np.asarray([len(f) for f in group], np.int32)
        batch = np.zeros((len(group), int(lengths.max()), cfg.frontend_dim),
                         np.float32)
        for i, f in enumerate(group):
            batch[i, :len(f)] = f
        logits = server.runtime.encode(server.params, {"frames": batch},
                                       lengths)
        for i in range(len(group)):
            row = logits[i][:int(lengths[i])] if spec.token_level \
                else logits[i]
            preds.append(np.asarray(spec.predict(row)))
        batches += 1
    dt = time.perf_counter() - t0
    for i, (f, p) in enumerate(zip(frames, preds)):
        print(f"  req{i}: {len(f)} frames -> {p.tolist()}")
    rs = server.runtime.stats
    print(f"[serve] task={args.task} target={spec.name} "
          f"backend={server.runtime.backend.name} "
          f"mesh={mesh_fingerprint(server.runtime.mesh)}: {len(frames)} "
          f"requests in {batches} micro-batches, {dt:.2f}s "
          f"({len(frames) / max(dt, 1e-9):.1f} req/s "
          f"{_device_name(device)}); "
          f"{rs['traces']} build(s) / {rs['executables']} cached "
          f"callable(s)")


def _serve(args, device, mesh=None) -> None:
    cfg, _ = serving_config(args)
    args.task = resolve_task(cfg, args.task)
    if args.task == "lm":
        serve_decode(cfg, args, device, mesh)
    else:
        serve_encoder(cfg, args, device, mesh)


def _serve_rank(rank: int, device, args) -> None:
    """One rank of a meshed run: the same model, requests and engine calls
    as every other rank; rank 0 prints."""
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh(args.mesh)
    out = sys.stdout if rank == 0 else io.StringIO()
    with contextlib.redirect_stdout(out):
        print(f"[serve] mesh={mesh_fingerprint(mesh)}: "
              f"{mesh.shape['data'] * mesh.shape['model']} ranks, process "
              f"group {mesh.backend}, rank 0 on {device}", flush=True)
        _serve(args, device, mesh)
        sys.stdout.flush()


def main(argv=None):
    # deployment flags come from the shared launch.cli surface so this
    # entrypoint and launch/server.py cannot drift
    ap = add_serving_flags(argparse.ArgumentParser())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)
    dp, tp = check_mesh(args.mesh)
    _, device = serving_config(args)
    if (dp, tp) == (1, 1):
        _serve(args, device)
        return
    from repro_torch.distributed import comm
    comm.spawn(dp * tp, _serve_rank, (args,), device=device.type,
               threads=(max(1, torch.get_num_threads() // (dp * tp))
                        if device.type == "cpu" else None))


if __name__ == "__main__":
    main()
