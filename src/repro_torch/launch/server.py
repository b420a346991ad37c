"""HTTP/SSE serving entrypoint — the asyncio front-end over the engines
(port of ``repro.launch.server``).

    # encoder serving (JSON request/response) on the golden plan, on the card
    PYTHONPATH=src python -m repro_torch.launch.server --arch bert-base \
        --task tnews --plan tests/data/golden_plan.json --backend fused \
        --port 8080

    # a decode-capable arch mounts BOTH endpoints: /v1/encode for the
    # encoder task and /v1/generate for SSE token streaming
    PYTHONPATH=src python -m repro_torch.launch.server --arch qwen2-0.5b \
        --task tnews --policy ffn --backend fused --port 8080

    # input-adaptive precision: per-cluster plans, routed per request
    # (docs/adaptive-precision.md; tag requests with X-SAMP-Traffic-Class
    # or the 'traffic_class' JSON field for task: routing)
    ... --clusters length:8,16

    # the reduced config through the kernels' plain versions, on the CPU
    ... --device cpu

    # on a mesh: dp-way data parallel x tp-way tensor parallel, dp * tp
    # ranks; rank 0 listens and sends every engine call to the others
    ... --mesh 2,1

    curl -s localhost:8080/v1/encode -d '{"tokens": [2, 17, 9, 41]}'
    curl -sN localhost:8080/v1/generate -d '{"prompt": [2, 17], "max_tokens": 8}'
    curl -s localhost:8080/metrics

Builds the model exactly like ``launch/serve.py`` (same shared flag
surface — ``launch/cli.py``), wraps the engine(s) in
:class:`~repro_torch.serve.frontend.HTTPFrontend`, and serves until SIGTERM
/ SIGINT, which triggers a graceful drain (stop admitting with 503, finish
in-flight requests, exit). On the card the CUDA kernels are built and
loaded before the listener opens, so no request pays the compiler.
``--port 0`` binds an ephemeral port and prints it. See
docs/http-serving.md for the endpoint contracts, backpressure semantics,
and the metrics catalog.

``--mesh dp,tp`` other than ``1,1`` spawns ``dp * tp`` ranks
(:func:`repro_torch.distributed.comm.spawn`), as ``launch/serve.py`` does.
Every rank builds the same model on the mesh and the same engines. Rank 0
runs the front-end; its engine driver sends each pass's engine operations
to the other ranks over a gloo control group on the CPU, and they replay
them on their own engines
(:func:`~repro_torch.serve.frontend.driver.follow`), so every rank runs
every forward's collectives. This process builds the kernels before it
spawns the ranks, and forwards SIGTERM / SIGINT to rank 0, which drains,
then stops the others; the followers ignore both signals. A rank that
fails stops every rank, and this process exits non-zero with its
traceback.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import signal
import sys
import time

import torch

from repro_torch.launch.cli import (add_serving_flags, check_mesh,
                                    parse_cluster_model, resolve_task,
                                    serving_config)
from repro_torch.launch.serve import (build_model, build_routed_model,
                                      encoder_head)
from repro_torch.serve import EncoderServeEngine, ServeEngine
from repro_torch.serve.frontend import HTTPFrontend


def build_frontend(args, *, log=print, publish=None) -> HTTPFrontend:
    """Build engine(s) for the requested deployment and mount them.

    ``--task lm`` mounts the decode engine only. An encoder task on a
    decode-capable arch mounts BOTH engines over one param tree, so a
    single server answers /v1/encode and /v1/generate. On a ``--mesh``
    this runs on rank 0 of the spawned ranks, with ``publish`` the
    control channel to the others.
    """
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh(args.mesh)
    encoder, decode = build_engines(args, mesh, log=log)
    return HTTPFrontend(encoder=encoder, decode=decode, host=args.host,
                        port=args.port, max_pending=args.max_pending,
                        default_deadline_s=args.deadline_s, log=log,
                        publish=publish)


def build_engines(args, mesh=None, *, log=print) -> tuple:
    """``(encoder, decode)`` engines of the deployment (either may be
    None) on ``mesh``: the model calibrated on the mesh, as
    ``launch.serve --mesh`` builds it."""
    cfg, device = serving_config(args)
    task_name = resolve_task(cfg, args.task)
    cluster_model = parse_cluster_model(args.clusters)
    encoder = decode = None
    decode_router = None
    if task_name == "lm":
        if cluster_model is not None:
            decode_router, entry = build_routed_model(
                cfg, args.policy, cluster_model, seed=args.seed,
                plan_file=args.plan, max_len=args.max_len,
                backend=args.backend, device=device, log=log)
            params, plan, precision = (entry.params, entry.plan,
                                       entry.precision)
        else:
            params, plan, precision = build_model(
                cfg, args.policy, seed=args.seed, plan_file=args.plan,
                strategy=args.strategy, max_latency=args.max_latency,
                device=device, log=log, mesh=mesh)
    else:
        spec, head = encoder_head(cfg, task_name, args.max_len)
        router = None
        if cluster_model is not None:
            # a PlanRouter binds to ONE runtime: route the encoder (the
            # served task); a co-mounted decode engine serves the default
            # member unrouted
            router, entry = build_routed_model(
                cfg, args.policy, cluster_model, seed=args.seed, head=head,
                plan_file=args.plan, max_len=args.max_len,
                backend=args.backend, device=device, log=log)
            params, plan, precision = (entry.params, entry.plan,
                                       entry.precision)
        else:
            params, plan, precision = build_model(
                cfg, args.policy, seed=args.seed, head=head,
                plan_file=args.plan, strategy=args.strategy,
                max_latency=args.max_latency, device=device, log=log,
                mesh=mesh)
        encoder = EncoderServeEngine(cfg, params, plan, target=spec,
                                     max_batch=args.slots,
                                     max_wait=args.max_wait,
                                     max_len=args.max_len,
                                     backend=args.backend, router=router,
                                     device=device, mesh=mesh)
    if cfg.supports_decode:
        decode = ServeEngine(cfg, params, plan, batch_slots=args.slots,
                             max_len=args.max_len, seed=args.seed,
                             backend=args.backend, page_size=args.page_size,
                             kv_cache=args.kv_dtype, precision=precision,
                             router=decode_router, device=device, mesh=mesh)
    return encoder, decode


def make_parser() -> argparse.ArgumentParser:
    """The server's flags: the shared deployment surface plus the
    transport's."""
    ap = add_serving_flags(argparse.ArgumentParser())
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="0 binds an ephemeral port (printed at startup)")
    ap.add_argument("--max-pending", type=int, default=64,
                    help="admission bound on in-flight requests; overflow "
                         "answers 429 + Retry-After")
    ap.add_argument("--max-wait", type=float, default=0.005,
                    help="encoder micro-batch ageing window (seconds)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request deadline when the request "
                         "states no deadline_ms (None = unbounded)")
    return ap


def load_kernels(frontend: HTTPFrontend, *, log=print) -> None:
    """Build (or find built) and load the CUDA kernels when a mounted
    engine launches them: the build is lazy (``kernels.build``), and a
    first request must not pay the compiler inside its deadline."""
    _load_kernels((frontend.encoder, frontend.decode), log)


def _load_kernels(engines, log) -> None:
    if any(e is not None and e.runtime.device.type == "cuda"
           and e.runtime.backend.name != "reference" for e in engines):
        _build_kernels(log)


def _build_kernels(log) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log(f"[server] CUDA kernels loaded in {time.perf_counter() - t0:.2f}s",
        flush=True)


def _silent(*args, **kw) -> None:
    pass


def _server_rank(rank: int, device, args) -> dict:
    """One rank of a meshed server. Rank 0 builds the front-end and serves
    until a drain; the others ignore SIGTERM / SIGINT (a terminal's SIGINT
    reaches every process of its group, and a follower that died inside a
    collective would hang rank 0), build the same engines silently and
    replay rank 0's engine operations until its ``stop``. Each loads the
    kernels this process built."""
    from repro_torch.distributed import comm
    from repro_torch.serve.frontend.driver import follow
    if rank == 0:
        fe = build_frontend(args, publish=comm.broadcast_object)
        load_kernels(fe, log=_silent)
        fe.run_forever()
        if fe.driver.failure is not None:
            raise RuntimeError("engine failure on rank 0") \
                from fe.driver.failure
        return {"rank": 0, "counts": dict(fe.driver.counts)}
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, signal.SIG_IGN)
    from repro_torch.launch.mesh import make_serving_mesh
    with contextlib.redirect_stdout(io.StringIO()):
        encoder, decode = build_engines(args, make_serving_mesh(args.mesh),
                                        log=_silent)
        _load_kernels((encoder, decode), _silent)
    return {"rank": rank, "replayed": follow(
        encoder=encoder, decode=decode, receive=comm.broadcast_object)}


def main(argv=None):
    args = make_parser().parse_args(argv)
    dp, tp = check_mesh(args.mesh)
    if (dp, tp) == (1, 1):
        frontend = build_frontend(args)
        load_kernels(frontend)
        frontend.run_forever()
        return
    _, device = serving_config(args)
    if device.type == "cuda" and args.backend != "reference":
        _build_kernels(print)           # once, before any rank compiles
    from repro_torch.distributed import comm
    try:
        comm.spawn(dp * tp, _server_rank, (args,), device=device.type,
                   deadline_s=None,
                   threads=(max(1, torch.get_num_threads() // (dp * tp))
                            if device.type == "cpu" else None),
                   forward_signals=(signal.SIGTERM, signal.SIGINT))
    except RuntimeError as e:
        sys.exit(f"[server] {e}")


if __name__ == "__main__":
    main()
