"""Process groups and collectives for SPMD serving over ``torch.distributed``
(the port's own: the JAX package lets GSPMD place its collectives).

* :func:`init` joins rank ``r`` of ``world`` to a process group through a
  ``FileStore`` (a file in a temporary directory, so concurrent runs never
  collide on a port). Rank ``r`` runs on ``cuda:(r % device_count)``.
  Where every rank has a card of its own the group is NCCL; where ranks
  share a card (NCCL refuses two ranks on one device), and on the CPU, it is
  gloo.
* :func:`all_reduce` (sum or max, float32 and int32),
  :func:`all_gather`, :func:`all_to_all` and :func:`reduce_scatter` over a
  group: the only collectives the port runs. gloo runs them on CUDA tensors itself
  (:func:`probe_gloo_cuda` checks that on the card in every run of
  ``chip_smoke.py``'s ``mesh_path``). :func:`all_to_all` carries the
  expert exchange of an MoE layer: ``all_to_all_single``, which gloo takes
  on CPU and on CUDA tensors (its list form, ``all_to_all``, it refuses).
  :func:`reduce_scatter` carries the backward of an FSDP gather in
  training: ``reduce_scatter_tensor``, which gloo takes on CPU tensors and,
  on the H100 with torch 2.11, on CUDA tensors (``probe_gloo_cuda``), so
  no all-reduce-then-narrow stands in for it.
* :func:`broadcast_object` sends a picklable host object from rank 0 to
  every rank: the control channel of a meshed HTTP server. It runs over a
  gloo group on the CPU that :func:`init` creates beside the default
  group, so it never touches a card and works where the default group is
  NCCL (whose object broadcast would need CUDA tensors).
* :func:`spawn` starts ``world`` ranks with the ``spawn`` start method, runs
  ``fn`` on each and returns their results in rank order. It joins with a
  deadline (or none, for a server): a rank that raises, dies or hangs past
  it fails the run with the ranks' tracebacks and every rank is stopped,
  so a hung collective never hangs the caller. It can forward the
  signals the caller receives to rank 0, and a rank whose caller dies
  ends itself.

:data:`STATS` counts the collectives a process ran, their bytes and the
seconds its host spent in them.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import signal
import tempfile
import threading
import time
import traceback
import warnings
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

#: the collectives the port runs, which a gloo group must take on CUDA
#: tensors (:func:`probe_gloo_cuda`)
COLLECTIVES = ("all_reduce", "all_reduce_max", "all_reduce_int32",
               "all_gather", "all_to_all", "reduce_scatter_tensor")

#: collectives this process ran since :func:`reset_stats`: calls, bytes
#: in, host seconds
STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}

#: the control channel's share of :data:`STATS` (:func:`broadcast_object`)
CONTROL = {"calls": 0, "bytes": 0, "seconds": 0.0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

#: the gloo group on the CPU that carries :func:`broadcast_object`
_control = None


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0)
    CONTROL.update(calls=0, bytes=0, seconds=0.0)


def rank_device(rank: int, kind: str = "cuda") -> torch.device:
    """The device of rank ``rank``: cards round-robin, or the CPU."""
    if kind == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' for the "
                           "plain versions")
    return torch.device("cuda", rank % n)


def backend_for(world: int, device: torch.device) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init(rank: int, world: int, store_path: str, device: torch.device, *,
         timeout_s: float = 600.0) -> str:
    """Join the process group; returns its backend."""
    backend = backend_for(world, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    global _control
    store = dist.FileStore(store_path, world)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    _control = dist.new_group(backend="gloo", timeout=timeout)
    return backend


def broadcast_object(obj=None):
    """Rank 0's picklable ``obj`` on every rank (the others pass nothing),
    over the control group on the CPU; counted in :data:`STATS` by its
    pickled bytes."""
    t0 = time.perf_counter()
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_control, device="cpu")
    seconds = time.perf_counter() - t0
    nbytes = len(pickle.dumps(box[0]))
    for stats in (STATS, CONTROL):
        stats["calls"] += 1
        stats["bytes"] += nbytes
        stats["seconds"] += seconds
    return box[0]


def all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """The elementwise sum or max of ``t`` over ``group``; reduces ``t`` in
    place where it can and returns the result."""
    t0 = time.perf_counter()
    t = t.contiguous()
    dist.all_reduce(t, op=_OPS[op], group=group)
    _count(t, t0)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order."""
    t0 = time.perf_counter()
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    _count(src, t0)
    return torch.cat(parts, dim=dim)


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """Block i of ``t`` (its dim 0 cut into as many equal blocks as the
    group has ranks) to group rank i: returns the blocks the ranks sent
    this one, in group-rank order along dim 0."""
    t0 = time.perf_counter()
    src = t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _count(src, t0)
    return out


def reduce_scatter(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The elementwise sum of ``t`` over ``group``, cut along ``dim`` into
    as many equal blocks as the group has ranks: this rank's block."""
    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    with warnings.catch_warnings():
        # torch 2.13 warns that it is renamed reduce_scatter_single; this
        # name is the one torch 2.11 and 2.13 both take
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, group=group)
    _count(src, t0)
    return out.movedim(0, dim)


def barrier(group=None) -> None:
    """Wait for every rank of ``group``."""
    t0 = time.perf_counter()
    dist.barrier(group=group)
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0


def _count(t: torch.Tensor, t0: float) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    STATS["seconds"] += time.perf_counter() - t0


def probe_gloo_cuda(device: torch.device, group=None) -> dict:
    """Which collectives a gloo group runs on CUDA tensors (each tried on
    a small tensor): ``{name: True | error}``, :data:`COLLECTIVES` and a
    broadcast. Call on every rank of the group."""
    out = {}
    x = torch.arange(4, dtype=torch.float32, device=device) \
        + dist.get_rank(group)
    tries = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "all_reduce_max": lambda: dist.all_reduce(
            x.clone(), op=dist.ReduceOp.MAX, group=group),
        "all_reduce_int32": lambda: dist.all_reduce(
            x.to(torch.int32), group=group),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(dist.get_world_size(group))],
            x, group=group),
        "all_to_all": lambda: dist.all_to_all_single(
            torch.empty_like(x), x, group=group),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(x.numel() // dist.get_world_size(group),
                        device=device), x.clone(), group=group),
        "broadcast": lambda: dist.broadcast(x.clone(), 0, group=group),
    }
    for name, call in tries.items():
        try:
            call()
            torch.cuda.synchronize(device)
            out[name] = True
        except Exception as e:           # a collective gloo refuses
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return out


# ---------------------------------------------------------------------------
# spawning ranks
# ---------------------------------------------------------------------------


def _exit_with_parent() -> None:
    """End this rank when the process that spawned it is gone (killed
    where it could stop no rank), so a server's ranks never outlive it."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)
    threading.Thread(target=watch, daemon=True,
                     name="samp-parent-watch").start()


def _worker(rank, world, store_path, device_kind, threads, fn, args, q):
    global _control
    _exit_with_parent()
    try:
        if threads:
            torch.set_num_threads(threads)
        device = rank_device(rank, device_kind)
        init(rank, world, store_path, device)
        out = fn(rank, device, *args)
        q.put((rank, True, out))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
    finally:
        _control = None
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world: int, fn: Callable, args: Sequence = (), *,
          device: str = "cuda", deadline_s: Optional[float] = 600.0,
          threads: Optional[int] = None,
          forward_signals: Sequence[int] = ()) -> list:
    """Run ``fn(rank, device, *args)`` on ``world`` spawned ranks joined in
    one process group, and return the results in rank order. ``fn`` and its
    results must pickle (numpy, not tensors: a rank's tensors do not
    outlive it); ``device`` is ``"cuda"`` (ranks round-robin on the
    cards) or ``"cpu"``; ``threads`` sets each rank's torch threads. A rank
    that raises or dies, or a run past ``deadline_s`` (None: no deadline),
    stops every rank and raises ``RuntimeError`` with what each rank
    reported. Each signal of ``forward_signals`` that this process receives
    while the ranks run goes on to rank 0 (a server's SIGTERM: rank 0
    drains and tells the others to stop)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="samp_pg_")
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(r, world, os.path.join(tmp, "store"), device,
                               threads, fn, tuple(args), q))
             for r in range(world)]
    results, errors = {}, {}

    def forward(sig, _frame):
        if procs[0].pid is not None and procs[0].exitcode is None:
            os.kill(procs[0].pid, sig)
    previous = {sig: signal.signal(sig, forward) for sig in forward_signals}
    try:
        for p in procs:
            p.start()
        end = None if deadline_s is None else time.monotonic() + deadline_s
        while len(results) + len(errors) < world:
            if errors:
                break               # the others may wait in a collective
            left = 1.0 if end is None else end - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"spawn: ranks {sorted(set(range(world)) - set(results))}"
                    f" did not finish within {deadline_s:.0f} s")
            try:
                rank, ok, out = q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    # one last look: a rank's report may still be in flight
                    try:
                        rank, ok, out = q.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"spawn: rank(s) {dead} died (exit codes "
                            f"{[procs[r].exitcode for r in dead]}) without "
                            f"a report") from None
                else:
                    continue
            (results if ok else errors)[rank] = out
        if errors:
            raise RuntimeError("spawn: " + "\n".join(
                f"rank {r} failed:\n{tb}" for r, tb in sorted(errors.items())))
        for p in procs:
            p.join(timeout=30)
        return [results[r] for r in range(world)]
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        for p in procs:
            if p.is_alive():
                p.terminate()
        end = time.monotonic() + 10.0       # one grace period for all
        for p in procs:
            p.join(timeout=max(end - time.monotonic(), 0.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        q.close()
        shutil.rmtree(tmp, ignore_errors=True)
