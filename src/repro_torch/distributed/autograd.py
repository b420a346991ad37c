"""Collectives that autograd differentiates, over the axes of a
:class:`~repro_torch.launch.mesh.ProcessMesh` (the Megatron f / g pair and
its relatives). Training on a mesh runs the tensor-parallel forward of
:mod:`repro_torch.models.layers` under autograd, and every collective of
that forward goes through one of these:

* :func:`copy_to` — identity forward, the gradient summed over the axis
  backward. It goes where a tensor every rank holds whole (replicated)
  enters a computation that differs by rank: a column-parallel GEMM, or a
  narrow to the rank's block. Each rank's gradient of it is then a partial,
  and the sum is the whole gradient;
* :func:`reduce_from` — the sum over the axis forward (a row-parallel
  GEMM's partial products, a vocab-parallel embedding), identity backward;
* :func:`gather` — the ranks' blocks concatenated forward, the rank's
  block of the gradient backward (every rank holds the whole gradient of a
  replicated tensor);
* :func:`all_to_all` — the block exchange forward, the inverse exchange
  (the same exchange) backward;
* :func:`fsdp_gather` — an FSDP-sharded parameter gathered to the rank's
  model block forward, the gradient summed over the axis and cut to the
  rank's shard backward (a reduce-scatter).

Where the forward needs no gradient (serving, ``torch.no_grad``), or the
axis has size 1, each is the plain :class:`ProcessMesh` call, so serving on
a mesh computes what it computed before. The backward collectives count in
:data:`repro_torch.distributed.comm.STATS` like the forward ones. The
dynamic int8 amax reductions (``mesh_max``, ``row_amax``) stay outside
autograd: training runs float trees.
"""
from __future__ import annotations

import torch


def _live(x, mesh, axis: str) -> bool:
    """Whether the collective runs under autograd: a tensor that needs a
    gradient and an axis over 1 rank."""
    return (mesh is not None and mesh.size(axis) > 1
            and isinstance(x, torch.Tensor) and x.requires_grad
            and torch.is_grad_enabled())


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.coords[ctx.axis]
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g, ctx.axis), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.reduce_scatter(g, ctx.axis, ctx.dim), None, None,
                None)


def copy_to(x, mesh, axis: str = "model"):
    """``x`` as it is; backward, its gradient summed over ``axis``."""
    return _CopyTo.apply(x, mesh, axis) if _live(x, mesh, axis) else x


def reduce_from(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The sum of ``x`` over ``axis``; backward, the gradient as it is."""
    if _live(x, mesh, axis):
        return _ReduceFrom.apply(x, mesh, axis)
    return mesh.all_reduce(x, axis)


def gather(x: torch.Tensor, mesh, axis: str = "model",
           dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim``; backward,
    this rank's block of the gradient."""
    if _live(x, mesh, axis):
        return _Gather.apply(x, mesh, axis, dim % x.ndim)
    return mesh.all_gather(x, axis, dim)


def all_to_all(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Block i of ``x``'s dim 0 to rank i along ``axis``; backward, the
    same exchange of the gradient, which undoes it."""
    if _live(x, mesh, axis):
        return _AllToAll.apply(x, mesh, axis)
    return mesh.all_to_all(x, axis)


def fsdp_gather(x: torch.Tensor, mesh, axis: str = "data",
                dim: int = 0) -> torch.Tensor:
    """An FSDP shard gathered along ``dim`` over ``axis``; backward, the
    gradient summed over ``axis`` and cut to this rank's shard."""
    if _live(x, mesh, axis):
        return _FsdpGather.apply(x, mesh, axis, dim % x.ndim)
    return mesh.all_gather(x, axis, dim)
