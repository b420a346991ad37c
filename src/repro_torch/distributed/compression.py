"""int8-compressed cross-pod gradient reduction with error feedback (port of
``repro.distributed.compression``).

On the multi-pod mesh the ``pod`` axis is pure data parallelism. The
gradient crossing it is coded as symmetric int8 at one per-tensor scale,
and an error-feedback accumulator carries each step's quantization
residual into the next step, so the compression is unbiased in the long
run. For a tensor ``g`` (this rank's block) and its error ``err``, as the
JAX package's ``_compress_one`` computes it:

* ``gf = g + err`` in float32; ``amax = max |gf|``, its max over ``pod``;
  ``scale = compute_scale_symmetric(amax)``;
* ``q = quantize(gf, scale)`` (divide, round half to even, clip to
  [-128, 127]); ``new_err = gf - q * scale``;
* the int32 codes summed over ``pod``, then ``* scale / n``.

The trainer calls it after the float reduction of the gradient over the dp
axes, where the JAX step calls it after ``value_and_grad``, whose gradient
GSPMD has already reduced: so every pod holds the same ``g`` and this
re-reduces a reduced gradient, in both packages (ROADMAP §3).
:func:`compress_allreduce_pytree` runs two collectives a step whatever the
tree: one max over every leaf's amax, one int32 sum over every leaf's
codes, flattened into one buffer. With ``mesh=None`` it is the plain
version on one rank (n = 1): ``q * scale`` and the residual.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import (compute_scale_symmetric, divide,
                                       quantize)
from repro_torch.interop import flatten_names, map_leaves


def compress_allreduce_pytree(grads, err_state, *, mesh=None,
                              axis: str = "pod"):
    """(reduced gradients, new error state), each mirroring ``grads``: the
    error-feedback int8 all-reduce of every leaf over ``axis`` of
    ``mesh`` (every rank calls it), or on one rank without a mesh."""
    names, gs = zip(*flatten_names(grads))
    errs = dict(flatten_names(err_state))
    gf = [g.to(torch.float32) + errs[n] for n, g in zip(names, gs)]
    amax = torch.stack([torch.amax(torch.abs(t)) for t in gf])
    live = mesh is not None and mesh.size(axis) > 1
    if live:
        amax = mesh.all_reduce(amax, axis, "max")
    scale = compute_scale_symmetric(amax)
    q = [quantize(t, scale[i]) for i, t in enumerate(gf)]
    new_err = {n: t - q[i].to(torch.float32) * scale[i]
               for i, (n, t) in enumerate(zip(names, gf))}
    summed = torch.cat([c.reshape(-1).to(torch.int32) for c in q])
    n_ranks = 1
    if live:
        summed = mesh.all_reduce(summed, axis)
        n_ranks = mesh.size(axis)
    parts = torch.split(summed, [c.numel() for c in q])
    reduced = {
        n: divide(parts[i].view_as(q[i]).to(torch.float32) * scale[i],
                  float(n_ranks)).to(gs[i].dtype)
        for i, n in enumerate(names)}
    return (map_leaves(grads, lambda n, _g: reduced[n]),
            map_leaves(grads, lambda n, _g: new_err[n]))


def compress_allreduce(g: torch.Tensor, err: torch.Tensor, *, mesh=None,
                       axis: str = "pod"):
    """One tensor's error-feedback int8 all-reduce over ``axis``:
    (reduced mean gradient, new error residual)."""
    r, e = compress_allreduce_pytree({"g": g}, {"g": err}, mesh=mesh,
                                     axis=axis)
    return r["g"], e["g"]
