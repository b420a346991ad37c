"""Serving meshes over ``torch.distributed`` ranks (port of
``repro.launch.mesh``).

A :class:`ProcessMesh` lays the ranks of the default process group out
row-major over named axes (``("data", "model")``, with a leading ``pod`` on
the multi-pod mesh), as ``jax.make_mesh`` lays out devices. It exposes what
the sharding rules and the runtime read: ``shape`` (axis -> size),
``axis_names``, this rank's ``coords`` and one process group an axis, over
which :meth:`ProcessMesh.all_reduce`, :meth:`ProcessMesh.all_gather`,
:meth:`ProcessMesh.all_to_all` and :meth:`ProcessMesh.reduce_scatter`
run (outside autograd: :mod:`repro_torch.distributed.autograd` wraps them
for training).

Where the JAX package raises when ``dp * tp`` exceeds the visible devices,
ranks here go round-robin on the cards (``cuda:(rank % device_count)``):
two ranks may share one card, over gloo. Building a mesh needs its ranks:
start them with :func:`repro_torch.distributed.comm.spawn`, as the serving
CLIs do. Importing this module touches no device.
"""
from __future__ import annotations

import itertools
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import comm


class ProcessMesh:
    """Named axes over the ranks of the default process group; every rank
    builds the same mesh (the axis groups are created collectively)."""

    def __init__(self, shape: dict):
        if not dist.is_initialized():
            raise ValueError(
                f"a {shape} mesh needs its ranks: start them with "
                f"repro_torch.distributed.comm.spawn")
        world = dist.get_world_size()
        need = 1
        for n in shape.values():
            need *= int(n)
        if need != world:
            raise ValueError(f"a {shape} mesh needs {need} ranks; the "
                             f"process group has {world}")
        self.shape = {a: int(n) for a, n in shape.items()}
        self.axis_names = tuple(shape)
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        sizes = [self.shape[a] for a in self.axis_names]
        coords, r = [], self.rank
        for n in reversed(sizes):
            coords.append(r % n)
            r //= n
        self.coords = dict(zip(self.axis_names, reversed(coords)))
        self._groups: dict = {}
        for i, axis in enumerate(self.axis_names):
            if sizes[i] == 1:
                continue
            if sizes[i] == world:
                self._groups[axis] = dist.group.WORLD
                continue
            rest = [range(n) for j, n in enumerate(sizes) if j != i]
            for fixed in itertools.product(*rest):
                ranks = []
                for k in range(sizes[i]):
                    c = list(fixed)
                    c.insert(i, k)
                    flat = 0
                    for cj, nj in zip(c, sizes):
                        flat = flat * nj + cj
                    ranks.append(flat)
                g = dist.new_group(ranks)      # collective: every rank
                if self.rank in ranks:
                    self._groups[axis] = g

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None for
        an axis of size 1)."""
        return self._groups.get(axis)

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """Sum or max of ``t`` over ``axis`` (``t`` itself at size 1)."""
        if self.size(axis) == 1:
            return t
        return comm.all_reduce(t, self._groups[axis], op)

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        """The ranks' ``t`` along ``axis``, concatenated along ``dim`` in
        axis order (``t`` itself at size 1)."""
        if self.size(axis) == 1:
            return t
        return comm.all_gather(t, self._groups[axis], dim)

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Block i of ``t``'s dim 0 to rank i along ``axis``; the blocks
        received, in axis order (``t`` itself at size 1)."""
        if self.size(axis) == 1:
            return t
        return comm.all_to_all(t, self._groups[axis])

    def reduce_scatter(self, t: torch.Tensor, axis: str,
                       dim: int) -> torch.Tensor:
        """The sum of ``t`` over ``axis``, this rank's block of it along
        ``dim`` (``t`` itself at size 1)."""
        if self.size(axis) == 1:
            return t
        return comm.reduce_scatter(t, self._groups[axis], dim)

    def index(self, axes) -> tuple[int, int]:
        """(size, this rank's index) of the axes ``axes`` taken together
        in row-major order (the dp axes ``(pod, data)``, say)."""
        size, index = 1, 0
        for a in axes:
            n = self.size(a)
            size, index = size * n, index * n + self.coords.get(a, 0)
        return size, index

    def __repr__(self) -> str:
        dims = ",".join(f"{a}={n}" for a, n in self.shape.items())
        return f"<ProcessMesh {dims} rank={self.rank} {self.backend}>"


def make_production_mesh(*, multi_pod: bool = False) -> ProcessMesh:
    """The JAX package's pod mesh: (data=16, model=16), and with a leading
    pure-DP pod axis (pod=2, data=16, model=16). Raises unless the process
    group has that many ranks."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    return ProcessMesh(shape)


def make_host_mesh(model: int = 1) -> ProcessMesh:
    """A (data, model) mesh over every rank of the process group, ``model``
    capped at the world size."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = min(model, n)
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    return ProcessMesh({"data": n // model, "model": model})


def parse_mesh(spec: str) -> tuple[int, int]:
    """``"dp,tp"`` -> (dp, tp), with the JAX CLI's errors."""
    try:
        dp, tp = (int(p) for p in spec.split(","))
    except ValueError:
        raise ValueError(f"--mesh wants 'dp,tp' (two integers), got "
                         f"{spec!r}") from None
    if dp < 1 or tp < 1:
        raise ValueError(f"--mesh axes must be >= 1, got {spec!r}")
    return dp, tp


def make_serving_mesh(spec: str) -> Optional[ProcessMesh]:
    """Parse a serving CLI ``--mesh dp,tp`` into a (data, model) mesh over
    the process group's ``dp * tp`` ranks: ``"2,1"`` is 2-way data
    parallel, ``"1,2"`` 2-way tensor parallel. ``"1,1"`` returns None: the
    unmeshed runtime, identical to omitting ``--mesh``."""
    dp, tp = parse_mesh(spec)
    if dp == tp == 1:
        return None
    return ProcessMesh({"data": dp, "model": tp})
