"""AdamW, LR schedules and global-norm clipping over the port's parameter
trees (port of ``repro.train.optimizer``).

Plain functions of tensors, not ``torch.optim``: the update is the JAX
package's, ``u = m_hat / (sqrt(v_hat) + eps) + wd * p`` and ``p - lr * u``,
where ``torch.optim.AdamW`` decays ``p * (1 - lr * wd)`` before its step.
Moments are float32 whatever the params' dtype, updates are computed in
float32 and cast back; the step counter is int32 and the bias corrections
and schedules are computed from it in float32. The state mirrors the params
tree leaf for leaf (:func:`repro_torch.interop.map_leaves`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.core.quantize import divide
from repro_torch.interop import flatten_names, map_leaves


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: dict                 # first moments (float32)
    nu: dict                 # second moments (float32)


def zeros_f32(tree):
    """Float32 zeros mirroring ``tree``, leaf for leaf, on its devices."""
    return map_leaves(tree, lambda _n, p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        device = flatten_names(params)[0][1].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          zeros_f32(params), zeros_f32(params))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def update(self, grads, state: AdamWState, params, *,
               grad_norm: Optional[torch.Tensor] = None):
        """One step: ``(new_params, new_state)``; the inputs are not
        modified. ``grads`` mirrors ``params``. The clip uses ``grad_norm``
        where given (a mesh's :meth:`~repro_torch.train.trainer.MeshLayout.
        global_norm` of sharded grads), else :func:`global_norm`."""
        step = state.step + 1
        g32 = map_leaves(grads, lambda _n, g: g.to(torch.float32))
        if self.clip_norm is not None:
            gnorm = global_norm(grads) if grad_norm is None else grad_norm
            # a true division: ``float / tensor`` multiplies by a reciprocal
            clip = torch.full((), self.clip_norm, dtype=torch.float32,
                              device=gnorm.device)
            scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
            g32 = map_leaves(g32, lambda _n, g: g * scale)
        g = dict(flatten_names(g32))
        b1, b2 = self.b1, self.b2
        mu = map_leaves(state.mu, lambda n, m: b1 * m + (1 - b1) * g[n])
        nu = map_leaves(state.nu,
                        lambda n, v: b2 * v + (1 - b2) * g[n] * g[n])
        sf = step.to(torch.float32)
        bc1 = 1 - b1 ** sf
        bc2 = 1 - b2 ** sf
        lr = self._lr(step)
        m, v = dict(flatten_names(mu)), dict(flatten_names(nu))

        def upd(n, p):
            u = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + self.eps)
            u = u + self.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype)

        return map_leaves(params, upd), AdamWState(step, mu, nu)


def global_norm(tree, *, mesh=None,
                axes: Optional[dict] = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares. On a
    ``mesh``, ``tree`` holds this rank's blocks and ``axes`` names, leaf by
    leaf, the mesh axes that shard it: each leaf's sum is summed over
    exactly those (one collective an axis set), so a replicated leaf counts
    once; the leaves are then added in the unmeshed order."""
    flat = flatten_names(tree)
    sq = [torch.sum(torch.square(g.to(torch.float32))) for _, g in flat]
    if mesh is not None:
        by_axes: dict = {}
        for i, (n, _) in enumerate(flat):
            if axes[n]:
                by_axes.setdefault(axes[n], []).append(i)
        for ax, idx in by_axes.items():
            v = torch.stack([sq[i] for i in idx])
            for a in ax:
                v = mesh.all_reduce(v, a)
            for j, i in enumerate(idx):
                sq[i] = v[j]
    return torch.sqrt(sum(sq))


# --- schedules ---------------------------------------------------------------


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor * peak`` at ``total``."""
    def lr(step):
        s = step.to(torch.float32)
        warm = divide(peak * s, max(warmup, 1))
        frac = torch.clamp(divide(s - warmup, max(total - warmup, 1)),
                           0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup, warm, cos)
    return lr


def linear_schedule(peak: float, warmup: int, total: int):
    """Linear warmup to ``peak``, then a linear decay to 0 at ``total``."""
    def lr(step):
        s = step.to(torch.float32)
        warm = divide(peak * s, max(warmup, 1))
        frac = torch.clamp(divide(s - warmup, max(total - warmup, 1)),
                           0.0, 1.0)
        return torch.where(s < warmup, warm, peak * (1 - frac))
    return lr
