"""RG-LRU temporal-mixing block of Griffin / RecurrentGemma (port of
``repro.models.rglru``).

The recurrence

    r_t = sigmoid(x_t W_a)          (recurrence gate)
    i_t = sigmoid(x_t W_i)          (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)            (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

is a diagonal linear RNN in float32. The JAX package computes it with one
``jax.lax.associative_scan``; here it is a log-depth doubling scan in plain
PyTorch (ceil(log2 S) elementwise steps, each combining every step t with
step t - 2^k), which adds in another order, so the two agree to float32
rounding, not bit for bit.

The block's GEMMs (input, gate, recurrence-gate and output projections) form
the FFN quant group and run on the reference path under every backend, as
in the JAX package; the recurrence itself is never quantized.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.backend import ACTIVATIONS
from repro_torch.models import layers as L

_RGLRU_C = 8.0


def init_rglru(gen: torch.Generator, cfg, *, device=None,
               dtype=torch.float32) -> dict:
    R = cfg.rnn_width or cfg.d_model
    kw = dict(device=device, dtype=dtype)
    return {
        "wx": L.init_linear(gen, cfg.d_model, R, False, **kw),
        "wg": L.init_linear(gen, cfg.d_model, R, False, **kw),
        "conv": L.init_conv1d(gen, cfg.conv_width, R, **kw),
        "wa": L.init_linear(gen, R, R, True, **kw),
        "wi": L.init_linear(gen, R, R, True, **kw),
        # Lambda so that a = sigmoid(lam)^c spreads over (0.9, 0.999)
        "lam": torch.rand((R,), generator=gen, dtype=torch.float32,
                          device=device) * 5.0 + 3.0,
        "wo": L.init_linear(gen, R, cfg.d_model, False, **kw),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it, ``logaddexp(x,
    0)``: ``torch.nn.functional.softplus`` returns x itself past its
    threshold of 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 (time), float32; a, b: (B, S, R).
    A carried state ``h0`` (B, R) is folded into step 0's b. Doubling scan:
    after the step of offset k, (a_t, b_t) compose steps t - 2k + 1 .. t."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S = a.shape[1]
    k = 1
    while k < S:
        # (a1, b1) earlier, (a2, b2) later -> (a1 a2, a2 b1 + b2)
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return b


def local_width(cfg, mesh) -> int:
    """The recurrence channels a rank holds: its block of R where the
    model axis divides them (``wx``, ``wg``, ``wa`` and ``wi`` are then
    column-parallel over R), else all R."""
    return L.tp_block(cfg.rnn_width or cfg.d_model, mesh)


def rglru_mix(x: torch.Tensor, p: dict, cfg, *, obs: Optional[dict] = None,
              state: Optional[dict] = None,
              active: Optional[torch.Tensor] = None, mesh=None):
    """The temporal-mixing half of a recurrent layer (the norms, the
    residual and the FFN are the layer driver's). x: (B, S, D) after norm1.
    ``state`` (decode): {"h": (B, R) float32, "conv": (B, W-1, R)}.
    Returns (out (B, S, D), new_state or None).

    On a tensor-parallel ``mesh`` a rank runs its block of the R channels
    (:func:`local_width`): ``xr`` and the gate come from its columns of
    ``wx`` and ``wg``, the conv and ``lam`` (which the rules leave whole)
    are sliced to its channels, ``xc`` is all-gathered for ``wa`` and
    ``wi`` (whole input, the rank's output columns), the recurrence is
    elementwise on the rank's channels, and ``wo`` is row-parallel; its
    state holds the rank's channels."""
    R = cfg.rnn_width or cfg.d_model
    L.observe(obs, "rec_in", x)
    xt = L.tp_in(x, mesh)
    xr = L.tp_dense(x, p["wx"], R, mesh, xt)                 # (B, S, Rl)
    gate = ACTIVATIONS["gelu"](L.tp_dense(x, p["wg"], R, mesh, xt))
    Rl = xr.shape[-1]
    conv, lam = p["conv"], p["lam"]
    if Rl != R:
        conv = {"w": L.tp_cols(conv["w"], Rl, mesh),
                "b": L.tp_cols(conv["b"], Rl, mesh)}
        lam = L.tp_cols(lam, Rl, mesh)
    conv_state = state["conv"] if state is not None else None
    xc, new_conv = L.causal_conv1d(xr, conv, conv_state)
    L.observe(obs, "rec_gate_in", xc)
    xc_all = L.tp_whole(xc, R, mesh)
    f32 = torch.float32
    xct = L.tp_in(xc_all, mesh)
    r = torch.sigmoid(L.tp_dense(xc_all, p["wa"], R, mesh, xct).to(f32))
    i = torch.sigmoid(L.tp_dense(xc_all, p["wi"], R, mesh, xct).to(f32))
    log_a = -_RGLRU_C * softplus(lam.to(f32)) * r           # (B, S, Rl)
    a = torch.exp(log_a)
    gated_x = i * xc.to(f32)
    b = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-6)) * gated_x
    h0 = state["h"] if state is not None else None
    h = rglru_scan(a, b, h0)                                 # (B, S, Rl)
    new_state = None
    if state is not None:
        new_state = L.select_state({"h": h[:, -1, :], "conv": new_conv},
                                   state, active)
    y = h.to(x.dtype) * gate
    L.observe(obs, "rec_out", y)
    return L.row_dense(y, p["wo"], R, mesh), new_state


def init_state(cfg, batch: int, dtype=torch.float32, device=None,
               mesh=None) -> dict:
    """A fresh decode state: the rank's channels on a tensor-parallel
    ``mesh``."""
    R = local_width(cfg, mesh)
    return {"h": torch.zeros((batch, R), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, R), dtype=dtype,
                                device=device)}
