"""xLSTM blocks (port of ``repro.models.xlstm``): the mLSTM (matrix memory,
chunkwise-parallel) and the sLSTM (scalar memory, a sequential loop).

The mLSTM recurrence runs chunk by chunk: inside a chunk of
:data:`MLSTM_CHUNK` steps it is an attention-like product under a masked
decay matrix, and the (C, n, m) state is handed from chunk to chunk; a
one-token step (decode) updates the state directly. The sLSTM has a real
nonlinearity between steps, so its gate GEMMs run for every step at once
and only the elementwise cell and the per-head recurrent matvec run in the
loop over S.

The cells run in float32 with max-stabilized exponential gates, the stored
state already absorbing its stabilizer m. They are never quantized; the
blocks' projection GEMMs form the FFN quant group and run on the reference
path under every backend, as in the JAX package, so a fused backend
launches no kernel in these layers.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import divide
from repro_torch.distributed import autograd as dist_ag
from repro_torch.kernels.backend import ACTIVATIONS
from repro_torch.models import layers as L

MLSTM_CHUNK = 256

_silu = ACTIVATIONS["silu"]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg, *, device=None,
               dtype=torch.float32) -> dict:
    D = cfg.d_model
    Dp = int(cfg.proj_factor * D)
    H = cfg.num_heads
    kw = dict(device=device, dtype=dtype)
    return {
        "up": L.init_linear(gen, D, 2 * Dp, False, **kw),
        "conv": L.init_conv1d(gen, cfg.conv_width, Dp, **kw),
        "wq": L.init_linear(gen, Dp, Dp, False, **kw),
        "wk": L.init_linear(gen, Dp, Dp, False, **kw),
        "wv": L.init_linear(gen, Dp, Dp, False, **kw),
        "wif": L.init_linear(gen, Dp, 2 * H, True, **kw),
        "out_norm": L.init_norm("rmsnorm", Dp, **kw),
        "down": L.init_linear(gen, Dp, D, False, **kw),
    }


def _mlstm_chunk(state, q, k, v, log_i, log_f):
    """One chunk. The state tensors absorb their stabilizer m: C_hat =
    C exp(-m), n_hat = n exp(-m).

    state: (C (B, H, dk, dv), n (B, H, dk), m (B, H)); q, k, v
    (B, Lc, H, dh) float32; log_i, log_f (B, Lc, H) float32. Returns
    (new state, h (B, Lc, H, dv))."""
    C_p, n_p, m_p = state
    Lc = q.shape[1]
    b = torch.cumsum(log_f, dim=1)                       # inclusive
    u = torch.cummax(log_i - b, dim=1).values            # running max
    m_t = b + torch.maximum(m_p[:, None, :], u)          # (B, Lc, H)
    bL = b[:, -1, :]
    m_new = bL + torch.maximum(m_p, u[:, -1, :])

    # across chunks: the decayed read of the carried state
    w_inter = torch.exp(b + m_p[:, None, :] - m_t)
    h_inter = torch.einsum("blhk,bhkv->blhv", q, C_p) * w_inter[..., None]
    d_inter = torch.einsum("blhk,bhk->blh", q, n_p) * w_inter

    # within the chunk: the masked decay D_ts = exp(b_t - b_s + li_s - m_t)
    logD = (b[:, :, None, :] - b[:, None, :, :]
            + log_i[:, None, :, :] - m_t[:, :, None, :])  # (B, Lt, Ls, H)
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                device=q.device))
    logD = torch.where(tri[None, :, :, None], logD, -math.inf)
    s = torch.einsum("blhk,bshk->blsh", q, k) * torch.exp(logD)
    h_intra = torch.einsum("blsh,bshv->blhv", s, v)
    d_intra = s.sum(dim=2)

    denom = torch.maximum(torch.abs(d_inter + d_intra), torch.exp(-m_t))
    h = (h_inter + h_intra) / denom[..., None]           # (B, Lc, H, dv)

    # the hand-off to the next chunk
    w_key = torch.exp(bL[:, None, :] - b + log_i - m_new[:, None, :])
    carry = torch.exp(bL + m_p - m_new)
    kw = k * w_key[..., None]
    C_new = (carry[..., None, None] * C_p
             + torch.einsum("bshk,bshv->bhkv", kw, v))
    n_new = carry[..., None] * n_p + kw.sum(dim=1)
    return (C_new, n_new, m_new), h


def _mlstm_step(state, q, k, v, log_i, log_f):
    """One-token recurrent update (decode). q, k, v: (B, H, dh) float32;
    log_i, log_f: (B, H); state = (C, n, m). Returns (new state, h)."""
    C_p, n_p, m_p = state
    m_t = torch.maximum(log_f + m_p, log_i)
    f_ = torch.exp(log_f + m_p - m_t)
    i_ = torch.exp(log_i - m_t)
    C = (f_[..., None, None] * C_p
         + i_[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n = f_[..., None] * n_p + i_[..., None] * k
    d = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q, n)),
                      torch.exp(-m_t))
    h = torch.einsum("bhk,bhkv->bhv", q, C) / d[..., None]
    return (C, n, m_t), h


def _whole_conv(p: dict, C: int, mesh) -> dict:
    """A block's conv with its whole bias: the rules leave the taps whole
    and shard the bias over ``model``."""
    return {"w": p["w"], "b": L.tp_whole(p["b"], C, mesh)}


def _row_out(h: torch.Tensor, p: dict, mesh) -> torch.Tensor:
    """The block's output GEMM (``down``, ``proj``), row-parallel on a
    tensor-parallel mesh: the rank's columns of the whole-width ``h``."""
    K = h.shape[-1]
    return L.row_dense(L.tp_cols(h, p["w"].shape[0], mesh), p, K, mesh)


def mlstm_block(x: torch.Tensor, p: dict, cfg, *,
                obs: Optional[dict] = None, state: Optional[dict] = None,
                active: Optional[torch.Tensor] = None, mesh=None):
    """The mLSTM block (the layer driver adds the residual). x: (B, S, D)
    after norm1. A full sequence needs S <= 256 or a multiple of 256 (the
    chunk). Returns (out, new_state or None).

    On a tensor-parallel ``mesh`` a rank runs its block of the heads
    (:func:`local_heads`): ``wq``, ``wk`` and ``wv`` are column-parallel on
    head boundaries. ``up`` (its split falls between ``xm`` and ``z``, not
    on heads) and ``wif`` (input gates of every head, then forget gates)
    are computed whole, their columns all-gathered; the conv runs whole.
    The rank's cells run on its heads; their outputs are all-gathered for
    ``out_norm``, whose RMS runs over the whole row, and ``down`` is
    row-parallel. The state holds the rank's heads."""
    B, S, D = x.shape
    Dp = int(cfg.proj_factor * D)
    H = cfg.num_heads
    dh = Dp // H
    Hl = local_heads(cfg, mesh)
    h0 = mesh.coords["model"] * Hl if Hl != H else 0
    f32 = torch.float32
    L.observe(obs, "blk_in", x)
    up = L.tp_whole(L.tp_dense(x, p["up"], 2 * Dp, mesh), 2 * Dp, mesh)
    xm, z = up[..., :Dp], up[..., Dp:]
    L.observe(obs, "xm", xm)
    conv_state = state["conv"] if state is not None else None
    xc, new_conv = L.causal_conv1d(xm, _whole_conv(p["conv"], Dp, mesh),
                                   conv_state)
    xc = _silu(xc)
    L.observe(obs, "qkv_in", xc)

    def heads(t):
        return L.tp_whole(t, Hl * dh, mesh).reshape(B, S, Hl, dh).to(f32)
    xct = L.tp_in(xc, mesh)
    q = heads(L.tp_dense(xc, p["wq"], Dp, mesh, xct))
    k = divide(heads(L.tp_dense(xc, p["wk"], Dp, mesh, xct)), math.sqrt(dh))
    v = heads(L.tp_dense(xm, p["wv"], Dp, mesh))
    gates = L.tp_whole(L.tp_dense(xc, p["wif"], 2 * H, mesh, xct), 2 * H,
                       mesh).to(f32)
    if Hl != H:
        # the whole gates enter the rank's heads
        gates = dist_ag.copy_to(gates, mesh, "model")
    log_i = gates[..., h0:h0 + Hl]                       # (B, S, Hl)
    log_f = F.logsigmoid(gates[..., H + h0:H + h0 + Hl])

    if state is not None and S == 1:
        (C, n, m), h = _mlstm_step((state["C"], state["n"], state["m"]),
                                  q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                                  log_f[:, 0])
        h = h[:, None]                                   # (B, 1, H, dh)
        new_state = L.select_state(
            {"C": C, "n": n, "m": m, "conv": new_conv}, state, active)
    else:
        Lc = min(MLSTM_CHUNK, S)
        if S % Lc:
            raise ValueError(f"mlstm_block: S={S} is not a multiple of the "
                             f"chunk {Lc}")
        if state is not None:
            carry = (state["C"], state["n"], state["m"])
        else:
            carry = (torch.zeros((B, Hl, dh, dh), dtype=f32,
                                 device=x.device),
                     torch.zeros((B, Hl, dh), dtype=f32, device=x.device),
                     torch.zeros((B, Hl), dtype=f32, device=x.device))
        hs = []
        for c0 in range(0, S, Lc):
            sl = slice(c0, c0 + Lc)
            carry, hc = _mlstm_chunk(carry, q[:, sl], k[:, sl], v[:, sl],
                                    log_i[:, sl], log_f[:, sl])
            hs.append(hc)
        h = torch.cat(hs, dim=1)                         # (B, S, H, dh)
        C, n, m = carry
        new_state = (None if state is None else L.select_state(
            {"C": C, "n": n, "m": m, "conv": new_conv}, state, active))
    h = L.tp_whole(h.to(x.dtype).reshape(B, S, Hl * dh), Dp, mesh)
    h = L.rms_norm(h, p["out_norm"])
    y = h * _silu(z)
    L.observe(obs, "blk_hidden", y)
    return _row_out(y, p["down"], mesh), new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg, *, device=None,
               dtype=torch.float32) -> dict:
    D = cfg.d_model
    H = cfg.num_heads
    dh = D // H
    kw = dict(device=device, dtype=dtype)
    return {
        "conv": L.init_conv1d(gen, cfg.conv_width, D, **kw),
        "wz": L.init_linear(gen, D, D, True, **kw),
        "wi": L.init_linear(gen, D, D, True, **kw),
        "wf": L.init_linear(gen, D, D, True, **kw),
        "wo": L.init_linear(gen, D, D, True, **kw),
        # the per-head recurrent (block-diagonal) matrices, z i f o
        "r": torch.randn((4, H, dh, dh), generator=gen, dtype=torch.float32,
                         device=device) / math.sqrt(dh),
        "out_norm": L.init_norm("rmsnorm", D, **kw),
        "proj": L.init_linear(gen, D, D, False, **kw),
    }


def _slstm_cell(state, pz, pi, pf, po, r: torch.Tensor):
    """One step. state: (c, n, h, m), each (B, H, dh) float32; pz, pi, pf,
    po: the step's gate pre-activations (B, H, dh); r: (4, H, dh, dh).
    Returns the new state (its h is the step's output)."""
    c_p, n_p, h_p, m_p = state
    rec = torch.einsum("ghde,bhd->gbhe", r, h_p)
    z = torch.tanh(pz + rec[0])
    li = pi + rec[1]                                     # log input gate
    lf = F.logsigmoid(pf + rec[2])                       # log forget gate
    o = torch.sigmoid(po + rec[3])
    m_t = torch.maximum(lf + m_p, li)
    i_ = torch.exp(li - m_t)
    f_ = torch.exp(lf + m_p - m_t)
    c = f_ * c_p + i_ * z
    n = torch.maximum(f_ * n_p + i_, torch.exp(-m_t))
    return c, n, o * (c / n), m_t


def slstm_block(x: torch.Tensor, p: dict, cfg, *,
                obs: Optional[dict] = None, state: Optional[dict] = None,
                active: Optional[torch.Tensor] = None, mesh=None):
    """The sLSTM block: the gate GEMMs for every step at once, then the
    cell step by step. Returns (out, new_state or None).

    On a tensor-parallel ``mesh`` a rank runs its block of the heads
    (:func:`local_heads`): ``wz``, ``wi``, ``wf`` and ``wo`` are
    column-parallel on head boundaries, the recurrent ``r`` (whole under
    the rules) is sliced to the rank's heads, the conv runs whole, the
    cells' outputs are all-gathered for ``out_norm`` (an RMS over the whole
    row) and ``proj`` is row-parallel. The state holds the rank's heads."""
    B, S, D = x.shape
    H = cfg.num_heads
    dh = D // H
    Hl = local_heads(cfg, mesh)
    h0 = mesh.coords["model"] * Hl if Hl != H else 0
    f32 = torch.float32
    conv_state = state["conv"] if state is not None else None
    xc, new_conv = L.causal_conv1d(x, _whole_conv(p["conv"], D, mesh),
                                   conv_state)
    xc = _silu(xc)
    L.observe(obs, "blk_in", x)
    L.observe(obs, "blk_conv_in", xc)
    # z and o read the raw input, i and f the conv path
    xt, xct = L.tp_in(x, mesh), L.tp_in(xc, mesh)
    pre = [L.tp_dense(t, p[k], D, mesh, tt)
           for t, tt, k in ((x, xt, "wz"), (xc, xct, "wi"), (xc, xct, "wf"),
                            (x, xt, "wo"))]
    pre = [L.tp_whole(t, Hl * dh, mesh).reshape(B, S, Hl, dh).to(f32)
           for t in pre]
    if state is not None:
        st = (state["c"], state["n"], state["h"], state["m"])
    else:
        zeros = torch.zeros((B, Hl, dh), dtype=f32, device=x.device)
        st = (zeros, torch.ones_like(zeros), zeros, zeros)
    r = L.tp_cols(p["r"], Hl, mesh, dim=1).to(f32)
    hs = []
    for t in range(S):
        st = _slstm_cell(st, *(g[:, t] for g in pre), r)
        hs.append(st[2])
    h = torch.stack(hs, dim=1).reshape(B, S, Hl * dh).to(x.dtype)
    h = L.rms_norm(L.tp_whole(h, D, mesh), p["out_norm"])
    L.observe(obs, "blk_hidden", h)
    out = _row_out(h, p["proj"], mesh)
    new_state = None
    if state is not None:
        c, n, h_last, m = st
        new_state = L.select_state(
            {"c": c, "n": n, "h": h_last, "m": m, "conv": new_conv},
            state, active)
    return out, new_state


# ---------------------------------------------------------------------------
# decode states
# ---------------------------------------------------------------------------


def local_heads(cfg, mesh) -> int:
    """The heads a tensor-parallel rank runs: its block where the model
    axis divides them, else all of them."""
    return L.tp_block(cfg.num_heads, mesh)


def mlstm_state(cfg, batch: int, dtype=torch.float32, device=None,
                mesh=None) -> dict:
    """The mLSTM's decode state: the rank's heads on a tensor-parallel
    ``mesh``, the whole conv window."""
    Dp = int(cfg.proj_factor * cfg.d_model)
    H = local_heads(cfg, mesh)
    dh = Dp // cfg.num_heads
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dh, dh), **kw),
            "n": torch.zeros((batch, H, dh), **kw),
            "m": torch.zeros((batch, H), **kw),
            "conv": torch.zeros((batch, cfg.conv_width - 1, Dp), dtype=dtype,
                                device=device)}


def slstm_state(cfg, batch: int, dtype=torch.float32, device=None,
                mesh=None) -> dict:
    """The sLSTM's decode state (the rank's heads on a tensor-parallel
    ``mesh``); its normalizer n starts at ones."""
    H, dh = local_heads(cfg, mesh), cfg.d_model // cfg.num_heads
    kw = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, H, dh), **kw),
            "n": torch.ones((batch, H, dh), **kw),
            "h": torch.zeros((batch, H, dh), **kw),
            "m": torch.zeros((batch, H, dh), **kw),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_model),
                                dtype=dtype, device=device)}
