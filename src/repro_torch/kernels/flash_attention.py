"""Attention kernels of ``repro.kernels.flash_attention``, ported: the
float online-softmax :func:`flash_attention` and the fully-int8 encoder
attention :func:`quant_flash_attention` with the uint8 softmax epilogue.

:func:`flash_attention` launches the CUDA kernel in
``csrc/flash_attention.cu`` for CUDA tensors and runs
:func:`flash_attention_plain`, the JAX kernel's blockwise online softmax
with its block-skipping rule, for CPU tensors. Positions are ``arange``
from 0 on both axes; ``causal`` keeps keys j <= i, ``window`` keys
j > i - window; a masked entry of a key block that runs is the finite
``NEG_INF``, and a key block whose (bq, bk) tile the JAX grid skips adds
nothing. The output is ``acc / max(l, 1e-30)`` in q's dtype.

:func:`quant_flash_attention` launches ``csrc/quant_flash_attention.cu``
for CUDA tensors and runs :func:`quant_flash_attention_plain`, the same
contract in plain PyTorch, for CPU tensors. Per (batch, query head):

    s = int32(q @ k^T) * (q_scale * k_scale)      (+ softcap), -inf where k_pos < 0
    p = exp(s - max) / sum                         exact float32 softmax
    c = clip(rint(p / p_scale) - 128)              uint8 codes, zero point -128
    o = (int32(c @ v) + 128 * sum(v)) * (p_scale * v_scale)

written as float32, or requantized to int8 at ``o_scale``. The softmax
denominator is summed in the kernel's order (:func:`softmax_sum`), which
sets the last bit of ``p`` and so the codes at ties.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.core.quantize import INT8_MAX, INT8_MIN, divide, int_matmul
from repro_torch.kernels import build
from repro_torch.kernels.addnorm_quant import row_sum

# the mask value of the JAX kernel: finite, so a row whose keys are all
# padding gets a uniform softmax instead of NaN
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# shared memory a block may use on the H100 after opting in
_MAX_SMEM = 232448

#: launches of the quantized kernel since the last
#: :func:`repro_torch.kernels.reset_launches`
launches = 0
#: launches of the float kernel, counted apart
float_launches = 0

# head dims csrc/flash_attention.cu instantiates (a dim in between runs
# zero-padded at the next; a dim over 256 runs the file's wide kernel)
FLOAT_HEAD_DIMS = (16, 32, 64, 128, 256)
FLOAT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# csrc/quant_flash_attention.cu: the row-block kernel's blocks of 32 query
# rows (2 groups of 16, each group's keys over 4 warps) and key tiles of
# 128; both of the file's tensor-core kernels take head dims up to 256, and
# a wider head runs its wide kernel
_QUANT_ROWS, _QUANT_KEYS, _QUANT_KEY_WARPS = 32, 128, 4

Scale = Union[float, torch.Tensor]


def softmax_sum(e: torch.Tensor) -> torch.Tensor:
    """Sum over the key axis in the kernel's order: one warp per query row,
    lane l adding keys l, l + 32, ... in turn, then a butterfly."""
    return row_sum(e, threads=32)


def quant_flash_attention_smem(Sk: int, d: int) -> int:
    """Bytes of shared memory a block of the quantized row-block kernel
    takes for Sk keys of head dim d: ``samp_quant_flash_attention_smem`` of
    ``csrc/quant_flash_attention.cu``, computed here so the wrapper can
    choose a kernel before a launch. The head dim runs at the next of 32,
    64, 128, 256, in rows 16 bytes wider: q rows, a ring of three K / V
    tiles, a float score row per query row over the key axis (padded to
    128, plus 8), k_pos, the key warps' row maxima, the row sums, V's
    column sums, and an int32 accumulator (rows dp + 1 words)."""
    dp = 32
    while dp < d:
        dp *= 2
    rb = dp + 16
    skp = -(-Sk // _QUANT_KEYS) * _QUANT_KEYS
    return ((_QUANT_ROWS + 3 * _QUANT_KEYS) * rb
            + 4 * _QUANT_ROWS * (skp + 8) + 4 * skp
            + 4 * _QUANT_KEY_WARPS * _QUANT_ROWS + 4 * _QUANT_ROWS + 4 * dp
            + 4 * _QUANT_ROWS * (dp + 1))


def quant_flash_attention_tiled(Sk: int, d: int) -> bool:
    """Whether the wrapper runs the long-key kernel: when the row-block
    kernel's scores of the head's whole key axis (head dim padded to a
    multiple of 4) would overflow a block's shared memory."""
    return quant_flash_attention_smem(Sk, -(-d // 4) * 4) > _MAX_SMEM


def float_head_dim(d: int) -> Optional[int]:
    """The instantiated head dim the float kernel runs d at, or None above
    256."""
    return next((w for w in FLOAT_HEAD_DIMS if d <= w), None)


def flash_attention_smem(d: int, dtype: torch.dtype = torch.float32) -> int:
    """Bytes of shared memory a block of the float kernel takes at head dim
    d: ``samp_flash_attention_smem_of`` of ``csrc/flash_attention.cu``
    (float32, the default, takes the most: ``samp_flash_attention_smem``).
    A block holds 64 query rows and a ring of K and V tiles: 64 keys, 32
    where the accumulator is 256 wide or a float32 row 128; 3 stages for
    16-bit inputs up to d = 64, else 2; rows padded by 16 bytes."""
    w = float_head_dim(d)
    if w is None:
        raise ValueError(f"flash_attention: head dim {d} is over "
                         f"{FLOAT_HEAD_DIMS[-1]}")
    size = torch.empty((), dtype=dtype).element_size()
    bk = 32 if w >= 256 or (size == 4 and w >= 128) else 64
    stages = 3 if size == 2 and w <= 64 else 2
    return size * (w + 16 // size) * (64 + 2 * stages * bk)


def _fit_blocks(Sq: int, Sk: int, bq: int, bk: int) -> tuple[int, int]:
    bq, bk = min(bq, Sq), min(bk, Sk)
    if bq <= 0 or bk <= 0 or Sq % bq or Sk % bk:
        raise ValueError(f"flash_attention: Sq={Sq}, Sk={Sk} do not split "
                         f"into blocks of bq={bq}, bk={bk}")
    return bq, bk


def run_rows(Sq: int, bq: int, k_lo: int, bk: int, causal: bool,
             window: Optional[int]) -> tuple[int, int]:
    """The query rows [r0, r1) whose (bq, bk) block against the key block
    starting at ``k_lo`` runs under the JAX kernel's skipping rule (causal:
    k_lo <= q_lo + bq - 1; window: k_lo + bk - 1 > q_lo - window). Both
    rules are monotone in q_lo, so the rows are one range."""
    rows = [qb * bq for qb in range(Sq // bq)
            if (not causal or k_lo <= qb * bq + bq - 1)
            and (window is None or k_lo + bk - 1 > qb * bq - window)]
    if not rows:
        return 0, 0
    return rows[0], rows[-1] + bq


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None, bq: int = 512,
                          bk: int = 512) -> torch.Tensor:
    """The plain-PyTorch contract of :func:`flash_attention`: the JAX
    kernel's online softmax, one (bk)-key block at a time over the query
    rows whose block runs, in float32."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    bq, bk = _fit_blocks(Sq, Sk, bq, bk)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    qs = (q.to(f32) * scale).reshape(B, Hkv, g, Sq, D)
    kf, vf = k.to(f32)[:, :, None], v.to(f32)[:, :, None]
    m = torch.full((B, Hkv, g, Sq, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, Hkv, g, Sq, 1), dtype=f32, device=q.device)
    acc = torch.zeros((B, Hkv, g, Sq, D), dtype=f32, device=q.device)
    for k_lo in range(0, Sk, bk):
        r0, r1 = run_rows(Sq, bq, k_lo, bk, causal, window)
        if r0 == r1:
            continue
        s = torch.matmul(qs[:, :, :, r0:r1],
                         kf[:, :, :, k_lo:k_lo + bk].transpose(-1, -2))
        if softcap is not None:
            s = torch.tanh(divide(s, softcap)) * softcap
        qpos = torch.arange(r0, r1, device=q.device)[:, None]
        kpos = torch.arange(k_lo, k_lo + bk, device=q.device)[None, :]
        keep = torch.ones((r1 - r0, bk), dtype=torch.bool, device=q.device)
        if causal:
            keep = kpos <= qpos
        if window is not None:
            keep = keep & (kpos > qpos - window)
        s = torch.where(keep, s, NEG_INF)
        m_prev = m[..., r0:r1, :]
        m_new = torch.maximum(m_prev, torch.amax(s, dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m_prev - m_new)
        l[..., r0:r1, :] = (l[..., r0:r1, :] * alpha
                            + torch.sum(p, dim=-1, keepdim=True))
        acc[..., r0:r1, :] = (acc[..., r0:r1, :] * alpha
                              + torch.matmul(p, vf[:, :, :, k_lo:k_lo + bk]))
        m[..., r0:r1, :] = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d) with Hq % Hkv == 0, all of
    one float dtype (float32, bfloat16 or float16). ``bq`` and ``bk``
    (capped at Sq and Sk, dividing them) set which key blocks run, as in
    the JAX kernel. ``causal`` defaults off. A head dim over 256 runs the
    file's wide kernel (a warp a query row, 256 output columns a block).
    Returns (B, Hq, Sq, d) in q's dtype."""
    global float_launches
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              bq=bq, bk=bk)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    name = "flash_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be (B, H, S, d) with k "
                         f"and v alike")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not attend over "
                         f"k {tuple(k.shape)} (batch, dim, Hq % Hkv)")
    if q.dtype not in FLOAT_DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} is not one of "
                         f"{sorted(map(str, FLOAT_DTYPES))}")
    bq, bk = _fit_blocks(Sq, Sk, bq, bk)
    dev = q.device
    for arg, t in (("q", q), ("k", k), ("v", v)):
        build.operand(name, arg, t, q.dtype, dev)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    P, I, F = build.P, build.I, build.F
    fn = build.function("samp_flash_attention",
                        (P,) * 4 + (I,) * 13 + (F, F, P))
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                FLOAT_DTYPES[q.dtype], B, Hq, Hkv, Sq, Sk, D, bq, bk,
                int(causal), int(window is not None),
                int(window) if window is not None else 0,
                int(softcap is not None),
                float(softcap) if softcap is not None else 0.0,
                float(scale), build.stream(dev))
    build.check(rc, name)
    float_launches += 1
    return out


def _scalar(v: Scale, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def quant_flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, k_pos: torch.Tensor, *,
                                q_scale: Scale, k_scale: Scale,
                                p_scale: Scale, v_scale: Scale,
                                o_scale: Optional[Scale] = None,
                                softcap: Optional[float] = None
                                ) -> torch.Tensor:
    """The plain-PyTorch contract of :func:`quant_flash_attention`."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    qs, ks, ps, vs = (_scalar(x, q) for x in (q_scale, k_scale, p_scale,
                                                v_scale))
    s = int_matmul(q, k.transpose(-1, -2)).to(torch.float32) * (qs * ks)
    if softcap is not None:
        s = torch.tanh(divide(s, softcap)) * softcap
    valid = k_pos.reshape(-1, 1, 1, Sk).to(torch.int32) >= 0
    s = torch.where(valid, s, NEG_INF)
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = e / softmax_sum(e)
    codes = torch.clamp(torch.round(p / ps) + INT8_MIN, INT8_MIN, INT8_MAX)
    vsum = v.to(torch.int32).sum(dim=2, keepdim=True)
    acc = int_matmul(codes.to(torch.int8), v) - INT8_MIN * vsum
    o = acc.to(torch.float32) * (ps * vs)
    if o_scale is not None:
        o = torch.round(o / _scalar(o_scale, q))
        return torch.clamp(o, INT8_MIN, INT8_MAX).to(torch.int8)
    return o


def quant_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_pos: torch.Tensor, *, q_scale: Scale,
                          k_scale: Scale, p_scale: Scale, v_scale: Scale,
                          o_scale: Optional[Scale] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d) int8, quantized from ``q * rsqrt(d)`` at
    ``q_scale``; k, v: (B, Hkv, Sk, d) int8 with Hq % Hkv == 0; k_pos:
    (B, Sk) or (Sk,) int32 key positions, -1 = padding. The scales are
    scalar operands. A head dim over 256 runs the file's wide kernel (a
    warp a query row, 256 output columns a block), with the same bits.
    Returns (B, Hq, Sq, d) float32, or int8 when ``o_scale`` is given."""
    global launches
    kw = dict(q_scale=q_scale, k_scale=k_scale, p_scale=p_scale,
              v_scale=v_scale, o_scale=o_scale, softcap=softcap)
    if q.device.type == "cpu":
        return quant_flash_attention_plain(q, k, v, k_pos, **kw)
    name = "quant_flash_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be (B, H, S, d) with k "
                         f"and v alike")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not attend over "
                         f"k {tuple(k.shape)} (batch, dim, Hq % Hkv)")
    dev = q.device
    for arg, t in (("q", q), ("k", k), ("v", v)):
        build.operand(name, arg, t, torch.int8, dev)
    if k_pos.numel() not in (Sk, B * Sk):
        raise ValueError(f"{name}: k_pos has {k_pos.numel()} values for "
                         f"B={B}, Sk={Sk}")
    if k_pos.device != dev:
        raise ValueError(f"{name}: k_pos is on {k_pos.device}, the kernel "
                         f"runs on {dev}")
    kp = torch.broadcast_to(k_pos.reshape(-1, Sk).to(torch.int32),
                            (B, Sk)).contiguous()
    # the kernels copy rows 4 bytes at a time at least: a head dim in
    # between runs with zero dims appended, which leave every integer dot
    # unchanged
    D4 = -(-D // 4) * 4
    if D4 != D:
        q, k, v = (torch.nn.functional.pad(t, (0, D4 - D)) for t in (q, k, v))
    tiled = quant_flash_attention_tiled(Sk, D4)
    scales = [build.scalar(name, n, x, dev) for n, x in (
        ("q_scale", q_scale), ("k_scale", k_scale), ("p_scale", p_scale),
        ("v_scale", v_scale))]
    requant = o_scale is not None
    os_ = build.scalar(name, "o_scale", o_scale, dev) if requant else None
    out = torch.empty((B, Hq, Sq, D4),
                      dtype=torch.int8 if requant else torch.float32,
                      device=dev)
    P, I = build.P, build.I
    fn = build.function("samp_quant_flash_attention",
                        (P,) * 11 + (I,) * 7 + (build.F, I, P))
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kp.data_ptr(),
                *(s.data_ptr() for s in scales),
                os_.data_ptr() if requant else None,
                None if requant else out.data_ptr(),
                out.data_ptr() if requant else None,
                B, Hq, Hkv, Sq, Sk, D4, int(softcap is not None),
                float(softcap) if softcap is not None else 0.0, int(tiled),
                build.stream(dev))
    build.check(rc, name)
    launches += 1
    return out if D4 == D else out[..., :D].contiguous()
