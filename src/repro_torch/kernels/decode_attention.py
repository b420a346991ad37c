"""Paged decode attention over an int8 KV pool (port of
``repro.kernels.decode_attention``).

One query token per slot attends over that slot's pages of a shared pool:
keys and values live in ``(num_pages, page_size, Hkv, hd)`` int8 pages, and
row ``b`` of the page table lists slot ``b``'s page ids in token order
(``-1`` = unallocated; any id outside ``[0, num_pages)`` is skipped the
same way). :func:`decode_attention` launches the CUDA kernel in
``csrc/decode_attention.cu`` for CUDA tensors and runs
:func:`decode_attention_plain`, the same contract in plain PyTorch, for CPU
tensors. Per (slot b, KV head h, query row i of the GQA group), over the
slot's live pages j (table entry in ``[0, num_pages)`` and
``lengths[b] > j * page_size``):

    s[t] = (sum_d (q[d] * scale) * k8[t, d]) * k_scale[t]   (+ softcap)
    s[t] = NEG_INF where j * page_size + t >= lengths[b]
    m' = max(m, max_t s);  a = exp(m - m');  p[t] = exp(s[t] - m')
    l = l * a + sum_t p[t];  acc = acc * a + sum_t (p[t] * v_scale[t]) v8[t]
    out = acc / max(l, 1e-30)

``k_scale``/``v_scale`` are per-token scale pages ``(num_pages, page_size,
Hkv)`` or calibrated per-head ``(Hkv,)`` vectors. With ``p_scale`` (the
plan's ``softmax='uint8'``) a first pass takes the exact m and l, and a
second pass quantizes the final probabilities to uint8 codes
``clip(rint(p / p_scale), 0, 255)`` and accumulates
``((codes * p_scale) * v_scale[t]) v8[t]``, already normalized. A slot with
length 0 gets a zero row.

The recurrence runs over splits of :func:`decode_split_pages` consecutive
table entries, each from m = NEG_INF, l = 0, acc = 0, and the splits'
(m_s, l_s, acc_s) combine as m = max_s m_s, w_s = exp(m_s - m),
l = l_0 w_0 + l_1 w_1 + ..., acc = acc_0 w_0 + acc_1 w_1 + ... in split
order (with ``p_scale`` the combined m and l feed pass 2, and the splits'
accs are added in split order); one split is the page-sequential
recurrence. The sums over the head dim and over a page's tokens are taken
in one fixed order, halves added pairwise (:func:`tree_sum`). The kernel
repeats both orders, so the kernel and the plain version round alike. The
reference backend runs this plain version for the decode step the fused
backend gives the kernel (``repro_torch.kernels.backend``), so the two
backends agree on the card, as the norms (``row_sum``) and the uint8
softmax (``softmax_sum``) do.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _MAX_SMEM, NEG_INF

#: kernel launches since the last :func:`repro_torch.kernels.reset_launches`
launches = 0

# the power-of-two head dims and page sizes csrc/decode_attention.cu
# instantiates (a shape in between runs zero-padded at the next; a head dim
# over 256 runs its wide kernel), and the query rows of the GQA group one
# block takes at most
HEAD_DIMS = (16, 32, 64, 128, 256)
PAGE_SIZES = (4, 8, 16, 32, 64, 128)
MAX_BLOCK_ROWS = 32
# the most splits a slot's pages are dealt into (one block each)
MAX_SPLITS = 32

Scale = Union[float, torch.Tensor]


def _width(n: int, widths: tuple) -> Optional[int]:
    return next((w for w in widths if n <= w), None)


def _smem_floats(rows: int, HD: int, PS: int, buffers: int) -> int:
    rs = HD | 1
    return (rows * rs + buffers * PS * rs + 2 * PS + rows * PS + rows * HD
            + 3 * rows + rows * MAX_SPLITS + 1)


def kv_buffers(head_dim: int, page_size: int) -> int:
    """Page buffers a block of the kernel stages K and V in: 2 where a
    block of one query row fits with both, else 1, which K and V share
    (head dim 256 with pages of 128 tokens); the instantiation's
    ``two_buffers`` in ``csrc/decode_attention.cu``."""
    HD, PS = _width(head_dim, HEAD_DIMS), _width(page_size, PAGE_SIZES)
    return 2 if 4 * _smem_floats(1, HD, PS, 2) <= _MAX_SMEM else 1


def decode_attention_smem(rows: int, head_dim: int, page_size: int) -> int:
    """Bytes of shared memory a block of ``rows`` query rows takes:
    ``samp_decode_attention_smem`` of ``csrc/decode_attention.cu`` (0 for a
    head dim over 256 or a page size over 128)."""
    HD, PS = _width(head_dim, HEAD_DIMS), _width(page_size, PAGE_SIZES)
    if rows <= 0 or head_dim <= 0 or page_size <= 0 or not HD or not PS:
        return 0
    return 4 * _smem_floats(rows, HD, PS, kv_buffers(HD, PS))


def decode_split_pages(pages_per_slot: int) -> int:
    """Table entries one split of a slot's pages covers, P: the fewest that
    deal ``pages_per_slot`` into at most :data:`MAX_SPLITS` splits. It
    depends on the table's width alone (not on the card, the page size or
    the lengths), so the plain version repeats the kernel's order
    anywhere."""
    return max(1, -(-pages_per_slot // MAX_SPLITS))


def decode_splits(pages_per_slot: int, split_pages: int) -> int:
    """Splits of ``split_pages`` table entries over a table row (at least
    one, which an empty row leaves empty)."""
    return max(1, -(-pages_per_slot // split_pages))


def block_rows(head_dim: int, page_size: int, group: int) -> int:
    """The query rows of a GQA group one block of the kernel takes: the
    group split into the fewest equal chunks of at most
    :data:`MAX_BLOCK_ROWS` rows whose block fits the shared memory; 0 when
    not even one row fits."""
    if group <= 0:
        return 0
    for n in range(-(-group // MAX_BLOCK_ROWS), group + 1):
        rows = -(-group // n)
        smem = decode_attention_smem(rows, head_dim, page_size)
        if 0 < smem <= _MAX_SMEM:
            return rows
    return 0


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` in the kernel's order: zero-padded to a power of
    two, then halves added pairwise (``x[:n/2] + x[n/2:]``) until one value
    is left. Keeps no summed dim."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


def decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, per_head: bool,
                           scale: Optional[float] = None,
                           softcap: Optional[float] = None,
                           p_scale: Optional[Scale] = None,
                           split_pages: Optional[int] = None) -> torch.Tensor:
    """The plain-PyTorch contract of :func:`decode_attention`: the same
    per-page online recurrence within each split of ``split_pages`` table
    entries (default :func:`decode_split_pages`; ``pages_per_slot`` gives
    one split, the page-sequential order), one page of every split of
    every slot at a time, and the kernel's combine of the splits."""
    B, Hkv, g, hd = q.shape
    NP, ps = k_pages.shape[:2]
    pps = page_table.shape[1]
    if scale is None:
        scale = float(hd) ** -0.5
    P = split_pages or decode_split_pages(pps)
    S = decode_splits(pps, P)
    dev = q.device
    f32 = torch.float32
    qs = (q.to(f32) * scale)[:, None, :, :, None, :]  # (B, 1, Hkv, g, 1, hd)
    lengths = lengths.to(torch.int32)
    # table entry j = s P + jj of split s at [:, s, jj]; -1 past the row
    table = torch.nn.functional.pad(page_table.to(torch.int64),
                                    (0, S * P - pps), value=-1).reshape(
                                        B, S, P)
    first = torch.arange(S, device=dev) * P            # each split's first j
    tok0 = torch.arange(ps, device=dev)
    if per_head:
        ks_head = k_scale.to(f32).reshape(1, 1, Hkv, 1, 1)
        vs_head = v_scale.to(f32).reshape(1, 1, Hkv, 1, 1)
    if p_scale is not None:
        p_scale = torch.as_tensor(p_scale, dtype=f32, device=dev)

    def page(jj: int):
        """Entry jj of every split: (live, scores, v scales, values), with
        (B, S, Hkv, g, ...) leading dims."""
        pg = table[:, :, jj]
        j = first + jj                                       # (S,)
        live = ((pg >= 0) & (pg < NP)
                & (lengths[:, None] > j * ps))[:, :, None, None, None]
        safe = torch.clamp(pg, 0, NP - 1)
        kf = k_pages[safe].to(f32).permute(0, 1, 3, 2, 4)   # (B,S,Hkv,ps,hd)
        vf = v_pages[safe].to(f32).permute(0, 1, 3, 2, 4)
        s = tree_sum(qs * kf[:, :, :, None], -1)          # (B,S,Hkv,g,ps)
        if per_head:
            s, vs = s * ks_head, vs_head
        else:
            s = s * k_scale[safe].to(f32).permute(0, 1, 3, 2)[:, :, :, None]
            vs = v_scale[safe].to(f32).permute(0, 1, 3, 2)[:, :, :, None]
        if softcap is not None:
            s = torch.tanh(s / torch.full((), softcap, dtype=f32,
                                          device=dev)) * softcap
        valid = ((j[:, None] * ps + tok0)[None, :, None, None, :]
                 < lengths[:, None, None, None, None])
        return live, torch.where(valid, s, NEG_INF), vs, vf

    def pv(w: torch.Tensor, vf: torch.Tensor) -> torch.Tensor:
        # (B, S, Hkv, g, ps) weights against (B, S, Hkv, ps, hd) values
        return tree_sum(w[..., None] * vf[:, :, :, None], -2)

    m = torch.full((B, S, Hkv, g, 1), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, S, Hkv, g, 1), dtype=f32, device=dev)
    acc = torch.zeros((B, S, Hkv, g, hd), dtype=f32, device=dev)
    for jj in range(P):
        live, s, vs, vf = page(jj)
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = torch.where(live, l * alpha + tree_sum(p, -1)[..., None], l)
        if p_scale is None:
            acc = torch.where(live, acc * alpha + pv(p * vs, vf), acc)
        m = torch.where(live, m_new, m)
    # the combine, in split order from the first term
    if S > 1:
        m_all = torch.amax(m, dim=1)
        w = torch.exp(m - m_all[:, None])
        l_all = l[:, 0] * w[:, 0]
        for i in range(1, S):
            l_all = l_all + l[:, i] * w[:, i]
    else:
        m_all, l_all = m[:, 0], l[:, 0]
    denom = torch.clamp(l_all, min=1e-30)
    if p_scale is None:
        out = acc[:, 0] * w[:, 0] if S > 1 else acc[:, 0]
        for i in range(1, S):
            out = out + acc[:, i] * w[:, i]
        return out / denom
    # pass 2: the codes are defined on the final probabilities
    for jj in range(P):
        live, s, vs, vf = page(jj)
        p = torch.exp(s - m_all[:, None]) / denom[:, None]
        codes = torch.clamp(torch.round(p / p_scale), 0, 255)
        acc = torch.where(live, acc + pv((codes * p_scale) * vs, vf), acc)
    out = acc[:, 0]
    for i in range(1, S):
        out = out + acc[:, i]
    return out


def paged_operands(q: torch.Tensor, kv_cache: dict, pages: torch.Tensor, *,
                   positions: torch.Tensor, active: Optional[torch.Tensor],
                   static_scales: Optional[dict] = None) -> Optional[dict]:
    """The kernel's operands for one decode step of a paged cache: q
    (B, 1, Hq, hd) folded to (B, Hkv, g, hd), ``lengths = pos + 1`` (the
    token written this step included), 0 for inactive slots, and the
    per-token scale pages or the per-head static scales. None when the
    pages are not int8 (float pages keep the gather path), a per-head
    scale is missing, or the step is not one token per slot."""
    k, v = kv_cache.get("pages_k"), kv_cache.get("pages_v")
    if k is None or v is None or k.dtype != torch.int8:
        return None
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if S != 1 or Hq % Hkv:
        return None
    if "pages_ks" in kv_cache:
        ks, vs, per_head = kv_cache["pages_ks"], kv_cache["pages_vs"], False
    else:
        sc = static_scales or {}
        if "k" not in sc or "v" not in sc:
            return None
        ks = sc["k"].to(torch.float32).reshape(-1).contiguous()
        vs = sc["v"].to(torch.float32).reshape(-1).contiguous()
        per_head = True
    pos = positions.to(torch.int32)
    pos = (torch.broadcast_to(pos.reshape(-1)[:1], (B,)) if pos.ndim == 1
           else pos[:, 0])
    lengths = pos + 1
    if active is not None:
        lengths = torch.where(active, lengths, 0)
    return {"q": q[:, 0].reshape(B, Hkv, Hq // Hkv, hd).contiguous(),
            "k_pages": k, "v_pages": v,
            "page_table": pages.to(torch.int32).contiguous(),
            "lengths": lengths.to(torch.int32).contiguous(),
            "k_scale": ks, "v_scale": vs, "per_head": per_head}


def decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, page_table: torch.Tensor,
                     lengths: torch.Tensor, *, k_scale: torch.Tensor,
                     v_scale: torch.Tensor, per_head: bool,
                     scale: Optional[float] = None,
                     softcap: Optional[float] = None,
                     p_scale: Optional[Scale] = None) -> torch.Tensor:
    """q: (B, Hkv, g, hd) float32, query head ``h * g + i`` sharing KV head
    h; k_pages, v_pages: (num_pages, page_size, Hkv, hd) int8; page_table:
    (B, pages_per_slot) int32, -1 (or any id outside [0, num_pages)) =
    unallocated, skipped; lengths: (B,) int32, the
    valid tokens of each slot (0 disables it); k_scale, v_scale: float32
    (num_pages, page_size, Hkv) scale pages, or (Hkv,) when ``per_head``;
    ``scale`` defaults to hd ** -0.5; ``p_scale`` (a scalar) selects the
    two-pass uint8 softmax. A block takes :func:`decode_split_pages`
    table entries of a slot; a head dim over 256 runs the file's wide
    kernel, a block per query row and 256 output columns, over every split
    in the same orders. Returns (B, Hkv, g, hd) float32."""
    global launches
    kw = dict(k_scale=k_scale, v_scale=v_scale, per_head=per_head,
              scale=scale, softcap=softcap, p_scale=p_scale)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_pages, v_pages, page_table,
                                      lengths, **kw)
    name = "decode_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.ndim != 4 or k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} must be (B, Hkv, g, "
                         f"hd) and the pages (NP, ps, Hkv, hd) alike, got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    B, Hkv, g, hd = q.shape
    NP, ps = k_pages.shape[:2]
    if k_pages.shape[2:] != (Hkv, hd):
        raise ValueError(f"{name}: pages {tuple(k_pages.shape)} do not hold "
                         f"{Hkv} heads of {hd}")
    # a head dim over 256 runs the wide kernel (any page size), which
    # takes no block rows and combines the splits itself
    wide = hd > HEAD_DIMS[-1]
    rows = 1 if wide else block_rows(hd, ps, g)
    if not rows:
        raise ValueError(f"{name}: page size {ps} at head dim {hd} is not "
                         f"built (pages up to {PAGE_SIZES[-1]} tokens that "
                         f"fit a block's shared memory)")
    if page_table.ndim != 2 or page_table.shape[0] != B:
        raise ValueError(f"{name}: page_table {tuple(page_table.shape)} is "
                         f"not (B={B}, pages_per_slot)")
    pps = page_table.shape[1]
    dev = q.device
    build.operand(name, "q", q, torch.float32, dev)
    build.operand(name, "k_pages", k_pages, torch.int8, dev)
    build.operand(name, "v_pages", v_pages, torch.int8, dev)
    build.operand(name, "page_table", page_table, torch.int32, dev)
    build.operand(name, "lengths", lengths, torch.int32, dev)
    if lengths.shape != (B,):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)} is not "
                         f"(B={B},)")
    want = (Hkv,) if per_head else (NP, ps, Hkv)
    for arg, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        build.operand(name, arg, t, torch.float32, dev)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} is not "
                             f"{want}")
    if scale is None:
        scale = float(hd) ** -0.5
    quant_p = p_scale is not None
    ps_t = build.scalar(name, "p_scale", p_scale, dev) if quant_p else None
    split = decode_split_pages(pps)
    splits = decode_splits(pps, split)
    out = torch.empty((B, Hkv, g, hd), dtype=torch.float32, device=dev)
    work = counters = None
    if splits > 1 and not wide:  # the splits' partials, a counter a group
        groups = B * Hkv * -(-g // rows)
        work = torch.empty(groups * splits * rows * (2 + hd),
                           dtype=torch.float32, device=dev)
        counters = torch.zeros(groups, dtype=torch.int32, device=dev)
    P, I, F = build.P, build.I, build.F
    fn = build.function("samp_decode_attention",
                        (P,) * 9 + (I,) * 10 + (F, I, F, I, P, P, P))
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(),
                ps_t.data_ptr() if quant_p else None, out.data_ptr(),
                B, Hkv, g, rows, hd, ps, pps, NP, int(per_head),
                int(quant_p),
                float(scale), int(softcap is not None),
                float(softcap) if softcap is not None else 0.0, split,
                work.data_ptr() if work is not None else None,
                counters.data_ptr() if counters is not None else None,
                build.stream(dev))
    build.check(rc, name)
    launches += 1
    return out

