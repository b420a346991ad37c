"""Fused token + segment + position embedding (port of
``repro.kernels.fused_embed``).

:func:`fused_embed` launches the CUDA kernel in ``csrc/fused_embed.cu`` for
CUDA tensors and runs :func:`fused_embed_plain`, the same contract in plain
PyTorch, for CPU tensors:

    out[i] = tok_table[tokens[i]] + pos_table[positions[i]]
             + seg_table[segments[i]]

Ids are int32 inside both versions, as in the JAX kernel (PyTorch's default
index type is int64; the wrapper converts), and are clamped into their
tables so a bad id cannot read outside one. The JAX kernel's token-row
``scale`` has no caller there (archs that scale embeddings do so after the
sum, in ``embed``) and is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

#: kernel launches since the last :func:`repro_torch.kernels.reset_launches`
launches = 0


def _ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(ids.reshape(-1).to(torch.int32), 0, n - 1)


def fused_embed_plain(tokens: torch.Tensor, tok_table: torch.Tensor,
                      pos_table: torch.Tensor,
                      seg_table: Optional[torch.Tensor],
                      segments: Optional[torch.Tensor], *,
                      positions: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The plain-PyTorch contract of :func:`fused_embed`."""
    N = tokens.shape[0]
    P = pos_table.shape[0]
    if positions is None:
        positions = torch.arange(N, device=tokens.device) % P
    x = tok_table[_ids(tokens, tok_table.shape[0])].to(torch.float32)
    x = x + pos_table[_ids(positions, P)].to(torch.float32)
    if seg_table is not None and segments is not None:
        x = x + seg_table[_ids(segments, seg_table.shape[0])].to(
            torch.float32)
    return x


def fused_embed(tokens: torch.Tensor, tok_table: torch.Tensor,
                pos_table: torch.Tensor, seg_table: Optional[torch.Tensor],
                segments: Optional[torch.Tensor], *,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: (N,) ids (flattened batch*seq); tables (V|P|S, D) float32;
    ``positions`` (N,) rows of ``pos_table`` (default ``arange(N) mod P``);
    ``segments`` (N,) with ``seg_table``, or both None. Returns (N, D)."""
    global launches
    if tokens.device.type == "cpu":
        return fused_embed_plain(tokens, tok_table, pos_table, seg_table,
                                 segments, positions=positions)
    name = "fused_embed"
    if tokens.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {tokens.device}")
    if (seg_table is None) != (segments is None):
        raise ValueError(f"{name}: pass seg_table and segments together")
    dev = tokens.device
    N = tokens.shape[0]
    V, D = tok_table.shape
    P = pos_table.shape[0]
    if positions is None:
        positions = torch.arange(N, device=dev) % P
    for tname, table in (("tok_table", tok_table), ("pos_table", pos_table),
                         ("seg_table", seg_table)):
        if table is None:
            continue
        build.operand(name, tname, table, torch.float32, dev)
        if table.ndim != 2 or table.shape[1] != D:
            raise ValueError(f"{name}: {tname} {tuple(table.shape)} is not "
                             f"(rows, {D})")
    tok_ids = build.operand(name, "tokens", tokens.reshape(-1).to(
        torch.int32).contiguous(), torch.int32, dev)
    pos_ids = build.operand(name, "positions", positions.reshape(-1).to(
        torch.int32).contiguous(), torch.int32, dev)
    seg_ids = (build.operand(name, "segments", segments.reshape(-1).to(
        torch.int32).contiguous(), torch.int32, dev)
        if segments is not None else None)
    for ids_name, ids in (("positions", pos_ids), ("segments", seg_ids)):
        if ids is not None and ids.numel() != N:
            raise ValueError(f"{name}: {ids_name} has {ids.numel()} ids for "
                             f"N={N} tokens")
    S = seg_table.shape[0] if seg_table is not None else 0
    out = torch.empty((N, D), dtype=torch.float32, device=dev)
    tables = [t for t in (tok_table, pos_table, seg_table, out)
              if t is not None]
    vec4 = int(D % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tables))
    P_, I = build.P, build.I
    fn = build.function("samp_fused_embed",
                        (P_, P_, P_, P_, P_, P_, P_, I, I, I, I, I, I, P_))
    with torch.cuda.device(dev):
        rc = fn(tok_ids.data_ptr(), pos_ids.data_ptr(),
                seg_ids.data_ptr() if seg_ids is not None else None,
                tok_table.data_ptr(), pos_table.data_ptr(),
                seg_table.data_ptr() if seg_table is not None else None,
                out.data_ptr(), N, D, V, P, S, vec4, build.stream(dev))
    build.check(rc, name)
    launches += 1
    return out
