"""Plain PyTorch version of the paged Stage-II rerank kernel — the port of
``repro/core/retrieval.py:rerank_paged`` (gather by physical pool row, then
Eq. 24, invalid candidates masked to the finite NEG_INF)."""
from __future__ import annotations

import torch

from repro_torch.core import quantizer

NEG_INF = -1e30


def rerank_paged_ref(pool_codes: torch.Tensor, pool_w: torch.Tensor,
                     phys_rows: torch.Tensor, cand_idx: torch.Tensor,
                     q_sub: torch.Tensor, q_norm: torch.Tensor,
                     enc_end: torch.Tensor, sink_size: int, m: int,
                     bits: int = 3) -> torch.Tensor:
    """pool_codes (nb, G, bs, B) int32, pool_w (nb, G, bs, B) f32,
    phys_rows / cand_idx (b, G, Hg, C) int32, q_sub (b, G, Hg, B, m),
    q_norm (b, G, Hg), enc_end (b,) → (b, G, Hg, C) float32."""
    nb, G, bs, B = pool_codes.shape
    rows = phys_rows.long().clamp(0, nb * bs - 1)
    blk, off = rows // bs, rows % bs
    heads = torch.arange(G, device=rows.device)[None, :, None, None]
    codes = pool_codes[blk, heads, off]                   # (b, G, Hg, C, B)
    w = pool_w[blk, heads, off]
    v = quantizer.decode_directions(codes, m, bits)       # (..., C, B, m)
    dots = torch.einsum("...cbm,...bm->...cb", v, q_sub.float())
    est = q_norm[..., None] * (w * dots).sum(-1)
    valid = ((cand_idx >= sink_size)
             & (cand_idx < enc_end[:, None, None, None]))
    return torch.where(valid, est, NEG_INF)
