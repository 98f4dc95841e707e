"""Plain PyTorch version of the paged Stage-I collision kernel."""
from __future__ import annotations

import torch


def collision_paged_ref(pool_ids: torch.Tensor, block_tables: torch.Tensor,
                        tables: torch.Tensor, enc_end: torch.Tensor,
                        sink_size: int) -> torch.Tensor:
    """pool_ids (nb, G, bs, B) uint8, block_tables (b, nblk) int32,
    tables (b, G, Hg, B, nc) int32, enc_end (b,) int32 →
    (b, G, Hg, nblk·bs) int32 scores, -1 outside [sink_size, enc_end)."""
    nb, G, bs, B = pool_ids.shape
    b, nblk = block_tables.shape
    Hg, nc = tables.shape[2], tables.shape[-1]
    n = nblk * bs
    ids = pool_ids[block_tables.clamp(0, nb - 1).long()]   # (b, nblk, G, bs, B)
    ids = ids.permute(0, 2, 1, 3, 4).reshape(b, G, 1, n * B).long()
    offsets = torch.arange(B, device=ids.device).repeat(n) * nc
    idx = (ids + offsets).expand(b, G, Hg, n * B)
    per_key = tables.reshape(b, G, Hg, B * nc).gather(-1, idx)
    scores = per_key.reshape(b, G, Hg, n, B).sum(-1).to(torch.int32)
    pos = torch.arange(n, device=ids.device)
    valid = (pos[None] >= sink_size) & (pos[None] < enc_end[:, None])
    return torch.where(valid[:, None, None, :], scores, -1)
