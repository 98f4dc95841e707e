"""Plain PyTorch versions of the Stage-I collision kernels (paged and
contiguous)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.bucket_topk.ref import segment_histogram_ref


def collision_paged_ref(pool_ids: torch.Tensor, block_tables: torch.Tensor,
                        tables: torch.Tensor, enc_end: torch.Tensor,
                        sink_size: int, score_range: Optional[int] = None):
    """pool_ids (nb, G, bs, B) uint8, block_tables (b, nblk) int32,
    tables (b, G, Hg, B, nc) uint8 or int32, enc_end (b,) int32 →
    (b, G, Hg, nblk·bs) int32 scores, -1 outside [sink_size, enc_end).
    With ``score_range`` → (scores, their histograms per segment,
    ``segment_histogram_ref(scores, score_range)``)."""
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
    scores = torch.where(valid[:, None, None, :], scores, -1)
    if score_range is None:
        return scores
    return scores, segment_histogram_ref(scores, score_range)


def collision_ref(ids: torch.Tensor, table: torch.Tensor,
                  enc_end: Optional[torch.Tensor] = None,
                  sink_size: int = 0) -> torch.Tensor:
    """Stage-I scores over contiguous id streams: ids (..., n, B) uint8 or
    int, table (..., B, nc) int32, their leading dims broadcast → (..., n)
    int32 with S_i = Σ_s table[s, ids[i, s]] (the reference's
    ``collision_scores_kernel``). With ``enc_end`` (b,) aligned to the first
    leading dim, positions outside [sink_size, enc_end) become -1."""
    n, B = ids.shape[-2:]
    nc = table.shape[-1]
    lead = torch.broadcast_shapes(ids.shape[:-2], table.shape[:-2])
    offsets = torch.arange(B, device=ids.device) * nc
    idx = (ids.long() + offsets).reshape(ids.shape[:-2] + (n * B,))
    flat = table.reshape(table.shape[:-2] + (B * nc,))
    per_key = flat.expand(lead + (B * nc,)).gather(
        -1, idx.expand(lead + (n * B,)))
    scores = per_key.reshape(lead + (n, B)).sum(-1).to(torch.int32)
    if enc_end is None:
        return scores
    pos = torch.arange(n, device=ids.device)
    valid = (pos >= sink_size) & (pos < enc_end[:, None])
    valid = valid.reshape(valid.shape[:1] + (1,) * (len(lead) - 1) + (n,))
    return torch.where(valid, scores, -1)
