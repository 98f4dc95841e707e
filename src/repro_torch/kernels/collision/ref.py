"""Plain PyTorch versions of the Stage-I collision kernel (over a paged
pool, or a contiguous store through its one-block-per-row table) and of
the bucket histogram of a contiguous store's retrieval region or of a span
of logical positions through a block table."""
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


def bucket_histogram(ids: torch.Tensor, valid: torch.Tensor,
                     num_buckets: int) -> torch.Tensor:
    """Count keys per centroid bucket (the reference's
    ``core/retrieval.py:bucket_histogram``). ids (..., n, B), valid
    broadcastable to (..., n) → (..., B, 2^m) int32."""
    lead = ids.shape[:-2]
    n, B = ids.shape[-2], ids.shape[-1]
    ids_t = ids.transpose(-1, -2).reshape(-1, n).long()
    upd = torch.broadcast_to(valid[..., None, :], lead + (B, n))
    counts = torch.zeros((ids_t.shape[0], num_buckets), dtype=torch.int32,
                         device=ids.device)
    counts.scatter_add_(1, ids_t, upd.reshape(-1, n).to(torch.int32))
    return counts.reshape(lead + (B, num_buckets))


def bucket_count_ref(ids: torch.Tensor, enc_end: torch.Tensor,
                     sink_size: int, num_buckets: int,
                     stride: int = 1) -> torch.Tensor:
    """ids (b, G, n, B), enc_end (b,) → (b, G, B, num_buckets) int32: the
    bucket histogram of each row's [sink_size, enc_end), over the positions
    p ≡ 0 (mod ``stride``) only and scaled back by ``stride`` (the
    reference's strided ``hist_sample``)."""
    n = ids.shape[-2]
    pos = torch.arange(n, device=ids.device)
    valid = (pos >= sink_size) & (pos < enc_end[:, None])       # (b, n)
    counts = bucket_histogram(ids[:, :, ::stride], valid[:, None, ::stride],
                              num_buckets)
    return counts * stride if stride > 1 else counts


def bucket_count_span_ref(pool_ids: torch.Tensor, block_tables: torch.Tensor,
                          lo: int, hi: int, num_buckets: int) -> torch.Tensor:
    """pool_ids (nb, G, bs, B), block_tables (b, nblk) → (b, G, B,
    num_buckets) int32: the bucket histogram of each row's logical
    positions [lo, hi) under allocated blocks (the reference's
    ``core/cache.py:paged_fill_hist_update`` increment)."""
    nb, G, bs, B = pool_ids.shape
    nblk = block_tables.shape[1]
    lidx = torch.arange(lo, hi, device=pool_ids.device)
    blk = torch.div(lidx, bs, rounding_mode="floor")
    pb = block_tables.long()[:, blk.clamp_max(nblk - 1)]        # (b, L)
    inc = (blk < nblk)[None] & (pb >= 0)
    flat = pool_ids.transpose(1, 2).reshape(nb * bs, G, B)
    ids = flat[pb.clamp(0, nb - 1) * bs + lidx % bs].transpose(1, 2)
    return bucket_histogram(ids, inc[:, None, :], num_buckets)
