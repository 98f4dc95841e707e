"""Plain PyTorch version of the bucket top-C kernel — the port of
``repro/core/retrieval.py:select_candidates_bucket``, vectorized over rows."""
from __future__ import annotations

import torch


def bucket_topk_ref(scores: torch.Tensor, k: int,
                    score_range: int) -> torch.Tensor:
    """scores (..., n) int in [-1, score_range] → (..., k) int32 indices:
    all scores above the threshold plus the lowest-index ties up to the
    quota, ascending — ``lax.top_k``'s index set and tie rule."""
    rng = score_range + 2
    lead, n = scores.shape[:-1], scores.shape[-1]
    s = (scores.reshape(-1, n) + 1).long()
    rows = s.shape[0]
    inb = (s >= 0) & (s < rng)
    hist = torch.zeros((rows, rng), dtype=torch.long, device=s.device)
    hist.scatter_add_(1, s.clamp(0, rng - 1), inb.long())
    desc = hist.flip(-1)
    meets = desc.cumsum(-1) >= k
    t_rev = meets.to(torch.uint8).argmax(-1)          # first bin meeting k
    thresh = (rng - 1 - t_rev)[:, None]
    quota = k - torch.where(meets, 0, desc).sum(-1, keepdim=True)
    is_tie = s == thresh
    tie_rank = is_tie.long().cumsum(-1) - 1
    take = (s > thresh) | (is_tie & (tie_rank < quota))
    dest = take.long().cumsum(-1) - 1
    out = torch.zeros((rows, k + 1), dtype=torch.int32, device=s.device)
    slot = torch.where(take & (dest < k), dest, k)    # column k = dropped
    pos = torch.arange(n, dtype=torch.int32, device=s.device).expand(rows, n)
    out.scatter_(1, slot, pos)
    return out[:, :k].reshape(lead + (k,))
