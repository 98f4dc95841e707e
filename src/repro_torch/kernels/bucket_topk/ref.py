"""Plain PyTorch versions of the bucket top-C kernels: the port of
``repro/core/retrieval.py:select_candidates_bucket``, vectorized over rows
(``bucket_topk_ref``), and the decomposition the kernel runs: histograms
per segment (``segment_histogram_ref``) and the cut from them
(``bucket_topk_segments_ref``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import SEG_LEN


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


def _segments(s: torch.Tensor) -> torch.Tensor:
    """(rows, n) → (rows, nseg, SEG_LEN), the ragged last segment padded
    with -1: no bin counts it and no threshold (>= 0) takes it."""
    rows, n = s.shape
    nseg = -(-n // SEG_LEN)
    padded = torch.full((rows, nseg * SEG_LEN), -1, dtype=s.dtype,
                        device=s.device)
    padded[:, :n] = s
    return padded.reshape(rows, nseg, SEG_LEN)


def segment_histogram_ref(scores: torch.Tensor,
                          score_range: int) -> torch.Tensor:
    """scores (..., n) int in [-1, score_range] → (..., nseg, score_range +
    2) int32: per segment of SEG_LEN consecutive positions (nseg =
    ceil(n / SEG_LEN)), the count of each score + 1."""
    rng = score_range + 2
    lead, n = scores.shape[:-1], scores.shape[-1]
    s = _segments((scores.reshape(-1, n) + 1).long())
    rows, nseg, _ = s.shape
    inb = (s >= 0) & (s < rng)
    idx = torch.arange(nseg, device=s.device)[None, :, None] * rng \
        + s.clamp(0, rng - 1)
    hist = torch.zeros((rows, nseg * rng), dtype=torch.int32, device=s.device)
    hist.scatter_add_(1, idx.reshape(rows, -1), inb.reshape(rows, -1).int())
    return hist.reshape(lead + (nseg, rng))


def bucket_topk_segments_ref(scores: torch.Tensor, seg_hist: torch.Tensor,
                             k: int, score_range: int) -> torch.Tensor:
    """The top-C cut from histograms per segment, with the kernel's
    arithmetic: the threshold and tie quota from the summed histograms;
    each segment's output offset and tie rank from the (above, tie) counts
    of the segments before it; inside a segment, ranks in index order.
    seg_hist (..., nseg, score_range + 2) as ``segment_histogram_ref``
    makes it → the same (..., k) int32 indices as ``bucket_topk_ref``."""
    rng = score_range + 2
    lead, n = scores.shape[:-1], scores.shape[-1]
    s = _segments((scores.reshape(-1, n) + 1).long())
    rows, nseg, _ = s.shape
    h = seg_hist.reshape(rows, nseg, rng).long()
    desc = h.sum(1).flip(-1)
    meets = desc.cumsum(-1) >= k
    thresh = rng - 1 - meets.to(torch.uint8).argmax(-1)           # (rows,)
    quota = k - torch.where(meets, 0, desc).sum(-1)
    above = (h * (torch.arange(rng, device=s.device) > thresh[:, None]
                  )[:, None]).sum(-1)                             # (rows, nseg)
    ties = h.gather(2, thresh[:, None, None].expand(rows, nseg, 1))[..., 0]
    above_before = above.cumsum(1) - above
    tie_before = ties.cumsum(1) - ties
    offset = above_before + torch.minimum(tie_before, quota[:, None])
    t, q = thresh[:, None, None], quota[:, None, None]
    is_tie = s == t
    tie_rank = tie_before[..., None] + is_tie.long().cumsum(-1) - is_tie.long()
    take = (s > t) | (is_tie & (tie_rank < q))
    dest = offset[..., None] + take.long().cumsum(-1) - take.long()
    out = torch.zeros((rows, k + 1), dtype=torch.int32, device=s.device)
    slot = torch.where(take & (dest < k), dest, k).reshape(rows, -1)
    pos = torch.arange(nseg * SEG_LEN, dtype=torch.int32,
                       device=s.device).expand(rows, -1)
    out.scatter_(1, slot, pos)
    return out[:, :k].reshape(lead + (k,))
