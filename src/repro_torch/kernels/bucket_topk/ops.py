"""Wrappers of the bucket top-C kernels (csrc/bucket_topk.cu): the cut
from score histograms per segment (``bucket_topk``) and the histogram pass
(``segment_histogram``) for callers that bring no histograms."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, SEG_LEN
from repro_torch.kernels import build as K
from repro_torch.kernels.bucket_topk.ref import (bucket_topk_ref,
                                                 bucket_topk_segments_ref,
                                                 segment_histogram_ref)


# The cut's grid: one warp per segment to compact, TOPK_WARPS segments per
# block, and every block sums the row's histograms, so more blocks per row
# repeat that sum more often (chip_smoke.py's kernel phase times the other
# grids).
TOPK_WARPS = 32


def _vec(scores: torch.Tensor) -> int:
    """1 when every row may be read with 16-byte loads."""
    return int(scores.shape[-1] % 4 == 0 and scores.data_ptr() % 16 == 0)


def segment_histogram(scores: torch.Tensor, score_range: int) -> torch.Tensor:
    """scores (..., n) int32 in [-1, score_range] → (..., ceil(n / SEG_LEN),
    score_range + 2) int32, the count of each score + 1 per segment of
    SEG_LEN positions. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if scores.device.type == "cpu":
        return segment_histogram_ref(scores, score_range)
    K.check_cuda("bucket_hist", scores)
    if scores.dtype != torch.int32:
        raise TypeError("bucket_hist: expects int32 scores")
    n = scores.shape[-1]
    rows = scores.numel() // n
    nseg = -(-n // SEG_LEN)
    rng = score_range + 2
    hist = torch.empty(scores.shape[:-1] + (nseg, rng), dtype=torch.int32,
                       device=scores.device)
    K.launch("bucket_hist", K.ptr(scores), K.ptr(hist), rows, n, rng,
             SEG_LEN, _vec(scores))
    LAUNCHES["bucket_hist"] += 1
    return hist


def bucket_topk(scores: torch.Tensor, k: int, score_range: int,
                seg_hist: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scores (..., n) int32 in [-1, score_range] → (..., k) int32 indices,
    identical to ``core.retrieval.select_candidates_bucket`` (ties
    lowest-index first, ascending order). Requires k <= n.

    ``seg_hist`` (..., ceil(n / SEG_LEN), score_range + 2) int32 are the
    scores' histograms per segment, as Stage I or ``segment_histogram``
    write them; without them the histogram pass runs first (on the card a
    second launch). CPU tensors take the plain versions; CUDA tensors
    launch the kernels or raise."""
    n = scores.shape[-1]
    if not 0 < k <= n:
        raise ValueError(f"bucket_topk: need 0 < k <= n, got k={k}, n={n}")
    lead = scores.shape[:-1]
    rng = score_range + 2
    if seg_hist is not None and (
            seg_hist.shape != lead + (-(-n // SEG_LEN), rng)
            or seg_hist.dtype != torch.int32):
        raise ValueError(f"bucket_topk: seg_hist {tuple(seg_hist.shape)} "
                         f"{seg_hist.dtype} does not fit scores "
                         f"{tuple(scores.shape)} (segments of {SEG_LEN}, "
                         f"{rng} bins, int32)")
    if scores.device.type == "cpu":
        if seg_hist is None:
            return bucket_topk_ref(scores, k, score_range)
        return bucket_topk_segments_ref(scores, seg_hist, k, score_range)
    if scores.dtype != torch.int32:
        raise TypeError("bucket_topk: expects int32 scores")
    if seg_hist is None:
        seg_hist = segment_histogram(scores, score_range)
    K.check_cuda("bucket_topk", scores, seg_hist)
    rows = scores.numel() // n
    out = torch.empty(lead + (k,), dtype=torch.int32, device=scores.device)
    K.launch("bucket_topk", K.ptr(scores), K.ptr(seg_hist), K.ptr(out), rows,
             n, k, rng, SEG_LEN, _vec(scores), TOPK_WARPS)
    LAUNCHES["bucket_topk"] += 1
    return out
