"""Wrapper of the bucket top-C kernel (csrc/bucket_topk.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build as K
from repro_torch.kernels.bucket_topk.ref import bucket_topk_ref


def bucket_topk(scores: torch.Tensor, k: int,
                score_range: int) -> torch.Tensor:
    """scores (..., n) int32 in [-1, score_range] → (..., k) int32 indices,
    identical to ``core.retrieval.select_candidates_bucket`` (ties
    lowest-index first, ascending order). Requires k <= n. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    n = scores.shape[-1]
    if not 0 < k <= n:
        raise ValueError(f"bucket_topk: need 0 < k <= n, got k={k}, n={n}")
    if scores.device.type == "cpu":
        return bucket_topk_ref(scores, k, score_range)
    K.check_cuda("bucket_topk", scores)
    if scores.dtype != torch.int32:
        raise TypeError("bucket_topk: expects int32 scores")
    lead = scores.shape[:-1]
    rows = scores.numel() // n
    out = torch.empty(lead + (k,), dtype=torch.int32, device=scores.device)
    K.launch("bucket_topk", K.ptr(scores), K.ptr(out), rows, n, k,
             score_range + 2)
    LAUNCHES["bucket_topk"] += 1
    return out
