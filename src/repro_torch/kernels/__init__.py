"""Hand-written Hopper kernels for the hot paths of ParisKV decode.

  collision/    Stage-I tier-weight accumulation over the paged id pool
                (collision_paged; a contiguous id store is a pool of one
                block per batch row, ``row_tables``), and the bucket
                histogram of a contiguous store's retrieval region
                (bucket_count)
  bucket_topk/  top-C: threshold from score histograms per segment, then
                an ordered compaction (bucket_topk); the histogram pass
                (bucket_hist) for callers that bring no histograms
  rerank/       Stage II with the final top-k (rerank_topk_paged): RSQ-IP
                of the candidates, their codes read through the block table,
                then the top-k in lax.top_k's order with the winners'
                physical rows and blocks (a contiguous store is a pool of
                one block per batch row)
  gather_kv/    K/V row gather through the block table (gather_rows_paged:
                on decode the sink, window and winner rows in one launch;
                promotion rows by logical position; over a paged pool or a
                contiguous store through ``row_tables``); the tiered winner
                gather (gather_rows_tiered) reads staged rows from HBM and
                missed rows from pinned host memory

Each subpackage has ``ops.py`` (the wrapper) and ``ref.py`` (the plain
PyTorch version). A wrapper takes the plain version only for CPU tensors;
for CUDA tensors it launches the CUDA C++ kernel from ``repro_torch/csrc``
(built at first use, ``kernels/build.py``) or raises. Every launch adds one
to ``LAUNCHES[name]`` so a run can show that its main path went through the
kernels.

The hand-off from Stage I to the top-C cut: the paged Stage I
(``collision_scores_paged_kernel(..., score_range=)``) visits every score
once, so beside the (b, G, Hg, n) scores it writes ``seg_hist`` (b, G, Hg,
nseg, score_range + 2) int32, the histogram of score + 1 over each segment
of ``SEG_LEN`` consecutive positions (nseg = ceil(n / SEG_LEN); positions
outside [sink, enc_end) are -1 and counted in bin 0). ``bucket_topk(scores,
k, score_range, seg_hist=)`` finds its threshold from the summed histograms
and each segment's output offset and share of the tie quota from the
segments before it, and reads the scores only of segments that hold a
candidate. Every serving path hands it ``seg_hist``; a direct caller
without one gets the histogram pass ``bucket_hist`` first: two launches
instead of one.
"""
from __future__ import annotations

import functools

import torch

KERNELS = ("collision_paged", "bucket_topk", "bucket_hist",
           "rerank_topk_paged", "gather_rows_paged", "gather_rows_tiered",
           "bucket_count")

# positions per segment of the score histograms (csrc/common.cuh:kSegLen)
SEG_LEN = 256

LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=16)
def _row_tables(b: int, device: str) -> torch.Tensor:
    return torch.arange(b, dtype=torch.int32, device=device)[:, None]


def row_tables(b: int, device) -> torch.Tensor:
    """The (b, 1) int32 block table of a contiguous store seen as a pool of
    b blocks (row i is block i, of size n): metadata (b, G, n, B) and K/V
    (b, n, G, hd) lie exactly as a pool's (nb, G, bs, B) and (nb, bs, G,
    hd), and position p of row i is physical row i·n + p. Made once per
    shape and device."""
    return _row_tables(b, str(torch.device(device)))
