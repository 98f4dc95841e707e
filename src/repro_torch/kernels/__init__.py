"""Hand-written Hopper kernels for the hot paths of ParisKV decode.

  collision/    Stage-I tier-weight accumulation, over the paged id pool
                (collision_paged) or a contiguous id store (collision)
  bucket_topk/  top-C: threshold from score histograms per segment, then
                an ordered compaction (bucket_topk); the histogram pass
                (bucket_hist) for callers that bring no histograms
  rerank/       Stage II with the final top-k (rerank_topk_paged): RSQ-IP
                of the candidates, their codes read through the block table,
                then the top-k in lax.top_k's order with the winners'
                physical rows and blocks (a contiguous store is a pool of
                one block per batch row)
  gather_kv/    K/V row gather, block-table-indirect (gather_rows_paged: on
                decode the sink, window and winner rows in one launch;
                promotion rows by logical position) or from a contiguous
                store (gather_rows): winners and window; the tiered winner
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
candidate. Without ``seg_hist`` (the contiguous Stage I, direct callers) it
runs the histogram pass ``bucket_hist`` first: two launches instead of one.
"""
from __future__ import annotations

KERNELS = ("collision_paged", "bucket_topk", "bucket_hist",
           "rerank_topk_paged", "gather_rows_paged", "collision",
           "gather_rows", "gather_rows_tiered")

# positions per segment of the score histograms (csrc/common.cuh:kSegLen)
SEG_LEN = 256

LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
