"""Hand-written Hopper kernels for the hot paths of ParisKV decode.

  collision/    Stage-I tier-weight accumulation, over the paged id pool
                (collision_paged) or a contiguous id store (collision)
  bucket_topk/  histogram + threshold walk + ordered compaction (top-C)
  rerank/       Stage-II RSQ-IP with the physical-row gather fused in (a
                contiguous store is a pool of one block per batch row)
  gather_kv/    K/V row gather, block-table-indirect (gather_rows_paged) or
                from a contiguous store (gather_rows): winners and window;
                the tiered winner gather (gather_rows_tiered) reads staged
                rows from HBM and missed rows from pinned host memory

Each subpackage has ``ops.py`` (the wrapper) and ``ref.py`` (the plain
PyTorch version). A wrapper takes the plain version only for CPU tensors;
for CUDA tensors it launches the CUDA C++ kernel from ``repro_torch/csrc``
(built at first use, ``kernels/build.py``) or raises. Every launch adds one
to ``LAUNCHES[name]`` so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

KERNELS = ("collision_paged", "bucket_topk", "rerank_paged",
           "gather_rows_paged", "collision", "gather_rows",
           "gather_rows_tiered")

LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
