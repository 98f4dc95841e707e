"""Hand-written Hopper kernels for the four hot paths of paged ParisKV decode.

  collision/    Stage-I tier-weight accumulation over the paged id pool
  bucket_topk/  histogram + threshold walk + ordered compaction (top-C)
  rerank/       Stage-II RSQ-IP with the physical-row gather fused in
  gather_kv/    block-table-indirect K/V row gather (winners, sink, window)

Each subpackage has ``ops.py`` (the wrapper) and ``ref.py`` (the plain
PyTorch version). A wrapper takes the plain version only for CPU tensors;
for CUDA tensors it launches the CUDA C++ kernel from ``repro_torch/csrc``
(built at first use, ``kernels/build.py``) or raises. Every launch adds one
to ``LAUNCHES[name]`` so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

KERNELS = ("collision_paged", "bucket_topk", "rerank_paged",
           "gather_rows_paged")

LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
