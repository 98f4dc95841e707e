"""Wrapper of the paged K/V row gather kernel (csrc/gather_rows_paged.cu).

K and V go through one launch: pass ``pool_v`` to get ``(k_rows, v_rows)``,
or ``None`` for a single tensor (promotion gathers K only)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build as K
from repro_torch.kernels.gather_kv.ref import (gather_heads_physical_ref,
                                               gather_rows_paged_ref)


def _launch(mode, pool_k, pool_v, idx, block_tables, out_shape, L, qk,
            row_bytes):
    pools = [p for p in (pool_k, pool_v) if p is not None]
    K.check_cuda("gather_rows_paged", *pools, idx, block_tables)
    if row_bytes % 16:
        raise ValueError(f"gather_rows_paged: rows of {row_bytes} bytes are "
                         f"not a multiple of 16")
    if idx.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise TypeError("gather_rows_paged: expects int32 indices/tables")
    if pool_v is not None and (pool_v.shape != pool_k.shape
                               or pool_v.dtype != pool_k.dtype):
        raise ValueError("gather_rows_paged: K and V pools differ")
    nb, bs, G = pool_k.shape[:3]
    outs = [torch.empty(out_shape, dtype=p.dtype, device=p.device)
            for p in pools]
    rows = idx.numel()
    K.launch("gather_rows_paged", K.ptr(pools[0]), K.ptr(pools[-1]),
             K.ptr(outs[0]), K.ptr(outs[-1]), K.ptr(idx), K.ptr(block_tables),
             mode, rows, L, block_tables.shape[-1], nb, bs, G, qk,
             row_bytes // 16, len(pools))
    LAUNCHES["gather_rows_paged"] += 1
    return outs


def gather_rows_paged(pool_k: torch.Tensor, pool_v: Optional[torch.Tensor],
                      block_tables: torch.Tensor, lidx: torch.Tensor):
    """Rows at per-row logical positions through the block table.

    pool (nb, bs, G, hd), block_tables (b, nblk) int32, lidx (b, L) int32
    → (b, L, G, hd) for K (and V). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if pool_k.device.type == "cpu":
        outs = [gather_rows_paged_ref(p, block_tables, lidx)
                for p in (pool_k, pool_v) if p is not None]
    else:
        b, L = lidx.shape
        G, hd = pool_k.shape[2:]
        outs = _launch(0, pool_k, pool_v, lidx, block_tables, (b, L, G, hd),
                       L, 1, G * hd * pool_k.element_size())
    return outs[0] if pool_v is None else tuple(outs)


def gather_heads_physical(pool_k: torch.Tensor,
                          pool_v: Optional[torch.Tensor],
                          phys_rows: torch.Tensor):
    """Per-kv-head rows by flat physical pool row.

    pool (nb, bs, G, hd), phys_rows (b, G, Q, k) int32 → (b, G, Q, k, hd)
    for K (and V). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if pool_k.device.type == "cpu":
        outs = [gather_heads_physical_ref(p, phys_rows)
                for p in (pool_k, pool_v) if p is not None]
    else:
        b, G, Q, k = phys_rows.shape
        hd = pool_k.shape[3]
        outs = _launch(1, pool_k, pool_v, phys_rows, phys_rows,
                       (b, G, Q, k, hd), 1, Q * k,
                       hd * pool_k.element_size())
    return outs[0] if pool_v is None else tuple(outs)
