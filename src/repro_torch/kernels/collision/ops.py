"""Wrappers of the Stage-I collision kernels: paged
(csrc/collision_paged.cu) and contiguous (csrc/collision.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build as K
from repro_torch.kernels.collision.ref import (collision_paged_ref,
                                              collision_ref)


def collision_scores_paged_kernel(pool_ids: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  tables: torch.Tensor, enc_end: torch.Tensor,
                                  sink_size: int) -> torch.Tensor:
    """Block-table-indirect Stage-I scores, masked to [sink, enc_end).

    pool_ids (nb, G, bs, B) uint8, block_tables (b, nblk) int32 (< 0 =
    unallocated, clipped to block 0), tables (b, G, Hg, B, nc) int32,
    enc_end (b,) int32 → (b, G, Hg, nblk·bs) int32. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if pool_ids.device.type == "cpu":
        return collision_paged_ref(pool_ids, block_tables, tables, enc_end,
                                   sink_size)
    K.check_cuda("collision_paged", pool_ids, block_tables, tables, enc_end)
    nb, G, bs, B = pool_ids.shape
    b, nblk = block_tables.shape
    Hg, nc = tables.shape[2], tables.shape[-1]
    if (pool_ids.dtype != torch.uint8 or block_tables.dtype != torch.int32
            or tables.dtype != torch.int32 or enc_end.dtype != torch.int32):
        raise TypeError("collision_paged: expects uint8 ids and int32 "
                        "tables, block tables and enc_end")
    if tables.shape != (b, G, Hg, B, nc) or B not in (8, 16) or nc > 256:
        raise ValueError(f"collision_paged: unsupported shapes "
                         f"{tuple(tables.shape)} for B={B}")
    out = torch.empty((b, G, Hg, nblk * bs), dtype=torch.int32,
                      device=pool_ids.device)
    K.launch("collision_paged", K.ptr(pool_ids), K.ptr(block_tables),
             K.ptr(tables), K.ptr(enc_end), K.ptr(out), nb, G, Hg, bs, nblk,
             B, nc, int(sink_size), b)
    LAUNCHES["collision_paged"] += 1
    return out


def collision_scores_kernel(ids: torch.Tensor, tables: torch.Tensor,
                            enc_end: torch.Tensor,
                            sink_size: int) -> torch.Tensor:
    """Contiguous Stage-I scores, masked to [sink, enc_end).

    ids (b, G, n, B) uint8 (the contiguous cache's meta_ids as it lies),
    tables (b, G, Hg, B, nc) int32, enc_end (b,) int32 → (b, G, Hg, n)
    int32. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if ids.device.type == "cpu":
        return collision_ref(ids[:, :, None], tables, enc_end, sink_size)
    K.check_cuda("collision", ids, tables, enc_end)
    b, G, n, B = ids.shape
    Hg, nc = tables.shape[2], tables.shape[-1]
    if (ids.dtype != torch.uint8 or tables.dtype != torch.int32
            or enc_end.dtype != torch.int32):
        raise TypeError("collision: expects uint8 ids and int32 tables and "
                        "enc_end")
    if (tables.shape != (b, G, Hg, B, nc) or B not in (8, 16) or nc > 256
            or nc % 4 or enc_end.shape != (b,) or ids.data_ptr() % 16
            or tables.data_ptr() % 16):
        raise ValueError(f"collision: unsupported shapes ids "
                         f"{tuple(ids.shape)}, tables {tuple(tables.shape)}")
    out = torch.empty((b, G, Hg, n), dtype=torch.int32, device=ids.device)
    K.launch("collision", K.ptr(ids), K.ptr(tables), K.ptr(enc_end),
             K.ptr(out), b * G, G, Hg, n, B, nc, int(sink_size))
    LAUNCHES["collision"] += 1
    return out
