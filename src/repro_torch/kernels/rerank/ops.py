"""Wrapper of the Stage-II kernel with the final top-k
(csrc/rerank_topk_paged.cu)."""
from __future__ import annotations

import functools

import torch

from repro_torch.core import quantizer
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build as K
from repro_torch.kernels.rerank.ref import RerankTopK, rerank_topk_paged_ref

THREADS = 512          # threads per block (the fastest of 256 and 512)
SPLITS = (1, 2, 4, 8)  # blocks per row (a cluster when > 1)
MAX_SMEM = 227 << 10   # shared memory one block may use on Hopper


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def default_split(rows: int, C: int, sms: int) -> int:
    """Blocks per row: the most that keep every block on an SM of its own
    (rows · split <= sms) and give each block at least one slot a
    thread."""
    fit = [s for s in SPLITS if rows * s <= sms and C >= s * THREADS]
    return max(fit, default=1)


def smem_bytes(C: int, B: int, top_k: int) -> int:
    """The launcher's dynamic shared memory: the selected pairs, the
    decode table, keys, rows and positions of all C slots, a histogram of
    the keys' top 12 bits (a pad word every 8 bins)."""
    return max(top_k, 512) * 8 + (B * 128 + 3 * C + 4608 + 36) * 4


def rerank_topk_paged(pool_codes: torch.Tensor, pool_w: torch.Tensor,
                      block_tables: torch.Tensor, cand_idx: torch.Tensor,
                      q_sub: torch.Tensor, q_norm: torch.Tensor,
                      enc_end: torch.Tensor, sink_size: int, top_k: int,
                      m: int = 8, bits: int = 3) -> RerankTopK:
    """RSQ-IP estimates of the candidates, their codes and weights read
    through the block table, and the ``top_k`` best in ``lax.top_k``'s
    order (descending by the float's total order, ties to the lowest
    candidate slot).

    pool_codes (nb, G, bs, B) int32 bit patterns, pool_w (nb, G, bs, B)
    f32, block_tables (b, nblk) int32 (entries < 0 read block 0),
    cand_idx (b, G, Hg, C) int32 logical positions, q_sub (b, G, Hg, B, m)
    f32, q_norm (b, G, Hg) f32, enc_end (b,) int32 → ``RerankTopK``;
    candidates outside [sink_size, enc_end) estimate -1e30. CPU tensors
    take the plain version; CUDA tensors launch the kernel (``split`` =
    ``default_split`` blocks per row) or raise."""
    if pool_codes.device.type == "cpu":
        return rerank_topk_paged_ref(pool_codes, pool_w, block_tables,
                                     cand_idx, q_sub, q_norm, enc_end,
                                     sink_size, top_k, m, bits)
    out = launch(pool_codes, pool_w, block_tables, cand_idx, q_sub, q_norm,
                 enc_end, sink_size, top_k, m, bits)
    LAUNCHES["rerank_topk_paged"] += 1
    return out


def launch(pool_codes, pool_w, block_tables, cand_idx, q_sub, q_norm,
           enc_end, sink_size: int, top_k: int, m: int, bits: int,
           split=None, threads: int = THREADS) -> RerankTopK:
    """Check the inputs and launch the kernel once, ``split`` blocks per
    row (default ``default_split``) of ``threads`` threads (the kernel
    phase of chip_smoke.py times every grid through here)."""
    K.check_cuda("rerank_topk_paged", pool_codes, pool_w, block_tables,
                 cand_idx, q_sub, q_norm, enc_end)
    nb, G, bs, B = pool_codes.shape
    b, _, Hg, C = cand_idx.shape
    if (pool_codes.dtype != torch.int32 or pool_w.dtype != torch.float32
            or q_sub.dtype != torch.float32 or q_norm.dtype != torch.float32
            or cand_idx.dtype != torch.int32
            or block_tables.dtype != torch.int32
            or enc_end.dtype != torch.int32):
        raise TypeError("rerank_topk_paged: expects int32 codes, indices and "
                        "tables, float32 weights and queries")
    if (B not in (8, 16, 32) or q_sub.shape != (b, G, Hg, B, m)
            or not 1 <= m <= 8 or not 1 <= bits <= 3
            or block_tables.shape[0] != b or pool_w.shape != pool_codes.shape):
        raise ValueError(f"rerank_topk_paged: unsupported shapes B={B}, "
                         f"m={m}, bits={bits}, q_sub {tuple(q_sub.shape)}, "
                         f"block_tables {tuple(block_tables.shape)}")
    if split is None:
        split = default_split(b * G * Hg, C,
                              _sm_count(pool_codes.device.index or 0))
    if threads not in (256, 512) or split not in SPLITS:
        raise ValueError(f"rerank_topk_paged: threads={threads} (256 or 512) "
                         f"and split={split} (one of {SPLITS})")
    if not 1 <= top_k <= C:
        raise ValueError(f"rerank_topk_paged: top_k={top_k} outside "
                         f"[1, C={C}]")
    if smem_bytes(C, B, top_k) > MAX_SMEM:
        raise ValueError(f"rerank_topk_paged: C={C} candidates need more "
                         f"shared memory than a block has")
    _, lv = quantizer.level_tensors(m, bits, str(pool_codes.device))
    dev = pool_codes.device
    est = torch.empty((b, G, Hg, C), dtype=torch.float32, device=dev)
    top_est = torch.empty((b, G, Hg, top_k), dtype=torch.float32, device=dev)
    ints = [torch.empty((b, G, Hg, top_k), dtype=torch.int32, device=dev)
            for _ in range(3)]
    K.launch("rerank_topk_paged", K.ptr(pool_codes), K.ptr(pool_w),
             K.ptr(block_tables), K.ptr(cand_idx), K.ptr(q_sub),
             K.ptr(q_norm), K.ptr(lv), K.ptr(enc_end), K.ptr(est),
             K.ptr(top_est), *map(K.ptr, ints), nb, block_tables.shape[1], G,
             Hg, bs, C, B, m, bits, int(sink_size), int(top_k), b * G * Hg,
             int(split), int(threads))
    return RerankTopK(top_est, *ints, est)
