"""Wrapper of the paged Stage-II rerank kernel (csrc/rerank_paged.cu)."""
from __future__ import annotations

import torch

from repro_torch.core import quantizer
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build as K
from repro_torch.kernels.rerank.ref import rerank_paged_ref


def rerank_paged_kernel(pool_codes: torch.Tensor, pool_w: torch.Tensor,
                        phys_rows: torch.Tensor, cand_idx: torch.Tensor,
                        q_sub: torch.Tensor, q_norm: torch.Tensor,
                        enc_end: torch.Tensor, sink_size: int, m: int = 8,
                        bits: int = 3) -> torch.Tensor:
    """RSQ-IP estimates of the candidates, their codes and weights read by
    physical pool row inside the kernel.

    pool_codes (nb, G, bs, B) int32 bit patterns, pool_w (nb, G, bs, B)
    f32, phys_rows / cand_idx (b, G, Hg, C) int32, q_sub (b, G, Hg, B, m)
    f32, q_norm (b, G, Hg) f32, enc_end (b,) int32 → (b, G, Hg, C) f32,
    -1e30 where cand_idx is outside [sink_size, enc_end). CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if pool_codes.device.type == "cpu":
        return rerank_paged_ref(pool_codes, pool_w, phys_rows, cand_idx,
                                q_sub, q_norm, enc_end, sink_size, m, bits)
    K.check_cuda("rerank_paged", pool_codes, pool_w, phys_rows, cand_idx,
                 q_sub, q_norm, enc_end)
    nb, G, bs, B = pool_codes.shape
    b, _, Hg, C = phys_rows.shape
    if (pool_codes.dtype != torch.int32 or pool_w.dtype != torch.float32
            or q_sub.dtype != torch.float32 or q_norm.dtype != torch.float32
            or phys_rows.dtype != torch.int32 or cand_idx.dtype != torch.int32
            or enc_end.dtype != torch.int32):
        raise TypeError("rerank_paged: expects int32 codes/indices and "
                        "float32 weights/queries")
    if B % 4 or q_sub.shape != (b, G, Hg, B, m) or m > 8:
        raise ValueError(f"rerank_paged: unsupported shapes B={B}, "
                         f"q_sub {tuple(q_sub.shape)}")
    _, lv = quantizer.level_tensors(m, bits, str(pool_codes.device))
    out = torch.empty((b, G, Hg, C), dtype=torch.float32,
                      device=pool_codes.device)
    K.launch("rerank_paged", K.ptr(pool_codes), K.ptr(pool_w),
             K.ptr(phys_rows), K.ptr(cand_idx), K.ptr(q_sub), K.ptr(q_norm),
             K.ptr(lv), K.ptr(enc_end), K.ptr(out), nb, G, Hg, bs, C, B, m,
             bits, int(sink_size), b)
    LAUNCHES["rerank_paged"] += 1
    return out
