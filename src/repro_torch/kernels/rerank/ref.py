"""Plain PyTorch versions of the Stage-II kernel: the rerank alone (the port
of ``repro/core/retrieval.py:rerank_paged``: gather by physical pool row,
then Eq. 24, invalid candidates masked to the finite NEG_INF), the final
top-k in ``lax.top_k``'s order, and the two together with the block-table
lookups around them (``rerank_topk_paged_ref``)."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import quantizer

NEG_INF = -1e30


class RerankTopK(NamedTuple):
    top_est: torch.Tensor    # (b, G, Hg, k) float32 winners' estimates
    top_idx: torch.Tensor    # (b, G, Hg, k) int32 winners' logical positions
    phys_rows: torch.Tensor  # (b, G, Hg, k) int32 flat physical pool rows
    block_ids: torch.Tensor  # (b, G, Hg, k) int32 physical blocks
    est: torch.Tensor        # (b, G, Hg, C) float32 every candidate's estimate


def rerank_paged_ref(pool_codes: torch.Tensor, pool_w: torch.Tensor,
                     phys_rows: torch.Tensor, cand_idx: torch.Tensor,
                     q_sub: torch.Tensor, q_norm: torch.Tensor,
                     enc_end: torch.Tensor, sink_size: int, m: int,
                     bits: int = 3) -> torch.Tensor:
    """pool_codes (nb, G, bs, B) int32, pool_w (nb, G, bs, B) f32,
    phys_rows / cand_idx (b, G, Hg, C) int32, q_sub (b, G, Hg, B, m),
    q_norm (b, G, Hg), enc_end (b,) → (b, G, Hg, C) float32."""
    nb, G, bs, B = pool_codes.shape
    rows = phys_rows.long().clamp(0, nb * bs - 1)
    blk, off = rows // bs, rows % bs
    heads = torch.arange(G, device=rows.device)[None, :, None, None]
    codes = pool_codes[blk, heads, off]                   # (b, G, Hg, C, B)
    w = pool_w[blk, heads, off]
    v = quantizer.decode_directions(codes, m, bits)       # (..., C, B, m)
    # products and sums, not einsum: a batched matmul's rounding depends on
    # the batch count, and a head-sharded rank's rows must come out as the
    # one-device call's
    dots = (v * q_sub.float()[..., None, :, :]).sum(-1)
    est = q_norm[..., None] * (w * dots).sum(-1)
    valid = ((cand_idx >= sink_size)
             & (cand_idx < enc_end[:, None, None, None]))
    return torch.where(valid, est, NEG_INF)


def block_relative(idx: torch.Tensor, block_tables: torch.Tensor,
                   block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logical positions (b, ...) → (physical block, flat physical row),
    unallocated (< 0) table entries clipped to block 0 (the reference's
    ``_block_relative``)."""
    b = block_tables.shape[0]
    blk = torch.div(idx, block_size, rounding_mode="floor")
    phys_blk = block_tables.gather(1, blk.reshape(b, -1).long()).reshape(
        blk.shape).clamp_min(0)
    return phys_blk, phys_blk * block_size + (idx - blk * block_size)


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 keys in the float's total order (-0.0 below +0.0),
    the order ``lax.top_k`` ranks by."""
    bits = x.float().contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def topk_ref(est: torch.Tensor, top_k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the ``top_k`` largest by the
    float's total order (+0.0 above -0.0), descending, ties to the lowest
    index (a stable descending sort of the order keys). → (values,
    indices int64)."""
    pos = torch.sort(order_keys(est), dim=-1, descending=True,
                     stable=True).indices[..., :top_k]
    return est.gather(-1, pos), pos


def rerank_topk_paged_ref(pool_codes: torch.Tensor, pool_w: torch.Tensor,
                          block_tables: torch.Tensor, cand_idx: torch.Tensor,
                          q_sub: torch.Tensor, q_norm: torch.Tensor,
                          enc_end: torch.Tensor, sink_size: int, top_k: int,
                          m: int, bits: int = 3) -> RerankTopK:
    """The candidates' physical rows through the block table, the rerank,
    the top-k and the winners' block-table lookup, as the paged path ran
    them before they became one kernel. block_tables (b, nblk) int32,
    cand_idx (b, G, Hg, C) logical positions; the rest as
    ``rerank_paged_ref``."""
    bs = pool_codes.shape[2]
    _, cand_phys = block_relative(cand_idx, block_tables, bs)
    est = rerank_paged_ref(pool_codes, pool_w, cand_phys, cand_idx, q_sub,
                           q_norm, enc_end, sink_size, m, bits)
    top_est, top_pos = topk_ref(est, top_k)
    top_idx = cand_idx.gather(-1, top_pos)
    blk, phys = block_relative(top_idx, block_tables, bs)
    i32 = torch.int32
    return RerankTopK(top_est, top_idx.to(i32), phys.to(i32), blk.to(i32),
                      est)
