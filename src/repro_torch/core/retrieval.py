"""Two-stage retrieval (port of ``repro/core/retrieval.py``): the
contiguous pipeline ``retrieve`` (and ``retrieve_paged`` over a paged
store's materialized logical view), and the fused paged pipeline
``retrieve_paged_fused``. Both run the same four kernels.

Stage I   scores the pool's uint8 centroid ids through the block table
          against per-(subspace, centroid) tier weights built from the
          incrementally maintained bucket histogram (kernels/collision);
Top-C     cuts to the candidates with the sort-free bucket top-C
          (kernels/bucket_topk), from the score histograms per segment
          that the paged Stage I writes beside its scores;
Stage II  reranks the candidates with RSQ-IP, reading their codes and
          weights through the block table, and keeps the ``top_k`` best
          estimates in ``lax.top_k``'s order (the float's total order,
          ties to the lowest candidate slot), with the winners' physical
          rows and blocks: one kernel (kernels/rerank).

The contiguous pipeline computes its bucket histogram per query over the
valid region (or a strided sample of it, ``hist_sample``) in one kernel
(kernels/collision ``bucket_count``), then runs the paged Stage I, top-C
and Stage II kernels over the store: a contiguous metadata store (b, G, n,
B) is a pool of b blocks of size n with the block table ``arange(b)[:,
None]`` (``kernels.row_tables``), so candidate c of row i lives at
physical row i·n + c.

The reference takes a general ``valid`` mask (..., n); every caller passes
its ``cache.retrieval_valid_mask``, the interval [sink, enc_end) per row,
so the port takes ``enc_end`` (b,) instead and the kernels mask by it.

Every kernel wrapper dispatches on the device of its tensors, so no
function here has a kernel switch: CPU tensors run the plain versions,
CUDA tensors the Hopper kernels.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import centroids
from repro_torch.core.config import ParisKVConfig
from repro_torch.core.encode import QueryTransform
from repro_torch.kernels import row_tables
from repro_torch.kernels.bucket_topk import bucket_topk
from repro_torch.kernels.collision import (bucket_count,
                                           collision_scores_paged_kernel,
                                           lane_packed_table)
from repro_torch.kernels.rerank import RerankTopK, rerank_topk_paged
from repro_torch.kernels.rerank.ref import block_relative

NEG_INF = -1e30


class RetrievalResult(NamedTuple):
    indices: torch.Tensor        # (b, G, Hg, k) int32 final top-k positions
    scores: torch.Tensor         # (b, G, Hg, k) float32 RSQ-IP estimates
    cand_indices: torch.Tensor   # (b, G, Hg, C) int32 Stage-I candidates
    coarse_scores: torch.Tensor  # (b, G, Hg, n) int32 Stage-I scores
    phys_rows: torch.Tensor      # (b, G, Hg, k) int32 row i·n + position


class PagedRetrievalResult(NamedTuple):
    """Retrieval result addressed block-relatively for a paged KV pool."""
    indices: torch.Tensor      # (b, G, Hg, k) int32 logical positions
    block_ids: torch.Tensor    # (b, G, Hg, k) int32 physical block per hit
    phys_rows: torch.Tensor    # (b, G, Hg, k) int32 flat pool row ids
    scores: torch.Tensor       # (b, G, Hg, k) float32 RSQ-IP estimates
    cand_indices: torch.Tensor  # (b, G, Hg, C) int32 Stage-I candidates
    coarse_scores: torch.Tensor  # (b, G, Hg, n) int32 Stage-I scores


@functools.lru_cache(maxsize=16)
def _tier_tensors(pcts: Tuple[float, ...], weights: Tuple[int, ...],
                  device: str, dtype: torch.dtype = torch.int32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tier percentiles and weights (plus the 0 weight past the last tier,
    as ``dtype``) on ``device``, copied once: a host-to-device copy per
    call would synchronize the stream on every decode layer."""
    return (torch.tensor(pcts, dtype=torch.float32, device=device),
            torch.tensor(weights + (0,), dtype=dtype, device=device))


def tier_weight_table(cent_scores: torch.Tensor, counts: torch.Tensor,
                      n_valid: torch.Tensor, cfg: ParisKVConfig,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-(subspace, centroid) integer tier weight (App. B.2.1).

    cent_scores (..., B, 2^m) proxy scores; counts (..., B, 2^m) bucket
    histogram (broadcast against extra query-head dims); n_valid (...,)
    indexable keys → (..., B, 2^m) int32 weights in {0, .., 6}, or written
    into ``out`` in its type and layout (the paged Stage I's uint8
    byte-lane table). The bucket ranking is a stable argsort and the tier
    lookup a right-side searchsorted, as in the reference."""
    counts = torch.broadcast_to(counts, cent_scores.shape)
    order = torch.argsort(-cent_scores, dim=-1, stable=True)
    counts_sorted = counts.gather(-1, order)
    csum_exclusive = counts_sorted.cumsum(-1) - counts_sorted
    denom = (n_valid.float() * cfg.rho).clamp_min(1.0)
    pos_frac = csum_exclusive.float() / denom[..., None, None]
    dtype = torch.int32 if out is None else out.dtype
    pcts, wts = _tier_tensors(cfg.tier_pcts, cfg.tier_weights,
                              str(cent_scores.device), dtype)
    tier = torch.searchsorted(pcts, pos_frac.contiguous(), right=True)
    w_sorted = wts[tier.clamp_max(len(cfg.tier_weights))]
    # back to bucket-id order through the inverse permutation
    if out is None:
        out = torch.empty_like(w_sorted)
    return out.scatter_(-1, order, w_sorted)


def max_collision_score(cfg: ParisKVConfig, num_subspaces: int) -> int:
    """The largest Stage-I score: every subspace at the top tier weight."""
    return max(cfg.tier_weights) * num_subspaces


def collision_scores_paged_hist(pool_ids: torch.Tensor,
                                block_tables: torch.Tensor,
                                q_sub: torch.Tensor, counts: torch.Tensor,
                                enc_end: torch.Tensor, cfg: ParisKVConfig):
    """Stage-I coarse scores over the paged pool, with their histograms per
    segment for ``select_candidates_bucket``.

    pool_ids (nb, G, bs, B) uint8, block_tables (b, nblk) int32, q_sub
    (b, G, Hg, B, m), counts (b, G, B, 2^m) int32 incremental histogram,
    enc_end (b,) int32 → (scores (b, G, Hg, nblk·bs) int32, -1 outside
    [sink, enc_end); seg_hist (b, G, Hg, nseg, max score + 2) int32)."""
    cs = centroids.centroid_scores(q_sub, cfg.m)
    n_valid = (enc_end - cfg.sink_size).clamp_min(0)
    table = tier_weight_table(cs, counts[:, :, None], n_valid[:, None, None],
                              cfg, out=lane_packed_table(*cs.shape,
                                                         device=cs.device))
    return collision_scores_paged_kernel(
        pool_ids, block_tables, table, enc_end, cfg.sink_size,
        max_collision_score(cfg, pool_ids.shape[-1]))


def collision_scores_paged(pool_ids: torch.Tensor, block_tables: torch.Tensor,
                           q_sub: torch.Tensor, counts: torch.Tensor,
                           enc_end: torch.Tensor,
                           cfg: ParisKVConfig) -> torch.Tensor:
    """The scores of ``collision_scores_paged_hist``: (b, G, Hg, nblk·bs)
    int32, -1 outside [sink, enc_end)."""
    return collision_scores_paged_hist(pool_ids, block_tables, q_sub, counts,
                                       enc_end, cfg)[0]


def region_mask(n: int, enc_end: torch.Tensor,
                cfg: ParisKVConfig) -> torch.Tensor:
    """(b, n) bool: each row's retrieval region [sink, enc_end)."""
    pos = torch.arange(n, device=enc_end.device)
    return (pos >= cfg.sink_size) & (pos < enc_end[:, None])


def collision_scores_hist(meta_ids: torch.Tensor, q_sub: torch.Tensor,
                          enc_end: torch.Tensor, cfg: ParisKVConfig,
                          hist_sample: int = 0):
    """Stage-I coarse scores over a contiguous metadata store (Eq. 15),
    with their histograms per segment for ``select_candidates_bucket``.

    meta_ids (b, G, n, B) uint8, q_sub (b, G, Hg, B, m), enc_end (b,)
    int32 (<= n) → as ``collision_scores_paged_hist``. The bucket
    histogram is computed here per query over the region — from a strided
    sample of about ``hist_sample`` keys, scaled back, when > 0 — in one
    kernel (``bucket_count``); the store is then scored as a pool of one
    block per batch row."""
    n = meta_ids.shape[-2]
    stride = max(n // hist_sample, 1) if hist_sample else 1
    counts = bucket_count(meta_ids, enc_end, cfg.sink_size,
                          cfg.num_centroids(), stride)      # (b, G, B, nc)
    return collision_scores_paged_hist(
        meta_ids, row_tables(meta_ids.shape[0], meta_ids.device), q_sub,
        counts, enc_end, cfg)


def select_candidates_bucket(scores: torch.Tensor, num_candidates: int,
                             score_range: int,
                             seg_hist: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Sort-free top-C over small-range integer scores; ``lax.top_k``'s
    index set, ascending, ties lowest-index first. ``seg_hist``: the
    scores' histograms per segment, from Stage I."""
    return bucket_topk(scores.contiguous(), num_candidates, score_range,
                       seg_hist=seg_hist)


def rerank_topk(codes: torch.Tensor, weights: torch.Tensor,
                qt: QueryTransform, cand_idx: torch.Tensor,
                enc_end: torch.Tensor, cfg: ParisKVConfig, top_k: int,
                block_tables: Optional[torch.Tensor] = None) -> RerankTopK:
    """Stage II and the top-k (one kernel) over a paged pool's metadata
    (nb, G, bs, B) through ``block_tables``, or over a contiguous store
    (b, G, n, B) without them: each batch row is then one block of size n
    (candidate c of row i is physical row i·n + c)."""
    if block_tables is None:
        block_tables = row_tables(codes.shape[0], codes.device)
    return rerank_topk_paged(
        codes, weights, block_tables, cand_idx.contiguous(),
        qt.q_sub.float().contiguous(), qt.q_norm.float().contiguous(),
        enc_end, cfg.sink_size, top_k, cfg.m, cfg.magnitude_bits)


def rerank(meta_codes: torch.Tensor, meta_w: torch.Tensor,
           qt: QueryTransform, cand_idx: torch.Tensor, enc_end: torch.Tensor,
           cfg: ParisKVConfig) -> torch.Tensor:
    """Stage-II RSQ-IP estimates (b, G, Hg, C) float32 of the candidates
    over a contiguous store (b, G, n, B); candidates outside
    [sink, enc_end) get NEG_INF."""
    return rerank_topk(meta_codes, meta_w, qt, cand_idx, enc_end, cfg, 1).est


def retrieve(meta_ids: torch.Tensor, meta_codes: torch.Tensor,
             meta_w: torch.Tensor, qt: QueryTransform, enc_end: torch.Tensor,
             cfg: ParisKVConfig, num_candidates: int, top_k: int,
             hist_sample: int = 0) -> RetrievalResult:
    """The two-stage pipeline (Algorithm 1) over a contiguous metadata
    store (b, G, n, B) for queries qt (b, G, Hg, ...): Stage I with its
    histograms per segment, the sort-free bucket top-C from them (the
    reference's index set, ascending), Stage II with its top-k. The
    winners' ``phys_rows`` address the store as a pool of one block per
    row (i·n + position), as the decode gather takes them."""
    coarse, seg_hist = collision_scores_hist(meta_ids, qt.q_sub, enc_end,
                                             cfg, hist_sample=hist_sample)
    cand = select_candidates_bucket(
        coarse, num_candidates, max_collision_score(cfg, meta_ids.shape[-1]),
        seg_hist=seg_hist)
    won = rerank_topk(meta_codes, meta_w, qt, cand, enc_end, cfg, top_k)
    return RetrievalResult(won.top_idx, won.top_est, cand, coarse,
                           won.phys_rows)


def retrieve_paged(view, qt: QueryTransform, enc_end: torch.Tensor,
                   cfg: ParisKVConfig, num_candidates: int, top_k: int,
                   block_tables: torch.Tensor, block_size: int,
                   hist_sample: int = 0) -> PagedRetrievalResult:
    """``retrieve`` over a paged store's materialized logical metadata view
    (``cache.paged_meta_view``: ids, codes, weights, each (b, G, n, B)),
    the winners translated to physical pool rows through the block table
    (unallocated entries clip to block 0)."""
    res = retrieve(*view, qt, enc_end, cfg, num_candidates, top_k,
                   hist_sample=hist_sample)
    blk, phys_rows = block_relative(res.indices, block_tables, block_size)
    return PagedRetrievalResult(
        indices=res.indices, block_ids=blk, phys_rows=phys_rows,
        scores=res.scores, cand_indices=res.cand_indices,
        coarse_scores=res.coarse_scores)


def retrieve_paged_fused(pool, block_tables: torch.Tensor, qt: QueryTransform,
                         counts: torch.Tensor, enc_end: torch.Tensor,
                         cfg: ParisKVConfig, num_candidates: int,
                         top_k: int) -> PagedRetrievalResult:
    """Fused two-stage retrieval directly over a paged pool.

    ``pool`` is a cache.PagedLayerKVCache (only its metadata is read);
    ``counts`` the (b, G, B, 2^m) incremental bucket histogram; ``enc_end``
    (b,) int32 the per-row retrieval-region end. Stage II reads the
    candidates' codes through the block table and returns the winners with
    their physical rows and blocks (one kernel)."""
    B = pool.meta_ids.shape[-1]
    coarse, seg_hist = collision_scores_paged_hist(
        pool.meta_ids, block_tables, qt.q_sub, counts, enc_end, cfg)
    cand = select_candidates_bucket(coarse, num_candidates,
                                    max_collision_score(cfg, B),
                                    seg_hist=seg_hist)
    won = rerank_topk(pool.meta_codes, pool.meta_w, qt, cand, enc_end, cfg,
                      top_k, block_tables)
    return PagedRetrievalResult(
        indices=won.top_idx, block_ids=won.block_ids,
        phys_rows=won.phys_rows, scores=won.top_est, cand_indices=cand,
        coarse_scores=coarse)


def tiered_winner_rows(phys_rows: torch.Tensor, dev_map: torch.Tensor,
                       block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner → staging-row translation for a tiered pool. Stage II's
    ``phys_rows`` address the *host* block space; ``dev_map``
    (num_blocks,) int32 maps host block → staging block (-1 = not
    staged). → (resident, stag_rows): ``resident`` marks winners whose
    block is staged, ``stag_rows`` their flat staging row (meaningless
    where not resident)."""
    host_blk = torch.div(phys_rows, block_size, rounding_mode="floor")
    off = phys_rows - host_blk * block_size
    stag = dev_map[host_blk.clamp(0, dev_map.shape[0] - 1).long()]
    return stag >= 0, stag.clamp_min(0) * block_size + off
