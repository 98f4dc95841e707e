"""ParisKV cache state (port of ``repro/core/cache.py`` without the
prefix-sharing parts): Sink / Retrieval / Local / Update regions, the
contiguous per-slot cache, the paged block pool and its tiered
(host-offloaded) variant, and the writes of a chunked fill.

      0 ........ sink | sink ........ enc_end | enc_end ....... pos | ...
      [   Sink     ]   [   Retrieval region ]  [ Local + Update buf ]

Region state is per row: ``CacheRegions.pos`` / ``enc_end`` are (b,) int32.
A row promotes its oldest ``update_interval`` window tokens into the
retrieval region when its window (``local_size + update_interval``) fills.

Paged layout (one pool per layer, shared by every slot):

  k, v:    (num_blocks, block_size, G, hd)
  meta_*:  (num_blocks, G, block_size, B)

A block table ``bt`` (b, n_max // block_size) int32 maps logical position
``p`` of row ``i`` to ``(bt[i, p // bs], p % bs)``; entries < 0 are
unallocated (reads clip to block 0 and are masked, writes are dropped).

Where the reference returns an updated copy (``.at[].set``), the port
updates the cache, pool and histogram tensors **in place**
(``index_put_``) and returns them, so a step never copies a store.

``jax.lax.dynamic_update_slice`` and ``dynamic_slice`` move an
out-of-range start back so the slice fits; torch indexing raises instead.
The contiguous ops clamp their starts the same way wherever the reference
relies on it: a finished row stays frozen at ``pos`` and its next append
lands at ``pos + 1``, which is ``n_max`` when prompt + gen == n_max.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import encode
from repro_torch.core.config import ParisKVConfig
from repro_torch.kernels import row_tables
from repro_torch.kernels.collision import bucket_count, bucket_count_span
from repro_torch.kernels.collision.ref import bucket_histogram
from repro_torch.kernels.gather_kv import gather_rows_paged

PAGED_DEFAULT_BLOCK = 128


class LayerKVCache(NamedTuple):
    """Contiguous per-layer store of a (solo) prefill.

    k, v: (b, n_max, G, hd); meta_*: (b, G, n_max, B)."""
    k: torch.Tensor
    v: torch.Tensor
    meta_ids: torch.Tensor
    meta_codes: torch.Tensor
    meta_w: torch.Tensor


class PagedLayerKVCache(NamedTuple):
    """Block pool of one layer (no batch dim; rows go through tables)."""
    k: torch.Tensor
    v: torch.Tensor
    meta_ids: torch.Tensor
    meta_codes: torch.Tensor
    meta_w: torch.Tensor


class CacheRegions(NamedTuple):
    pos: torch.Tensor      # (b,) int32: index of each row's latest token
    enc_end: torch.Tensor  # (b,) int32: retrieval-region end (exclusive)


def window_size(cfg: ParisKVConfig) -> int:
    return cfg.local_size + cfg.update_interval


def initial_regions(lengths: torch.Tensor, cfg: ParisKVConfig) -> CacheRegions:
    """Regions right after prefilling prompts of ``lengths`` (b,): pos at
    the last prompt token, enc_end clamped so the trailing local window
    stays dense (and never below the sink)."""
    lengths = lengths.to(torch.int32)
    enc_end = torch.maximum(lengths.clamp_max(cfg.sink_size),
                            lengths - cfg.local_size)
    return CacheRegions(pos=lengths - 1, enc_end=enc_end.to(torch.int32))


def init_layer_cache(batch: int, n_max: int, num_kv_heads: int,
                     head_dim: int, cfg: ParisKVConfig, dtype, device
                     ) -> LayerKVCache:
    B = cfg.num_subspaces(head_dim)
    g = num_kv_heads
    return LayerKVCache(
        k=torch.zeros((batch, n_max, g, head_dim), dtype=dtype, device=device),
        v=torch.zeros((batch, n_max, g, head_dim), dtype=dtype, device=device),
        meta_ids=torch.zeros((batch, g, n_max, B), dtype=torch.uint8,
                             device=device),
        meta_codes=torch.zeros((batch, g, n_max, B), dtype=torch.int32,
                               device=device),
        meta_w=torch.zeros((batch, g, n_max, B), dtype=torch.float32,
                           device=device))


def _encode_block(keys_block: torch.Tensor, cfg: ParisKVConfig,
                  signs: torch.Tensor) -> encode.KeyMetadata:
    """keys_block (b, L, G, hd) → metadata with layout (b, G, L, B)."""
    return encode.encode_keys(keys_block.transpose(1, 2), cfg, signs)


def prefill_write(cache: LayerKVCache, k_new: torch.Tensor,
                  v_new: torch.Tensor, cfg: ParisKVConfig,
                  signs: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None
                  ) -> Tuple[LayerKVCache, CacheRegions]:
    """Write a LEFT-aligned prompt's K/V (b, S, G, hd) at positions [0, S)
    and encode metadata for every position (in place). ``lengths`` (b,)
    gives each row's true prompt length (default: all S)."""
    b, S = k_new.shape[:2]
    cache.k[:, :S] = k_new.to(cache.k.dtype)
    cache.v[:, :S] = v_new.to(cache.v.dtype)
    meta = _encode_block(k_new, cfg, signs)
    cache.meta_ids[:, :, :S] = meta.centroid_ids
    cache.meta_codes[:, :, :S] = meta.codes
    cache.meta_w[:, :, :S] = meta.weights
    if lengths is None:
        lengths = torch.full((b,), S, dtype=torch.int32, device=k_new.device)
    return cache, initial_regions(lengths, cfg)


def append_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
              k_t: torch.Tensor, v_t: torch.Tensor,
              pos: torch.Tensor) -> None:
    """Write one token's K/V (b, G, hd) at per-row position ``pos`` (b,) of
    contiguous stores (b, n, G, hd), in place; a position past the store
    clamps to its last row."""
    b, n = k_cache.shape[:2]
    rows = torch.arange(b, device=pos.device)
    at = pos.long().clamp(0, n - 1)
    k_cache[rows, at] = k_t.to(k_cache.dtype)
    v_cache[rows, at] = v_t.to(v_cache.dtype)


def decode_append(cache: LayerKVCache, k_t: torch.Tensor, v_t: torch.Tensor,
                  pos: torch.Tensor) -> LayerKVCache:
    """Append one token's K/V (b, G, hd) at per-row position ``pos`` (b,),
    in place (clamped as ``append_kv``)."""
    append_kv(cache.k, cache.v, k_t, v_t, pos)
    return cache


def promote_rows(cache: LayerKVCache, starts: torch.Tensor,
                 mask: torch.Tensor, cfg: ParisKVConfig,
                 signs: torch.Tensor) -> LayerKVCache:
    """Per-row block promotion, in place: every row with ``mask[i]`` gets
    metadata for keys [starts[i], starts[i] + update_interval). As in the
    reference every row's block is encoded (one batched computation) and
    the unmasked rows keep their old metadata; each start clamps to
    [0, n - update_interval]. The key block comes through the paged
    gather's logical mode over the store's one-block-per-row table."""
    U = cfg.update_interval
    b, n = cache.k.shape[:2]
    st = starts.to(torch.int32).clamp(0, n - U)
    lidx = (st[:, None] + torch.arange(U, dtype=torch.int32,
                                       device=st.device)).contiguous()
    blk = gather_rows_paged(cache.k, None, row_tables(b, cache.k.device),
                            lidx)                               # (b, U, G, hd)
    meta = _encode_block(blk, cfg, signs)                       # (b, G, U, B)
    rows, at = torch.arange(b, device=st.device)[:, None], lidx.long()
    keep = mask[:, None, None, None]
    for dst, new in zip(cache[2:], meta):
        old = dst[rows, :, at]                                  # (b, U, G, B)
        dst[rows, :, at] = torch.where(keep, new.transpose(1, 2), old)
    return cache


# ---------------------------------------------------------- chunked fill ----
# A mixed prefill+decode step (models/serve.py:decode_chunk with
# prefill_budget > 0) writes one prompt chunk of the filling slot: K/V and
# metadata at positions [start, start + valid_n) of its row, contiguous or
# through its block-table row, and — paged — advances its histogram. The
# host knows every fill's progress, so ``start`` and ``valid_n`` are ints
# and the last partial chunk's pad tail is simply not written.

def fill_enc_end(fill_pos, cfg: ParisKVConfig):
    """Retrieval-region end once the first ``fill_pos`` prompt tokens are
    written (an int, or a tensor elementwise): ``initial_regions``' bound
    as a function of fill progress, so a completed fill lands on the
    regions of a solo prefill of the same prompt."""
    if isinstance(fill_pos, torch.Tensor):
        f = fill_pos.to(torch.int32)
        return torch.maximum(f.clamp_max(cfg.sink_size), f - cfg.local_size)
    f = int(fill_pos)
    return max(min(cfg.sink_size, f), f - cfg.local_size)


def fill_chunk_write(cache: LayerKVCache, row: int, start: int,
                     k_chunk: torch.Tensor, v_chunk: torch.Tensor,
                     valid_n: int, meta=None) -> LayerKVCache:
    """Write the first ``valid_n`` of a chunk's K/V (P, G, hd) into batch
    row ``row`` at positions [start, start + valid_n), in place; positions
    past the store are dropped. ``meta``: the chunk's metadata, (1, G, P,
    B) each."""
    m = max(0, min(valid_n, cache.k.shape[1] - start))
    cache.k[row, start:start + m] = k_chunk[:m].to(cache.k.dtype)
    cache.v[row, start:start + m] = v_chunk[:m].to(cache.v.dtype)
    if meta is not None:
        for dst, new in zip(cache[2:], meta):
            dst[row, :, start:start + m] = new[0, :, :m]
    return cache


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A small host index array on ``device`` with no device
    synchronization (through pinned memory on a card)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.int64))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def paged_fill_index(bt_row, start: int, valid_n: int, block_size: int,
                     device) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Host side of a chunk write through a block-table row: ``bt_row``
    (nblk,) on the host (the engine's table) → (chunk entries, physical
    blocks, offsets) on ``device`` for the positions [start, start +
    valid_n) whose block is allocated and inside the table; the others are
    dropped, as the reference drops them."""
    row = np.asarray(bt_row).reshape(-1)
    lidx = start + np.arange(valid_n)
    blk = lidx // block_size
    pb = row[np.minimum(blk, row.shape[0] - 1)]
    sel = np.flatnonzero((blk < row.shape[0]) & (pb >= 0))
    return (_upload(sel, device), _upload(pb[sel], device),
            _upload(lidx[sel] % block_size, device))


def _write_rows(pool_k, pool_v, index, k_chunk, v_chunk) -> None:
    sel, pb, off = index
    pool_k[pb, off] = k_chunk[sel].to(pool_k.dtype)
    pool_v[pb, off] = v_chunk[sel].to(pool_v.dtype)


def _write_meta(pool: PagedLayerKVCache, index, meta) -> None:
    sel, pb, off = index
    for dst, new in zip(pool[2:], meta):              # new: (1, G, P, B)
        dst[pb, :, off] = new[0].transpose(0, 1)[sel]


def paged_fill_chunk_write(pool: PagedLayerKVCache, bt_row,
                           start: int, k_chunk: torch.Tensor,
                           v_chunk: torch.Tensor, valid_n: int, meta=None,
                           index=None) -> PagedLayerKVCache:
    """Paged ``fill_chunk_write``: the chunk goes through the slot's
    block-table row ``bt_row`` (nblk,) on the host, in place; writes into
    unallocated blocks or past the table are dropped. ``index`` is a
    precomputed ``paged_fill_index`` (one per step, shared by every
    layer)."""
    if index is None:
        index = paged_fill_index(bt_row, start, valid_n, pool.k.shape[1],
                                 pool.k.device)
    _write_rows(pool.k, pool.v, index, k_chunk, v_chunk)
    if meta is not None:
        _write_meta(pool, index, meta)
    return pool


def tiered_fill_chunk_write(pool: PagedLayerKVCache, bt_row, kv_row,
                            start: int, k_chunk: torch.Tensor,
                            v_chunk: torch.Tensor, valid_n: int, meta=None,
                            index=None, kv_index=None) -> PagedLayerKVCache:
    """Tiered ``paged_fill_chunk_write``: K/V through the composed staging
    row ``kv_row`` (the fill frontier is pinned staged), metadata through
    the host row ``bt_row``, both (nblk,) on the host; each side drops
    what its own row leaves unmapped. ``index`` / ``kv_index``: precomputed
    ``paged_fill_index`` of the two rows."""
    bs = pool.k.shape[1]
    if kv_index is None:
        kv_index = paged_fill_index(kv_row, start, valid_n, bs,
                                    pool.k.device)
    _write_rows(pool.k, pool.v, kv_index, k_chunk, v_chunk)
    if meta is not None:
        if index is None:
            index = paged_fill_index(bt_row, start, valid_n, bs,
                                     pool.k.device)
        _write_meta(pool, index, meta)
    return pool


def paged_fill_hist_update(pool: PagedLayerKVCache, hist_row: torch.Tensor,
                           bt_row: torch.Tensor, f0: int, f1: int,
                           cfg: ParisKVConfig) -> torch.Tensor:
    """Advance the filling slot's histogram ``hist_row`` (1, G, B, 2^m) in
    place by the retrieval region's growth [enc(f0), enc(f1)) as the fill
    frontier moves f0 → f1: the bucket counts of the positions [max(enc(f0),
    sink), enc(f1)) under allocated blocks of ``bt_row`` (1, nblk) on the
    pool's device (kernels/collision ``bucket_count_span``). Runs after
    the chunk's metadata is written: the counted positions can lie in this
    very chunk. Keeps ``hist == histogram(ids, [sink, enc_end))`` true at
    every mixed step of a fill."""
    lo = max(fill_enc_end(f0, cfg), cfg.sink_size)
    return bucket_count_span(pool.meta_ids, bt_row, lo, fill_enc_end(f1, cfg),
                             cfg.num_centroids(), hist_row)


def promote_trigger(regions: CacheRegions, cfg: ParisKVConfig) -> torch.Tensor:
    """Per-row bool: True where the Local+Buffer window is full."""
    return (regions.pos + 1 - regions.enc_end) >= window_size(cfg)


def maybe_promote(cache: LayerKVCache, regions: CacheRegions,
                  cfg: ParisKVConfig, signs: torch.Tensor
                  ) -> Tuple[LayerKVCache, CacheRegions]:
    """Sliding-window update (§4.2.1), per row: every row whose window is
    full encodes its oldest ``update_interval`` tokens and advances its
    enc_end. The reference skips the encode with ``lax.cond`` when no row
    triggers; here a host ``if`` decides (one device synchronization)."""
    trigger = promote_trigger(regions, cfg)
    if bool(trigger.any()):
        promote_rows(cache, regions.enc_end, trigger, cfg, signs)
    new_enc = torch.where(trigger, regions.enc_end + cfg.update_interval,
                          regions.enc_end)
    return cache, CacheRegions(pos=regions.pos, enc_end=new_enc)


# ----------------------------------------------------------- paged pool ----
def init_paged_cache(num_blocks: int, block_size: int, num_kv_heads: int,
                     head_dim: int, cfg: ParisKVConfig, dtype, device
                     ) -> PagedLayerKVCache:
    return init_tiered_cache(num_blocks, num_blocks, block_size,
                             num_kv_heads, head_dim, cfg, dtype, device)


def paged_lookup_blocks(block_tables: torch.Tensor, lidx: torch.Tensor,
                        block_size: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row table lookup: logical positions (b, ...) → (physical block,
    offset); entries < 0 pass through for callers to clip or drop, and
    positions past the table read as unallocated (-1)."""
    b, nblk = block_tables.shape
    blk = torch.div(lidx, block_size, rounding_mode="floor")
    off = lidx - blk * block_size
    pb = block_tables.gather(1, blk.clamp(0, nblk - 1).reshape(b, -1).long()
                             ).reshape(blk.shape)
    return torch.where(blk < nblk, pb, -1), off


def paged_append_index(block_tables: torch.Tensor, pos: torch.Tensor,
                       block_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rows, physical block, offset) of the decode appends at per-row
    logical position ``pos`` (clamped to the last position, as the
    reference does for a row frozen at capacity), keeping only rows whose
    block is allocated. Selecting them synchronizes with the device once,
    so a decode step computes this once and shares it across layers."""
    n_log = block_tables.shape[1] * block_size
    lidx = pos.clamp_max(n_log - 1)
    pb, off = paged_lookup_blocks(block_tables, lidx, block_size)
    rows = torch.nonzero(pb >= 0).flatten()
    return rows, pb[rows].long(), off[rows].long()


def paged_decode_append(pool: PagedLayerKVCache, block_tables: torch.Tensor,
                        k_t: torch.Tensor, v_t: torch.Tensor,
                        pos: torch.Tensor, index=None) -> PagedLayerKVCache:
    """Append one token's K/V (b, G, hd) at per-row logical position ``pos``
    through the block table, in place; writes through unallocated blocks
    are dropped. ``index`` is a precomputed ``paged_append_index``."""
    if index is None:
        index = paged_append_index(block_tables, pos, pool.k.shape[1])
    rows, pb, off = index
    pool.k.index_put_((pb, off), k_t[rows].to(pool.k.dtype))
    pool.v.index_put_((pb, off), v_t[rows].to(pool.v.dtype))
    return pool


def paged_meta_view(pool: PagedLayerKVCache, block_tables: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each row's logical metadata view through its block table: (ids,
    codes, weights), each (b, G, nblk·bs, B), materialized (the meta-view
    fallback's per-step gather). Unallocated entries clip to block 0; the
    retrieval region never reaches them."""
    nb = pool.meta_ids.shape[0]
    b, nblk = block_tables.shape
    safe = block_tables.clamp(0, nb - 1).long()

    def view(a):
        out = a[safe]                               # (b, nblk, G, bs, B)
        G, bs, B = out.shape[2:]
        return out.transpose(1, 2).reshape(b, G, nblk * bs, B)
    return view(pool.meta_ids), view(pool.meta_codes), view(pool.meta_w)


def paged_gather_rows(pool_k: torch.Tensor, pool_v: Optional[torch.Tensor],
                      block_tables: torch.Tensor, lidx: torch.Tensor):
    """K (and V) rows at per-row logical positions: pool (nb, bs, G, hd),
    lidx (b, L) → (b, L, G, hd) each (kernels/gather_kv, mode logical)."""
    return gather_rows_paged(pool_k, pool_v, block_tables,
                             lidx.to(torch.int32).contiguous())


def paged_ids_view(pool: PagedLayerKVCache,
                   block_tables: torch.Tensor) -> torch.Tensor:
    """Each row's logical centroid-id view (b, G, n, B) through its table
    (unallocated entries clip to block 0). Audits only: the fused decode
    path never materializes it."""
    nb = pool.meta_ids.shape[0]
    b, nblk = block_tables.shape
    ids = pool.meta_ids[block_tables.clamp(0, nb - 1).long()]
    G, bs, B = ids.shape[2:]
    return ids.transpose(1, 2).reshape(b, G, nblk * bs, B)


def bucket_hist_from_meta(meta_ids: torch.Tensor, regions: CacheRegions,
                          cfg: ParisKVConfig) -> torch.Tensor:
    """Histogram a contiguous metadata store (b, G, n, B) over each row's
    [sink, enc_end) → (b, G, B, 2^m) int32 (kernels/collision
    ``bucket_count``)."""
    return bucket_count(meta_ids, regions.enc_end, cfg.sink_size,
                        cfg.num_centroids())


def paged_promote_rows_hist(pool: PagedLayerKVCache, hist: torch.Tensor,
                            block_tables: torch.Tensor, starts: torch.Tensor,
                            mask: torch.Tensor, cfg: ParisKVConfig,
                            signs: torch.Tensor,
                            kv_tables: Optional[torch.Tensor] = None
                            ) -> Tuple[PagedLayerKVCache, torch.Tensor]:
    """Encode metadata for the keys at logical positions
    [starts[i], starts[i] + update_interval) of every row with ``mask[i]``,
    write it to their physical blocks and add their buckets to ``hist``
    (positions >= sink under allocated blocks only), all in place.

    No decrement is needed: the span starts at the pre-promotion enc_end,
    so the stale ids it overwrites were never counted.

    ``kv_tables`` (default ``block_tables``) addresses the K gather: a
    tiered pool passes its composed staging tables while the metadata
    scatter keeps the host tables (the promoted span lies in the pinned
    local window, so its blocks are always staged)."""
    U = cfg.update_interval
    bs = pool.k.shape[1]
    lidx = starts[:, None] + torch.arange(U, device=starts.device)[None]
    kvt = block_tables if kv_tables is None else kv_tables
    rows = paged_gather_rows(pool.k, None, kvt, lidx)          # (b,U,G,hd)
    meta = _encode_block(rows, cfg, signs)                       # (b,G,U,B)
    pb, off = paged_lookup_blocks(block_tables, lidx, bs)
    write = mask[:, None] & (pb >= 0)                            # (b, U)
    tgt, toff = pb[write].long(), off[write].long()
    for dst, new in zip(pool[2:], meta):
        dst[tgt, :, toff] = new.transpose(1, 2)[write]
    inc = write & (lidx >= cfg.sink_size)
    hist += bucket_histogram(meta.centroid_ids, inc[:, None, :],
                             cfg.num_centroids())
    return pool, hist


def paged_maybe_promote_hist(pool: PagedLayerKVCache, hist: torch.Tensor,
                             block_tables: torch.Tensor,
                             regions: CacheRegions, cfg: ParisKVConfig,
                             signs: torch.Tensor
                             ) -> Tuple[PagedLayerKVCache, torch.Tensor,
                                        CacheRegions]:
    """Sliding-window promotion of every row whose window is full, with the
    histogram maintained. The reference guards the encode with a traced
    ``lax.cond``; here a host ``if`` decides, which costs one device
    synchronization per call."""
    trigger = promote_trigger(regions, cfg)
    if bool(trigger.any()):
        pool, hist = paged_promote_rows_hist(pool, hist, block_tables,
                                             regions.enc_end, trigger, cfg,
                                             signs)
    new_enc = torch.where(trigger, regions.enc_end + cfg.update_interval,
                          regions.enc_end)
    return pool, hist, CacheRegions(pos=regions.pos, enc_end=new_enc)


def paged_scatter_prefill(pool: PagedLayerKVCache, cache1: LayerKVCache,
                          phys_blocks: torch.Tensor) -> PagedLayerKVCache:
    """Install a solo (batch=1) contiguous prefill of one layer into the
    pool, in place. ``phys_blocks`` (n_logical // bs,) maps each logical
    block to its physical block; entries outside [0, num_blocks) are
    sentinels for blocks the allocator did not hand out and are skipped."""
    nb, bs = pool.k.shape[:2]
    nblk = phys_blocks.shape[0]
    keep = torch.nonzero((phys_blocks >= 0) & (phys_blocks < nb)).flatten()
    dst = phys_blocks[keep].long()
    for pool_t, src in ((pool.k, cache1.k), (pool.v, cache1.v)):
        view = src[0].reshape((nblk, bs) + src.shape[2:])
        pool_t[dst] = view[keep].to(pool_t.dtype)
    return tiered_scatter_prefill_meta(pool, cache1, phys_blocks)


def paged_clear_blocks(pool: PagedLayerKVCache,
                       phys_blocks: torch.Tensor) -> PagedLayerKVCache:
    """Zero the given physical blocks in place (eviction hygiene); entries
    outside [0, num_blocks) are sentinels and skipped."""
    nb = pool.k.shape[0]
    blocks = phys_blocks[(phys_blocks >= 0) & (phys_blocks < nb)].long()
    for t in pool:
        t[blocks] = 0
    return pool


# --------------------------------------------------------- tiered pool ----
# The tiered layout keeps the retrieval metadata of all ``num_blocks``
# blocks on the device but bounds the K/V leaves to ``num_device_blocks``
# staging blocks; the full K/V pool lives in host memory
# (serving/offload.py:HostKVPool). Metadata goes through the host block
# tables; K/V through the composed tables ``tiered_kv_tables(bt,
# dev_map)``, where "unallocated" and "allocated but not staged" both come
# out < 0. The engine pins every block a chunk writes or reads densely
# (sink, window, append frontier), so appends, promotion gathers and the
# sink/window reads always hit staging; Stage-II winners may be missing
# and are read from the host pool (kernels/gather_kv:gather_heads_tiered).

def init_tiered_cache(num_blocks: int, num_device_blocks: int,
                      block_size: int, num_kv_heads: int, head_dim: int,
                      cfg: ParisKVConfig, dtype, device) -> PagedLayerKVCache:
    """Tiered pool: meta leaves of ``num_blocks`` blocks, K/V staging
    leaves of ``num_device_blocks`` (equal counts: the resident pool)."""
    B = cfg.num_subspaces(head_dim)
    g = num_kv_heads

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return PagedLayerKVCache(
        k=z((num_device_blocks, block_size, g, head_dim), dtype),
        v=z((num_device_blocks, block_size, g, head_dim), dtype),
        meta_ids=z((num_blocks, g, block_size, B), torch.uint8),
        meta_codes=z((num_blocks, g, block_size, B), torch.int32),
        meta_w=z((num_blocks, g, block_size, B), torch.float32))


def tiered_kv_tables(block_tables: torch.Tensor,
                     dev_map: torch.Tensor) -> torch.Tensor:
    """Compose per-slot host block tables (b, nblk) (< 0 unallocated) with
    the residency map ``dev_map`` (num_blocks,) (host block → staging
    block, -1 not staged) → (b, nblk) staging blocks, < 0 wherever the
    block is unallocated or not staged."""
    nb = dev_map.shape[0]
    mapped = dev_map[block_tables.clamp(0, nb - 1).long()]
    return torch.where(block_tables >= 0, mapped, -1).to(torch.int32)


def tiered_scatter_prefill_meta(pool: PagedLayerKVCache,
                                cache1: LayerKVCache,
                                phys_blocks: torch.Tensor
                                ) -> PagedLayerKVCache:
    """Metadata half of ``paged_scatter_prefill`` for a solo (batch=1)
    admission into a tiered pool, in place: the prompt's K/V goes to the
    host pool and reaches staging through the residency installer. Entries
    of ``phys_blocks`` outside [0, num_blocks) are skipped."""
    nb, _, bs = pool.meta_ids.shape[:3]
    nblk = phys_blocks.shape[0]
    keep = torch.nonzero((phys_blocks >= 0) & (phys_blocks < nb)).flatten()
    dst = phys_blocks[keep].long()
    for pool_t, src in zip(pool[2:], cache1[2:]):
        g, B = src.shape[1], src.shape[-1]
        view = src[0].reshape(g, nblk, bs, B).transpose(0, 1)
        pool_t[dst] = view[keep].to(pool_t.dtype)
    return pool


def tiered_stage_blocks(pool: PagedLayerKVCache, stag_blocks: torch.Tensor,
                        k_payload: torch.Tensor, v_payload: torch.Tensor
                        ) -> PagedLayerKVCache:
    """Install host K/V block payloads (n, block_size, G, hd) into staging
    slots ``stag_blocks`` (n,), in place; ids outside [0,
    num_device_blocks) are pad slots and skipped."""
    nd = pool.k.shape[0]
    keep = torch.nonzero((stag_blocks >= 0) & (stag_blocks < nd)).flatten()
    dst = stag_blocks[keep].long()
    for dst_t, src in ((pool.k, k_payload), (pool.v, v_payload)):
        dst_t[dst] = src[keep.to(src.device)].to(dst_t.device, dst_t.dtype)
    return pool


def tiered_clear_blocks(pool: PagedLayerKVCache, meta_blocks: torch.Tensor,
                        stag_blocks: torch.Tensor) -> PagedLayerKVCache:
    """Eviction hygiene for a tiered pool, in place: zero the host blocks
    ``meta_blocks`` on the metadata leaves and the staging blocks
    ``stag_blocks`` on the K/V leaves (two id spaces); out-of-range ids
    are sentinels and skipped."""
    nd, nb = pool.k.shape[0], pool.meta_ids.shape[0]
    sb = stag_blocks[(stag_blocks >= 0) & (stag_blocks < nd)].long()
    mb = meta_blocks[(meta_blocks >= 0) & (meta_blocks < nb)].long()
    for t in pool[:2]:
        t[sb] = 0
    for t in pool[2:]:
        t[mb] = 0
    return pool
