"""Plain PyTorch versions of the K/V row gathers: through the block table
(ports of ``repro/core/cache.py:paged_gather_rows`` and
``gather_heads_physical``, and the decode gather built from the two; a
contiguous store goes through its one-block-per-row table) and tiered (the
winner hit/miss blend of
``repro/models/layers.py:attn_decode_pariskv_tiered``, and the distinct
host rows it reads, counted as ``repro/serving/offload.py:
_dedup_heads_gather`` counts them)."""
from __future__ import annotations

import torch


def gather_rows_paged_ref(pool: torch.Tensor, block_tables: torch.Tensor,
                          lidx: torch.Tensor) -> torch.Tensor:
    """pool (nb, bs, G, hd), block_tables (b, nblk), lidx (b, L) logical
    positions → (b, L, G, hd). Unallocated (< 0) entries clip to block 0."""
    nb, bs = pool.shape[:2]
    nblk = block_tables.shape[1]
    lidx = lidx.long()
    blk = (lidx // bs).clamp(0, nblk - 1)
    pb = block_tables.long().gather(1, blk).clamp(0, nb - 1)
    flat = pool.reshape((nb * bs,) + pool.shape[2:])
    return flat[pb * bs + lidx % bs]


def gather_heads_physical_ref(pool: torch.Tensor,
                              phys_rows: torch.Tensor) -> torch.Tensor:
    """pool (nb, bs, G, hd), phys_rows (b, G, Q, k) flat pool rows →
    (b, G, Q, k, hd); entry (i, g, q, j) is head g of pool row
    phys_rows[i, g, q, j]."""
    nb, bs, G, hd = pool.shape
    flat = pool.reshape(nb * bs, G, hd)
    rows = phys_rows.long().clamp(0, nb * bs - 1)
    heads = torch.arange(G, device=rows.device)[None, :, None, None]
    return flat[rows, heads]


def gather_decode_paged_ref(pool_k: torch.Tensor, pool_v: torch.Tensor,
                            block_tables: torch.Tensor,
                            window_start: torch.Tensor, sink: int,
                            window: int, phys_rows=None):
    """The decode gather as the two plain gathers: sink and window rows at
    the positions [0, sink) ++ [ws, ws + window) (``gather_rows_paged_ref``)
    and the winners' head rows (``gather_heads_physical_ref``) → (k_dense,
    v_dense, k_ret, v_ret), the winners None without ``phys_rows``."""
    b = window_start.shape[0]
    dev = window_start.device
    lidx = torch.cat([torch.arange(sink, device=dev).expand(b, sink),
                      window_start[:, None]
                      + torch.arange(window, device=dev)], dim=1)
    dense = [gather_rows_paged_ref(p, block_tables, lidx)
             for p in (pool_k, pool_v)]
    ret = [None, None] if phys_rows is None else [
        gather_heads_physical_ref(p, phys_rows) for p in (pool_k, pool_v)]
    return (*dense, *ret)


def gather_heads_tiered_ref(staging: torch.Tensor, host: torch.Tensor,
                            dev_map: torch.Tensor,
                            rows: torch.Tensor) -> torch.Tensor:
    """staging (nd, bs, G, hd); host (nb·bs, G, hd) the full pool's rows;
    dev_map (nb,) host block → staging block (-1 = not staged); rows
    (b, G, Q, k) flat host rows → (b, G, Q, k, hd). Entry (i, g, q, j) is
    zero where rows[i, g, q, j] < 0, head g of the staged copy of that row
    where its block is staged, else head g of the host row."""
    nd, bs, G, hd = staging.shape
    nb = dev_map.shape[0]
    want = rows.long()
    phys = want.clamp(0, nb * bs - 1)
    s = dev_map.long()[torch.div(phys, bs, rounding_mode="floor")]
    heads = torch.arange(G, device=rows.device)[None, :, None, None]
    hit = staging.reshape(nd * bs, G, hd)[
        s.clamp(0, nd - 1) * bs + phys % bs, heads]
    miss = host[phys.to(host.device), heads.to(host.device)].to(hit.device)
    out = torch.where((s >= 0)[..., None], hit, miss)
    return torch.where((want >= 0)[..., None], out, torch.zeros_like(out))


def gather_heads_tiered_dedup_ref(stag_k: torch.Tensor, stag_v: torch.Tensor,
                                  host_k: torch.Tensor, host_v: torch.Tensor,
                                  dev_map: torch.Tensor, rows: torch.Tensor):
    """``gather_heads_tiered_ref`` for K and V, with the host rows a
    deduplicating gather reads, counted by the reference's rule: the
    missed (row, kv head) pairs keyed ``row·G + g``, distinct over the
    whole call. → (k_ret, v_ret, distinct missed pairs)."""
    bs, G = stag_k.shape[1:3]
    want = rows.long()
    phys = want.clamp(0, dev_map.shape[0] * bs - 1)
    miss = (want >= 0) & (dev_map.long()[
        torch.div(phys, bs, rounding_mode="floor")] < 0)
    heads = torch.arange(G, device=rows.device)[None, :, None, None]
    distinct = int(torch.unique((phys * G + heads)[miss]).numel())
    return (gather_heads_tiered_ref(stag_k, host_k, dev_map, rows),
            gather_heads_tiered_ref(stag_v, host_v, dev_map, rows), distinct)
