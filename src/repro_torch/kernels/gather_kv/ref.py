"""Plain PyTorch versions of the K/V row gathers: through the block table
(ports of ``repro/core/cache.py:paged_gather_rows`` and
``gather_heads_physical``, and the decode gather built from the two; a
contiguous store goes through its one-block-per-row table) and tiered (the
winner hit/miss blend of
``repro/models/layers.py:attn_decode_pariskv_tiered``, and the distinct
host rows it reads, counted as ``repro/serving/offload.py:
_dedup_heads_gather`` counts them)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.rerank.ref import block_relative


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


def gather_decode_paged_ref(pool_k: torch.Tensor,
                            pool_v: Optional[torch.Tensor],
                            block_tables: torch.Tensor,
                            window_start: torch.Tensor, sink: int,
                            window: int, phys_rows=None):
    """The decode gather as the two plain gathers: sink and window rows at
    the positions [0, sink) ++ [ws, ws + window) (``gather_rows_paged_ref``)
    and the winners' head rows (``gather_heads_physical_ref``) → (k_dense,
    v_dense, k_ret, v_ret), the winners None without ``phys_rows``, the V
    parts None when ``pool_v`` is None (K only)."""
    b = window_start.shape[0]
    dev = window_start.device
    lidx = torch.cat([torch.arange(sink, device=dev).expand(b, sink),
                      window_start[:, None]
                      + torch.arange(window, device=dev)], dim=1)
    pools = (pool_k, pool_v)
    dense = [None if p is None else gather_rows_paged_ref(p, block_tables,
                                                          lidx)
             for p in pools]
    ret = [None, None] if phys_rows is None else [
        None if p is None else gather_heads_physical_ref(p, phys_rows)
        for p in pools]
    return (*dense, *ret)


def _owned(pos: torch.Tensor, row_base: int, row_count: int):
    """Global positions → (owned, local position clamped into the store)."""
    own = (pos >= row_base) & (pos < row_base + row_count)
    return own, (pos - row_base).clamp(0, row_count - 1)


def gather_rows_masked_ref(pool: torch.Tensor, block_tables: torch.Tensor,
                           lidx: torch.Tensor, row_base: int,
                           row_count: int) -> torch.Tensor:
    """``gather_rows_paged_ref`` at global positions ``lidx`` (b, L) of a
    store holding [row_base, row_base + row_count): rows outside it are
    zero."""
    own, loc = _owned(lidx, row_base, row_count)
    rows = gather_rows_paged_ref(pool, block_tables, loc)
    return torch.where(own[..., None, None], rows, torch.zeros_like(rows))


def gather_decode_masked_ref(pool_k: torch.Tensor, pool_v: torch.Tensor,
                             block_tables: torch.Tensor,
                             window_start: torch.Tensor, sink: int,
                             window: int, positions: torch.Tensor,
                             row_base: int, row_count: int):
    """The rank-masked decode gather: sink and window rows at the global
    positions [0, sink) ++ [ws, ws + window) (``gather_rows_masked_ref``),
    and the winners' head rows at global ``positions`` (b, G, Q, k)
    through the block table, zero where the store does not hold them →
    (k_dense, v_dense, k_ret, v_ret)."""
    b = window_start.shape[0]
    dev = window_start.device
    lidx = torch.cat([torch.arange(sink, device=dev).expand(b, sink),
                      window_start[:, None]
                      + torch.arange(window, device=dev)], dim=1)
    own, loc = _owned(positions, row_base, row_count)
    _, phys = block_relative(loc, block_tables, pool_k.shape[1])
    outs = []
    for pool in (pool_k, pool_v):
        ret = gather_heads_physical_ref(pool, phys)
        outs.append((gather_rows_masked_ref(pool, block_tables, lidx,
                                            row_base, row_count),
                     torch.where(own[..., None], ret, torch.zeros_like(ret))))
    (k_dense, k_ret), (v_dense, v_ret) = outs
    return k_dense, v_dense, k_ret, v_ret


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


# The tiered kernel's roles (csrc/gather_rows_tiered.cu), for the plan's
# tests: what each entry is and which block writes it.
ZERO, STAGED, LEADER, FOLLOWER = 0, 1, 2, 3


def tiered_roles(rows: torch.Tensor, dev_map: torch.Tensor, bs: int,
                 G: int, blocks_per_head: int, pass_entries: int) -> dict:
    """The tiered kernel's plan over rows (b, G, Q, k), modelled plainly.
    Kv head g's entries are numbered j = batch row · Q·k + position (E of
    them); block (g, h) of the G × H grid writes
      * a missed entry (row >= 0, its block unstaged) of key (row, g) when
        phys % H == h, phys the row clamped into the host pool: the key's
        first entry leads (read from the host), the others follow (copy
        the leader's output row);
      * a zero (row < 0) or staged entry when E·h // H <= j < E·(h+1) // H.
    Pass: j // pass_entries. (The kernel elects any entry of the key's
    first pass; the bytes are the same.) → dict of (b, G, Q, k) tensors:
    ``role`` (ZERO, STAGED, LEADER or FOLLOWER), ``block`` (h), ``pass_``,
    ``leader`` (a follower's leader as a flat index into rows, else -1)."""
    b, _, Q, k = rows.shape
    H, E = blocks_per_head, b * Q * k
    nrows = dev_map.shape[0] * bs
    r = rows.long().permute(1, 0, 2, 3).reshape(G, E)
    phys = r.clamp(0, nrows - 1)
    j = torch.arange(E).expand(G, E)
    missed = (r >= 0) & (dev_map.long()[torch.div(phys, bs,
                                                  rounding_mode="floor")] < 0)
    role = torch.where(r < 0, ZERO, STAGED)
    first = torch.full((G, nrows), E).scatter_reduce(
        1, phys, torch.where(missed, j, E), "amin")
    lead_j = first.gather(1, phys)
    role = torch.where(missed, torch.where(lead_j == j, LEADER, FOLLOWER),
                       role)
    block = torch.where(missed, phys % H, ((j + 1) * H - 1) // E)

    def flat(jj):                        # (g, j) → flat index into rows
        g = torch.arange(G)[:, None]
        return ((jj // (Q * k)) * G + g) * (Q * k) + jj % (Q * k)
    leader = torch.where(role == FOLLOWER, flat(lead_j), -1)

    def back(t):
        return t.reshape(G, b, Q, k).permute(1, 0, 2, 3)
    return dict(role=back(role), block=back(block),
                pass_=back(j // pass_entries), leader=back(leader))


def gather_heads_tiered_plan_ref(stag_k: torch.Tensor, stag_v: torch.Tensor,
                                 host_k: torch.Tensor, host_v: torch.Tensor,
                                 dev_map: torch.Tensor, rows: torch.Tensor,
                                 blocks_per_head: int, pass_entries: int):
    """The tiered gather built from ``tiered_roles`` as the kernel builds
    it: zeros, staged rows from the staging pool, leaders' rows from the
    host pool, then each follower a copy of its leader's output row; the
    count is the leaders'. → (k_ret, v_ret, distinct missed pairs)."""
    nd, bs, G, hd = stag_k.shape
    nrows = dev_map.shape[0] * bs
    plan = tiered_roles(rows, dev_map, bs, G, blocks_per_head, pass_entries)
    role = plan["role"].reshape(-1)
    want = rows.long()
    phys = want.clamp(0, nrows - 1)
    s = dev_map.long()[torch.div(phys, bs, rounding_mode="floor")]
    heads = torch.arange(G)[None, :, None, None].expand(want.shape)
    stag_row = ((s.clamp(0, nd - 1) * bs + phys % bs) * G + heads).reshape(-1)
    host_row = (phys * G + heads).reshape(-1)
    outs = []
    for stag, host in ((stag_k, host_k), (stag_v, host_v)):
        out = torch.zeros((role.numel(), hd), dtype=stag.dtype)
        for r, src, idx in ((STAGED, stag.reshape(-1, hd), stag_row),
                            (LEADER, host.reshape(-1, hd), host_row)):
            sel = role == r
            out[sel] = src[idx[sel]]
        sel = role == FOLLOWER
        out[sel] = out[plan["leader"].reshape(-1)[sel]]
        outs.append(out.reshape(tuple(rows.shape) + (hd,)))
    return outs[0], outs[1], int((role == LEADER).sum())
