"""Wrappers of the K/V row gather kernels: through the block table
(csrc/gather_rows_paged.cu: a decode step's sink, window and winner rows,
or promotion rows by logical position; over a paged pool, or a contiguous
store through its one-block-per-row table ``row_tables``) and tiered
(csrc/gather_rows_tiered.cu).

K and V go through one launch: pass the V tensor to get
``(k_rows, v_rows)``, or ``None`` for a single tensor (promotion gathers K
only)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, row_tables
from repro_torch.kernels import build as K
from repro_torch.kernels.gather_kv.ref import (
    gather_decode_paged_ref, gather_heads_tiered_dedup_ref,
    gather_rows_paged_ref)


def _launch(pool_k, pool_v, block_tables, b, L, *, lidx=None, wstart=None,
            sink=0, phys=None):
    """One launch of the paged gather: ``L`` dense rows per batch row (at
    ``lidx``, or sink and window rows from ``wstart``) and the winner head
    rows at ``phys``, for K (and V) → ([dense K, dense V], [winners K,
    winners V]), absent parts empty lists."""
    pools = [p for p in (pool_k, pool_v) if p is not None]
    idx = [t for t in (lidx, wstart, phys) if t is not None]
    K.check_cuda("gather_rows_paged", *pools, block_tables, *idx)
    nb, bs, G, hd = pool_k.shape
    head_bytes = hd * pool_k.element_size()
    if head_bytes % 16:
        raise ValueError(f"gather_rows_paged: head rows of {head_bytes} bytes "
                         f"are not a multiple of 16")
    if any(t.dtype != torch.int32 for t in [block_tables, *idx]):
        raise TypeError("gather_rows_paged: expects int32 indices/tables")
    if pool_v is not None and (pool_v.shape != pool_k.shape
                               or pool_v.dtype != pool_k.dtype):
        raise ValueError("gather_rows_paged: K and V pools differ")
    dense = [torch.empty((b, L, G, hd), dtype=p.dtype, device=p.device)
             for p in pools] if L else []
    ret = [torch.empty(tuple(phys.shape) + (hd,), dtype=p.dtype,
                       device=p.device) for p in pools] if phys is not None \
        else []
    head_vec = head_bytes // 16

    def two(outs):
        return ((K.ptr(outs[0]), K.ptr(outs[-1])) if outs
                else (K.ptr(None),) * 2)
    K.launch("gather_rows_paged", K.ptr(pools[0]), K.ptr(pools[-1]),
             *two(dense), *two(ret), K.ptr(lidx), K.ptr(wstart),
             K.ptr(block_tables), K.ptr(phys), b * L * G * head_vec,
             0 if phys is None else phys.numel() * head_vec, L, sink,
             block_tables.shape[-1], nb, bs, G,
             1 if phys is None else phys.shape[2] * phys.shape[3], head_vec,
             len(pools))
    LAUNCHES["gather_rows_paged"] += 1
    return dense, ret


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
        outs, _ = _launch(pool_k, pool_v, block_tables, *lidx.shape,
                          lidx=lidx)
    return outs[0] if pool_v is None else tuple(outs)


def gather_decode_paged(pool_k: torch.Tensor, pool_v: torch.Tensor,
                        block_tables: torch.Tensor, window_start: torch.Tensor,
                        sink: int, window: int,
                        phys_rows: Optional[torch.Tensor] = None):
    """A decode step's K/V rows in one launch: each row's ``sink`` sink rows
    and ``window`` window rows through its block table (positions
    [0, sink) and [ws, ws + window), computed from ``window_start``), and
    the winners' head rows by flat physical pool row.

    pool_k/v (nb, bs, G, hd), block_tables (b, nblk) int32, window_start
    (b,) int32, phys_rows (b, G, Q, k) int32 or None → (k_dense, v_dense,
    k_ret, v_ret): dense (b, sink + window, G, hd), sink rows first;
    winners (b, G, Q, k, hd), or None without ``phys_rows``. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if pool_k.device.type == "cpu":
        return gather_decode_paged_ref(pool_k, pool_v, block_tables,
                                       window_start, sink, window, phys_rows)
    b = window_start.shape[0]
    dense, ret = _launch(pool_k, pool_v, block_tables, b, sink + window,
                         wstart=window_start, sink=sink, phys=phys_rows)
    return (*dense, *(ret or (None, None)))


def gather_kv_kernel(store: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The reference's batched contract: store (..., n, d), idx (..., k)
    positions in [0, n) (broadcast to the store's leading dims) →
    (..., k, d). The R = prod(...) stores are a pool (R, n, 1, d) of one
    block per store (``row_tables``), gathered in the logical mode."""
    lead = store.shape[:-2]
    n, d = store.shape[-2:]
    k = idx.shape[-1]
    flat_idx = idx.expand(lead + (k,)).reshape(-1, k).to(torch.int32)
    R = flat_idx.shape[0]
    out = gather_rows_paged(store.reshape(R, n, 1, d), None,
                            row_tables(R, store.device),
                            flat_idx.contiguous())
    return out.reshape(lead + (k, d))


# ----------------------------------------- tiered (gather_rows_tiered.cu) ---
# threads per block of the tiered gather, and at most this many blocks in
# the cluster of one kv head's group (csrc/gather_rows_tiered.cu)
TIERED_THREADS = 256
TIERED_MAX_CLUSTER = 16

_OWNERS: dict = {}


def _owner_table(device: torch.device, n: int) -> torch.Tensor:
    """The tiered gather's (row, kv head) → leader table: ``n`` int32, all
    -1 between launches (each launch clears what it claimed). One per
    device and size; launches that share it must be stream-ordered."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (str(device), n)
    if key not in _OWNERS:
        _OWNERS[key] = torch.full((n,), -1, dtype=torch.int32, device=device)
    return _OWNERS[key]


def tiered_cluster(entries: int, threads: int = TIERED_THREADS) -> int:
    """Blocks in the cluster of one kv head's group of ``entries`` (every
    batch row's): a power of two giving each thread at most about half an
    entry, at most ``TIERED_MAX_CLUSTER``."""
    cluster = 1
    while cluster < TIERED_MAX_CLUSTER and cluster * threads < 2 * entries:
        cluster *= 2
    return cluster


def launch_tiered(stag_k, stag_v, host_k, host_v, dev_map, rows, count,
                  cluster: int, threads: int):
    """One launch of the tiered gather at a given grid (the wrapper's
    checks, no launch count: ``gather_heads_tiered`` counts)."""
    K.check_cuda("gather_rows_tiered", stag_k, stag_v, dev_map, rows)
    nd, bs, G, hd = stag_k.shape
    nb = dev_map.shape[0]
    for name, h in (("host_k", host_k), ("host_v", host_v)):
        if h.device.type != "cpu" or not h.is_pinned():
            raise ValueError(f"gather_rows_tiered: {name} must be pinned "
                             f"host memory (got {h.device}, pinned="
                             f"{h.device.type == 'cpu' and h.is_pinned()})")
        if (tuple(h.shape) != (nb * bs, G, hd) or h.dtype != stag_k.dtype
                or not h.is_contiguous()):
            raise ValueError(f"gather_rows_tiered: {name} must be a "
                             f"contiguous {stag_k.dtype} (nb*bs, G, hd) = "
                             f"{(nb * bs, G, hd)} tensor, got "
                             f"{h.dtype} {tuple(h.shape)}")
    if stag_v.shape != stag_k.shape or stag_v.dtype != stag_k.dtype:
        raise ValueError("gather_rows_tiered: K and V staging pools differ")
    if rows.dtype != torch.int32 or dev_map.dtype != torch.int32:
        raise TypeError("gather_rows_tiered: expects int32 rows and dev_map")
    if count is not None and (count.dtype != torch.int64
                              or count.device != stag_k.device):
        raise TypeError("gather_rows_tiered: count must be an int64 tensor "
                        "on the staging pool's device")
    row_bytes = hd * stag_k.element_size()
    if row_bytes % 16:
        raise ValueError(f"gather_rows_tiered: rows of {row_bytes} bytes are "
                         f"not a multiple of 16")
    b, _, Q, k = rows.shape
    outs = [torch.empty((b, G, Q, k, hd), dtype=stag_k.dtype,
                        device=stag_k.device) for _ in range(2)]
    K.launch("gather_rows_tiered", K.ptr(stag_k), K.ptr(stag_v),
             K.ptr(host_k), K.ptr(host_v), K.ptr(outs[0]), K.ptr(outs[1]),
             K.ptr(rows), K.ptr(dev_map),
             K.ptr(_owner_table(stag_k.device, nb * bs * G)), K.ptr(count),
             b, nb, nd, bs, G, Q * k, row_bytes // 16, cluster, threads)
    return tuple(outs)


def gather_heads_tiered(stag_k: torch.Tensor, stag_v: torch.Tensor,
                        host_k: torch.Tensor, host_v: torch.Tensor,
                        dev_map: torch.Tensor, rows: torch.Tensor,
                        count: Optional[torch.Tensor] = None):
    """Stage-II winners of a tiered pool, K and V in one launch, each
    distinct missed (row, kv head) read from the host pool once.

    stag_k/v (nd, bs, G, hd) the staging pool; host_k/v (nb·bs, G, hd) the
    host pool's rows (pinned when the staging pool is on a card); dev_map
    (nb,) int32; rows (b, G, Q, k) int32 flat host rows, < 0 for a zero
    row → (k_ret, v_ret) (b, G, Q, k, hd): staged rows from the staging
    pool, the others from the host pool (``gather_heads_tiered_dedup_ref``).
    ``count``, an int64 tensor, grows in its first element by the distinct
    missed (row, kv head) pairs, with no host synchronization on a card.
    Rows are deduplicated over the whole call (every batch row), as the
    reference deduplicates. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise (a pageable host pool
    would fault on the card, so it raises)."""
    if stag_k.device.type == "cpu":
        k_ret, v_ret, distinct = gather_heads_tiered_dedup_ref(
            stag_k, stag_v, host_k, host_v, dev_map, rows)
        if count is not None:
            count.view(-1)[0] += distinct
        return k_ret, v_ret
    outs = launch_tiered(stag_k, stag_v, host_k, host_v, dev_map, rows,
                         count, tiered_cluster(rows[:, 0].numel()),
                         TIERED_THREADS)
    LAUNCHES["gather_rows_tiered"] += 1
    return outs
