"""Wrappers of the Stage-I collision kernel (csrc/collision_paged.cu),
over a paged pool or a contiguous store, and of the bucket histogram
(csrc/bucket_count.cu) of a contiguous store's retrieval region or of a
span of logical positions through a block table."""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, SEG_LEN, row_tables
from repro_torch.kernels import build as K
from repro_torch.kernels.collision.ref import (bucket_count_ref,
                                              bucket_count_span_ref,
                                              collision_paged_ref)

# bucket_count's launch: threads per block, and at most this many blocks
# in the cluster of one (b, g) row (csrc/bucket_count.cu)
COUNT_THREADS = 512
COUNT_MAX_CLUSTER = 8


def lane_packed_table(b: int, G: int, Hg: int, B: int, nc: int,
                      device) -> torch.Tensor:
    """An uninitialized (b, G, Hg, B, nc) uint8 tier table in the layout
    the paged Stage-I kernel reads: its storage is (b, G, B, nc, 8), the Hg
    query heads' weights of one (subspace, centroid) in the low bytes of
    one 8-byte word (Hg <= 8). The bytes past Hg are never written: a sum's
    carries run only towards higher bytes, so they never reach the Hg
    bytes the kernel reads."""
    if not 0 < Hg <= 8:
        raise ValueError(f"lane_packed_table: Hg={Hg} does not fit 8 lanes")
    return torch.empty((b, G, B, nc, 8), dtype=torch.uint8,
                       device=device).permute(0, 1, 4, 2, 3)[:, :, :Hg]


def _lane_packed(tables: torch.Tensor) -> bool:
    b, G, Hg, B, nc = tables.shape
    return (tables.dtype == torch.uint8
            and tables.stride() == (G * B * nc * 8, B * nc * 8, 1, nc * 8, 8)
            and tables.data_ptr() % 16 == 0)


def collision_scores_paged_kernel(pool_ids: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  tables: torch.Tensor, enc_end: torch.Tensor,
                                  sink_size: int, score_range: int):
    """Block-table-indirect Stage-I scores, masked to [sink, enc_end), and
    their histograms per segment.

    pool_ids (nb, G, bs, B) uint8, block_tables (b, nblk) int32 (< 0 =
    unallocated, clipped to block 0), tables (b, G, Hg, B, nc) tier
    weights (on the card uint8 in the ``lane_packed_table`` layout; any
    integer layout on the CPU), enc_end (b,) int32, ``score_range`` the
    largest score (< 256 on the card: its byte lanes hold sums up to 255)
    → (scores (b, G, Hg, nblk·bs) int32, seg_hist (b, G, Hg,
    ceil(n / SEG_LEN), score_range + 2) int32), the histograms per segment
    that ``bucket_topk`` takes. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if pool_ids.device.type == "cpu":
        return collision_paged_ref(pool_ids, block_tables, tables, enc_end,
                                   sink_size, score_range)
    K.check_cuda("collision_paged", pool_ids, block_tables, enc_end)
    if tables.device != pool_ids.device:
        raise ValueError(f"collision_paged: tables on {tables.device}")
    nb, G, bs, B = pool_ids.shape
    b, nblk = block_tables.shape
    Hg, nc = tables.shape[2], tables.shape[-1]
    if (pool_ids.dtype != torch.uint8 or block_tables.dtype != torch.int32
            or tables.dtype != torch.uint8 or enc_end.dtype != torch.int32):
        raise TypeError("collision_paged: expects uint8 ids and tables, "
                        "int32 block tables and enc_end")
    if not 0 <= score_range < 256:
        raise ValueError(f"collision_paged: needs 0 <= score_range < 256 on "
                         f"the card (byte lanes), got {score_range}")
    if (tables.shape != (b, G, Hg, B, nc) or B not in (8, 16) or nc > 256
            or nc % 16 or not 0 < Hg <= 8 or enc_end.shape != (b,)
            or pool_ids.data_ptr() % 16):
        raise ValueError(f"collision_paged: unsupported shapes "
                         f"{tuple(tables.shape)} for B={B}")
    if not _lane_packed(tables):
        raise ValueError("collision_paged: tables must lie in the byte-lane "
                         "layout of lane_packed_table")
    n = nblk * bs
    out = torch.empty((b, G, Hg, n), dtype=torch.int32,
                      device=pool_ids.device)
    hist = torch.empty((b, G, Hg, -(-n // SEG_LEN), score_range + 2),
                       dtype=torch.int32, device=pool_ids.device)
    K.launch("collision_paged", K.ptr(pool_ids), K.ptr(block_tables),
             K.ptr(tables), K.ptr(enc_end), K.ptr(out), K.ptr(hist), nb, G,
             Hg, bs, nblk, B, nc, int(sink_size), b, score_range + 2,
             SEG_LEN)
    LAUNCHES["collision_paged"] += 1
    return out, hist


def collision_scores_kernel(ids: torch.Tensor, tables: torch.Tensor,
                            enc_end: torch.Tensor, sink_size: int,
                            score_range: int):
    """Stage-I scores over a contiguous store, masked to [sink, enc_end),
    with their histograms per segment: the paged kernel over the store seen
    as a pool of one block per batch row (``row_tables``).

    ids (b, G, n, B) uint8 (the contiguous cache's meta_ids as it lies),
    tables (b, G, Hg, B, nc) as ``collision_scores_paged_kernel`` takes
    them, enc_end (b,) int32 → (scores (b, G, Hg, n) int32, seg_hist (b, G,
    Hg, ceil(n / SEG_LEN), score_range + 2) int32)."""
    return collision_scores_paged_kernel(
        ids, row_tables(ids.shape[0], ids.device), tables, enc_end,
        sink_size, score_range)


def count_cluster(keys: int) -> int:
    """Blocks in the cluster of one (b, g) row for ``keys`` sampled
    positions: a power of two giving each thread about two keys, at most
    ``COUNT_MAX_CLUSTER``."""
    cluster = 1
    while cluster < COUNT_MAX_CLUSTER and cluster * COUNT_THREADS * 2 < keys:
        cluster *= 2
    return cluster


def launch_count(ids: torch.Tensor, enc_end: torch.Tensor, sink_size: int,
                 num_buckets: int, stride: int, cluster: int,
                 threads: int) -> torch.Tensor:
    """One launch of the bucket histogram at a given grid (the wrapper's
    checks, no launch count: ``bucket_count`` counts)."""
    K.check_cuda("bucket_count", ids, enc_end)
    b, G, n, B = ids.shape
    if ids.dtype != torch.uint8 or enc_end.dtype != torch.int32:
        raise TypeError("bucket_count: expects uint8 ids and int32 enc_end")
    if (B not in (8, 16) or not 0 < num_buckets <= 256 or stride < 1
            or sink_size < 0 or enc_end.shape != (b,) or ids.data_ptr() % 16):
        raise ValueError(f"bucket_count: unsupported ids {tuple(ids.shape)}, "
                         f"{num_buckets} buckets, stride {stride}")
    out = torch.empty((b, G, B, num_buckets), dtype=torch.int32,
                      device=ids.device)
    K.launch("bucket_count", K.ptr(ids), K.ptr(enc_end), K.ptr(None),
             K.ptr(out), b, G, n, B, num_buckets, int(sink_size), int(stride),
             0, 0, 0, cluster, threads)
    return out


def bucket_count(ids: torch.Tensor, enc_end: torch.Tensor, sink_size: int,
                 num_buckets: int, stride: int = 1) -> torch.Tensor:
    """The bucket histogram of each row's retrieval region [sink, enc_end)
    of a contiguous metadata store, over every ``stride``-th position
    (p ≡ 0 mod stride) and scaled back by ``stride``.

    ids (b, G, n, B) uint8, enc_end (b,) int32 → (b, G, B, num_buckets)
    int32, exact (``bucket_count_ref``). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if ids.device.type == "cpu":
        return bucket_count_ref(ids, enc_end, sink_size, num_buckets, stride)
    keys = -(-ids.shape[-2] // stride)
    out = launch_count(ids, enc_end, sink_size, num_buckets, stride,
                       count_cluster(keys), COUNT_THREADS)
    LAUNCHES["bucket_count"] += 1
    return out


def bucket_count_span(pool_ids: torch.Tensor, block_tables: torch.Tensor,
                      lo: int, hi: int, num_buckets: int,
                      hist: torch.Tensor) -> torch.Tensor:
    """Add the bucket histogram of the logical positions [lo, hi) of each
    row of ``block_tables``, under allocated blocks only, to ``hist`` in
    place (the chunked fill's histogram update).

    pool_ids (nb, G, bs, B) uint8, block_tables (b, nblk) int32, hist (b,
    G, B, num_buckets) int32 → hist, exact (``bucket_count_span_ref``). An
    empty span launches nothing. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if hi <= lo:
        return hist
    if pool_ids.device.type == "cpu":
        hist += bucket_count_span_ref(pool_ids, block_tables, lo, hi,
                                      num_buckets)
        return hist
    K.check_cuda("bucket_count", pool_ids, block_tables, hist)
    nb, G, bs, B = pool_ids.shape
    b, nblk = block_tables.shape
    if (pool_ids.dtype != torch.uint8 or block_tables.dtype != torch.int32
            or hist.dtype != torch.int32):
        raise TypeError("bucket_count: expects uint8 ids, int32 tables and "
                        "histograms")
    if (B not in (8, 16) or not 0 < num_buckets <= 256 or lo < 0
            or hist.shape != (b, G, B, num_buckets)
            or pool_ids.data_ptr() % 16):
        raise ValueError(f"bucket_count: unsupported pool "
                         f"{tuple(pool_ids.shape)}, histograms "
                         f"{tuple(hist.shape)}")
    K.launch("bucket_count", K.ptr(pool_ids), K.ptr(None),
             K.ptr(block_tables), K.ptr(hist), b, G, int(hi), B, num_buckets,
             int(lo), 1, nblk, bs, 1, count_cluster(hi - lo), COUNT_THREADS)
    LAUNCHES["bucket_count"] += 1
    return hist
