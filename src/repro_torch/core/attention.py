"""Attention for prefill, decode and chunked fill (port of
``repro/core/attention.py``).

``blockwise_causal_attention`` is the prefill attention, a two-level
online softmax in plain torch ops (the JAX package leaves it to XLA).
``sparse_decode_attention`` (contiguous cache) and
``sparse_decode_attention_paged`` (block pool, also the staging pool of the
host-offloaded tier) are paper Eq. (2)-(3): one joint softmax over Sink ∪
Retrieved-top-k ∪ Local/Buffer window, three disjoint index ranges.
Sink, window and winner rows come through one gather launch
(``paged_decode_rows``); a contiguous cache is a pool of one block per
batch row (``kernels.row_tables``).
``dense_decode_attention`` is the full-attention baseline, written as the
reference writes it (float32 scores, a mask, a softmax).
``ring_decode_attention`` is a local (sliding-window) layer's decode over
its ring buffer, a dense softmax over at most ``window`` slots (jnp in the
reference, outside any Pallas kernel).
``chunk_fill_attention`` is a prefill chunk's attention in a mixed
prefill+decode step: chunk-causal over the cached prefix and the chunk in
one joint softmax, masked by position (plain torch, as the reference's jnp).
Prefill and chunk attention take a ``sliding_window``: keys more than
``window - 1`` positions before a query are masked.
``full_attention`` is the reference's dense oracle (float32, GQA, an
optional mask): whisper's bidirectional encoder and the cross attention of
a prefill over the media. ``cross_decode_attention`` is a decode step's
cross attention, one query row over a slot's static media K/V (jnp in the
reference, outside any Pallas kernel).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import row_tables
from repro_torch.kernels.gather_kv import (gather_decode_masked,
                                           gather_decode_paged)

NEG_INF = -1e30
_FULL_Q_CHUNK = 2048          # query rows per score tile of full_attention


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(x / cap)
    return x


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, *,
                   sm_scale: float) -> torch.Tensor:
    """Dense attention, the reference's oracle: q (b, S, H, hd), k/v (b, T,
    G, hd), ``mask`` broadcastable to (b, H, S, T) (True: visible) or None
    → (b, S, H, hd) float32. GQA: query head h reads kv head h // (H / G).
    Float32 scores, a mask and a softmax; the queries go ``_FULL_Q_CHUNK``
    rows at a time, which bounds the (b, H, rows, T) scores (a
    16,384-token prompt bucket over 1,600 media tokens would otherwise
    hold 3.4 GB) and does not change a row's softmax."""
    b, S, H, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    qg = q.reshape(b, S, G, H // G, hd).float()
    kf, vf = k.float(), v.float()
    if mask is not None:
        mask = torch.broadcast_to(mask, (b, H, S, T)).reshape(
            b, G, H // G, S, T)
    outs = []
    for s0 in range(0, S, _FULL_Q_CHUNK):
        rows = slice(s0, s0 + _FULL_Q_CHUNK)
        s = torch.einsum("bsgqd,btgd->bgqst", qg[:, rows], kf) * sm_scale
        if mask is not None:
            s = torch.where(mask[..., rows, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bgqst,btgd->bsgqd", p, vf))
    return torch.cat(outs, dim=1).reshape(b, S, H, hd)


def blockwise_causal_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, sm_scale: float,
                               softcap: float = 0.0, q_chunk: int = 1024,
                               kv_chunk: int = 2048,
                               sliding_window: int = 0) -> torch.Tensor:
    """Flash-style causal attention that never materializes the (S, S)
    score matrix: the working set is one (q_chunk, kv_chunk) tile per head.
    q: (b, S, H, hd), k/v: (b, S, G, hd) → (b, S, H, hd) float32. With
    ``sliding_window`` w > 0 query t sees keys t - w < p <= t.

    The reference scans every kv chunk for every q chunk; chunks that lie
    wholly after a q chunk, or wholly before its window, are skipped here.
    That is exact, not an approximation: once a real chunk has set the
    running max, a fully masked chunk adds exp(-1e30 - m) = 0 to the sums
    and rescales by 1; a fully masked chunk before the first real one
    leaves sums that the first real chunk rescales by exp(-1e30 - m) = 0.

    The reference requires S to be a multiple of both chunks. Here a
    ragged S is padded up to a multiple of both (the kv chunk rounded up
    to a multiple of the q chunk) and the pad rows dropped: pad keys lie
    after every real query, so causality masks them exactly."""
    b, S, H, hd = q.shape
    G = k.shape[2]
    Hg = H // G
    vd = v.shape[3]
    if S % q_chunk or S % kv_chunk:
        kv_chunk = -(-kv_chunk // q_chunk) * q_chunk     # a multiple of q's
        pad = (-S) % kv_chunk
        out = blockwise_causal_attention(
            *(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
              for t in (q, k, v)),
            sm_scale=sm_scale, softcap=softcap, q_chunk=q_chunk,
            kv_chunk=kv_chunk, sliding_window=sliding_window)
        return out[:, :S]
    qg = q.reshape(b, S, G, Hg, hd).float()
    kf, vf = k.float(), v.float()
    pos = torch.arange(S, device=q.device)
    outs = []
    for q0 in range(0, S, q_chunk):
        q_blk = qg[:, q0:q0 + q_chunk]                 # (b, qc, G, Hg, hd)
        qp = pos[q0:q0 + q_chunk]
        acc = torch.zeros((b, G, q_chunk, Hg, vd), device=q.device)
        m_run = torch.full((b, G, q_chunk, Hg), NEG_INF, device=q.device)
        l_run = torch.zeros((b, G, q_chunk, Hg), device=q.device)
        # causal: skip the future; windowed: skip what precedes the window
        # of the q chunk's first query
        k_first = (max(0, q0 - sliding_window + 1) // kv_chunk * kv_chunk
                   if sliding_window else 0)
        for k0 in range(k_first, q0 + q_chunk, kv_chunk):
            k_blk = kf[:, k0:k0 + kv_chunk]
            v_blk = vf[:, k0:k0 + kv_chunk]
            kp = pos[k0:k0 + kv_chunk]
            s = torch.einsum("bqghd,bkgd->bgqhk", q_blk, k_blk) * sm_scale
            s = _softcap(s, softcap)
            causal = qp[:, None, None] >= kp[None, None, :]   # (qc, 1, kc)
            if sliding_window:
                causal = causal & (qp[:, None, None] - kp[None, None, :]
                                   < sliding_window)
            s = torch.where(causal, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            scale = torch.exp(m_run - m_new)
            l_run = l_run * scale + p.sum(-1)
            acc = acc * scale[..., None] + torch.einsum(
                "bgqhk,bkgd->bgqhd", p, v_blk)
            m_run = m_new
        out = acc / l_run.clamp_min(1e-20)[..., None]
        outs.append(out.transpose(1, 2).reshape(b, q_chunk, H, vd))
    return torch.cat(outs, dim=1)


def sparse_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: Optional[torch.Tensor],
                            top_idx: torch.Tensor,
                            window_start: torch.Tensor, pos: torch.Tensor,
                            enc_end: torch.Tensor,
                            phys_rows: Optional[torch.Tensor], *,
                            sink_size: int, window_size: int,
                            sm_scale: float, softcap: float = 0.0,
                            rows: Optional["DecodeRows"] = None
                            ) -> torch.Tensor:
    """Decode attention over a contiguous cache. q (b, H, hd); k/v_cache
    (b, n_max, G, hd); top_idx (b, G, Hg, k) retrieved positions;
    window_start / pos / enc_end (b,) int32; phys_rows (b, G, Hg, k)
    int32 the winners' rows i·n_max + position, as Stage II returns them
    (``RetrievalResult.phys_rows``) → (b, H, hd) float32.

    Sink, window and winner rows come through one gather launch over the
    cache seen as a pool of one block per batch row. As the reference's
    ``dynamic_slice``, the window's start clamps to n_max - W for the
    gather, while its masks keep the unclamped ``window_start``.
    ``v_cache`` None: the keys are the values too (MLA's latent), and the
    gather reads them once. ``rows``: the rows gathered already (a
    sequence-sharded cache's, ``seq_shard_decode_rows``; the reference's
    pre-fetched ``k_ret``/``v_ret``), and the cache is not read."""
    b, H, hd = q.shape
    G = k_cache.shape[2]
    qg = q.reshape(b, G, H // G, hd).float()
    if rows is None:
        n = k_cache.shape[1]
        start = window_start.clamp(0, n - window_size).to(torch.int32)
        rows = paged_decode_rows(k_cache, v_cache, row_tables(b, q.device),
                                 start, phys_rows, sink_size=sink_size,
                                 window_size=window_size)
    return _segment_attention(
        qg, rows.k_sink, rows.v_sink, rows.k_ret, rows.v_ret, rows.k_loc,
        rows.v_loc, top_idx, window_start, pos, enc_end,
        sink_size=sink_size, window_size=window_size, sm_scale=sm_scale,
        softcap=softcap).reshape(b, H, hd)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis of ``a * b`` (broadcast): a decode step's
    contractions, written so that each head's result has the same bits
    whatever the number of heads in the call. A batched GEMM would not:
    cuBLAS picks its algorithm by the batch count, so a head-sharded rank
    (``ShardDist``), holding part of the heads, would round differently
    from one device."""
    return (a * b).sum(-1)


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(b, n, G, hd) rows → (b, G, 1, n, hd) float32, to broadcast against
    (b, G, Hg, ...) queries."""
    return x.float().permute(0, 2, 1, 3)[:, :, None]


def dense_segment_scores(qg: torch.Tensor, k_sink: torch.Tensor,
                         k_loc: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw (unmasked, unscaled) sink and window scores.
    qg (b, G, Hg, hd) float32 → (b, G, Hg, sink), (b, G, Hg, W)."""
    q = qg[..., None, :]
    return _dot(q, _heads_first(k_sink)), _dot(q, _heads_first(k_loc))


def _segment_attention(qg: torch.Tensor, k_sink: torch.Tensor,
                       v_sink: torch.Tensor, k_ret: torch.Tensor,
                       v_ret: torch.Tensor, k_loc: torch.Tensor,
                       v_loc: torch.Tensor, top_idx: torch.Tensor,
                       window_start: torch.Tensor, pos: torch.Tensor,
                       enc_end: torch.Tensor, *, sink_size: int,
                       window_size: int, sm_scale: float,
                       softcap: float, s_sink: Optional[torch.Tensor] = None,
                       s_loc: Optional[torch.Tensor] = None,
                       ret_keep: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Joint softmax over the three gathered segments (Eq. 2-3 core).

    qg (b, G, Hg, hd) float32; k/v_sink (b, sink, G, hd); k/v_ret
    (b, G, Hg, k, hd); k/v_loc (b, W, G, hd); top_idx (b, G, Hg, k)
    logical positions → (b, G, Hg, hd) float32. ``s_sink``/``s_loc`` are
    the raw sink and window scores when the caller computed them already
    (``dense_segment_scores``: the overlapped tiered schedule). Masked
    slots get exactly zero probability (pools hold zeros or real
    activations, never NaN). ``ret_keep`` (b, G, Hg, k) bool, optional:
    extra validity of the retrieved segment, the tiered degraded mode's
    mask (winners whose host fetch exhausted its retries drop out, so the
    step attends to sink, window and the staged winners); None changes
    nothing."""
    dev = qg.device
    s_ret = _dot(qg[..., None, :], k_ret.float())
    # only positions inside the retrieval region count: with an empty
    # region (early decode) Stage II returns arbitrary indices
    ret_valid = ((top_idx >= sink_size)
                 & (top_idx < enc_end[:, None, None, None]))
    if ret_keep is not None:
        ret_valid = ret_valid & ret_keep
    s_ret = torch.where(ret_valid, s_ret, NEG_INF)

    if s_sink is None:
        s_sink, s_loc = dense_segment_scores(qg, k_sink, k_loc)
    sink_valid = torch.arange(sink_size, device=dev)[None] <= pos[:, None]
    s_sink = torch.where(sink_valid[:, None, None, :], s_sink, NEG_INF)

    w_pos = window_start[:, None] + torch.arange(window_size, device=dev)
    loc_valid = ((w_pos >= enc_end[:, None]) & (w_pos >= sink_size)
                 & (w_pos <= pos[:, None]))
    s_loc = torch.where(loc_valid[:, None, None, :], s_loc, NEG_INF)

    scores = torch.cat([s_sink, s_ret, s_loc], dim=-1) * sm_scale
    p = torch.softmax(_softcap(scores, softcap), dim=-1)
    k_sz = top_idx.shape[-1]
    p_sink, p_ret, p_loc = torch.split(p, [sink_size, k_sz, window_size],
                                       dim=-1)
    out = _dot(p_sink[..., None, :], _heads_first(v_sink).transpose(-1, -2))
    out = out + _dot(p_ret[..., None, :], v_ret.float().transpose(-1, -2))
    out = out + _dot(p_loc[..., None, :],
                     _heads_first(v_loc).transpose(-1, -2))
    return out


class DecodeRows(NamedTuple):
    """A decode step's gathered K/V rows over a paged pool: sink (b, sink,
    G, hd), window (b, W, G, hd) and winners (b, G, Hg, k, hd); the V
    fields are the K tensors when the keys are the values."""
    k_sink: torch.Tensor
    v_sink: torch.Tensor
    k_loc: torch.Tensor
    v_loc: torch.Tensor
    k_ret: Optional[torch.Tensor]
    v_ret: Optional[torch.Tensor]


def paged_decode_rows(pool_k: torch.Tensor, pool_v: Optional[torch.Tensor],
                      block_tables: torch.Tensor, window_start: torch.Tensor,
                      phys_rows: Optional[torch.Tensor] = None, *,
                      sink_size: int, window_size: int) -> DecodeRows:
    """Every K/V row a paged decode step attends to, in one gather launch:
    each row's sink ([0, sink)) and window ([ws, ws + W)) through its block
    table, positions computed in the kernel from ``window_start`` (b,)
    int32, and the winners' head rows at ``phys_rows`` (b, G, Hg, k) int32
    flat physical rows (winners None without them: the tiered path reads
    its winners with its own kernel). ``pool_v`` None: K only, each row
    read once, and the V fields are the K rows (MLA's latent)."""
    k_dense, v_dense, k_ret, v_ret = gather_decode_paged(
        pool_k, pool_v, block_tables, window_start, sink_size, window_size,
        phys_rows)
    if pool_v is None:
        v_dense, v_ret = k_dense, k_ret
    return DecodeRows(k_dense[:, :sink_size], v_dense[:, :sink_size],
                      k_dense[:, sink_size:], v_dense[:, sink_size:], k_ret,
                      v_ret)


def seq_shard_decode_rows(k_cache: torch.Tensor, v_cache: torch.Tensor,
                          window_start: torch.Tensor, top_idx: torch.Tensor,
                          *, sink_size: int, window_size: int,
                          dist) -> DecodeRows:
    """Every K/V row a decode step attends to, from a sequence-sharded
    contiguous cache: this rank (``dist``, a ``distributed.SeqShardDist``)
    holds the global positions [base, base + n) of an n_max = n·shards
    cache (``SeqShardDist.shard_of``) in k/v_cache (b, n, G, hd). One
    rank-masked gather launch reads the sink rows, the window rows (its
    start clamped to n_max - W, as the reference's ``dynamic_slice`` over
    the whole cache) and the winners' head rows at the global positions
    ``top_idx`` (b, G, Hg, k) that the rank owns, zeros elsewhere; one
    ``all_reduce_sum`` of all of them in float32 gives every rank every
    row (x + 0 is exact, as the reference's ``psum``). → DecodeRows,
    float32."""
    b, n = k_cache.shape[:2]
    base, n_max = dist.shard_of(n)
    start = window_start.clamp(0, n_max - window_size).to(torch.int32)
    parts = gather_decode_masked(
        k_cache, v_cache, row_tables(b, k_cache.device), start, sink_size,
        window_size, top_idx.to(torch.int32).contiguous(), base, n)
    flat = torch.cat([t.float().reshape(-1) for t in parts])
    flat = dist.all_reduce_sum(flat)
    k_dense, v_dense, k_ret, v_ret = (
        t.view(p.shape) for t, p in zip(
            torch.split(flat, [p.numel() for p in parts]), parts))
    return DecodeRows(k_dense[:, :sink_size], v_dense[:, :sink_size],
                      k_dense[:, sink_size:], v_dense[:, sink_size:], k_ret,
                      v_ret)


def sparse_decode_attention_paged(q: torch.Tensor, pool_k: torch.Tensor,
                                  pool_v: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  top_idx: torch.Tensor,
                                  window_start: torch.Tensor,
                                  pos: torch.Tensor, enc_end: torch.Tensor,
                                  phys_rows: Optional[torch.Tensor] = None,
                                  *, sink_size: int, window_size: int,
                                  sm_scale: float, softcap: float = 0.0,
                                  rows: Optional[DecodeRows] = None,
                                  s_sink: Optional[torch.Tensor] = None,
                                  s_loc: Optional[torch.Tensor] = None,
                                  ret_keep: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Decode attention over the paged pool. q (b, H, hd); pool_k/v
    (num_blocks, block_size, G, hd); block_tables (b, nblk) int32;
    top_idx (b, G, Hg, k) logical positions; window_start / pos / enc_end
    (b,) int32; phys_rows (b, G, Hg, k) int32 Stage II's physical rows of
    the winners → (b, H, hd) float32.

    Sink, window and winner rows come through one gather launch
    (``paged_decode_rows``), unless they arrive as ``rows`` (with their raw
    sink and window scores ``s_sink``/``s_loc``: the tiered path gathers
    its winners with its own kernel, and its overlapped schedule scores
    the sink and window while that gather is in flight); placement never
    changes the values. ``ret_keep`` as in ``_segment_attention``."""
    b, H, hd = q.shape
    G = pool_k.shape[2]
    qg = q.reshape(b, G, H // G, hd).float()
    if rows is None:
        with trace.span("attn.rows"):
            rows = paged_decode_rows(pool_k, pool_v, block_tables,
                                     window_start, phys_rows,
                                     sink_size=sink_size,
                                     window_size=window_size)
    with trace.span("attn.segment"):
        return _segment_attention(
            qg, rows.k_sink, rows.v_sink, rows.k_ret, rows.v_ret, rows.k_loc,
            rows.v_loc, top_idx, window_start, pos, enc_end,
            sink_size=sink_size, window_size=window_size, sm_scale=sm_scale,
            softcap=softcap, s_sink=s_sink, s_loc=s_loc,
            ret_keep=ret_keep).reshape(b, H, hd)


def dense_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor, *,
                           sm_scale: float,
                           softcap: float = 0.0) -> torch.Tensor:
    """Full-cache decode attention (the full-attention baseline): q
    (b, H, hd), caches (b, n_max, G, hd); row i attends to positions
    ≤ pos[i] → (b, H, hd) float32. Float32 scores, a mask and a softmax,
    as the reference computes them."""
    b, H, hd = q.shape
    n, G = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, G, H // G, hd).float()
    s = torch.einsum("bghd,bngd->bghn", qg, k_cache.float()) * sm_scale
    s = _softcap(s, softcap)
    valid = torch.arange(n, device=q.device)[None] <= pos[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bghn,bngd->bghd", p, v_cache.float())
    return out.reshape(b, H, hd)


def ring_decode_attention(q: torch.Tensor, k_ring: torch.Tensor,
                          v_ring: torch.Tensor, pos: torch.Tensor, *,
                          sm_scale: float,
                          softcap: float = 0.0) -> torch.Tensor:
    """A local layer's decode attention over its ring buffer of n =
    min(window, n_max) slots, the token at ``pos`` (b,) already written
    at slot pos % n: every slot is valid once pos ≥ n, slots ≤ pos before
    → (b, H, hd) float32. q (b, H, hd), k/v_ring (b, n, G, hd).

    Float32 scores, a mask and a softmax, as the reference's ring branch;
    the contractions are products and sums (``_dot``), so each head's bits
    do not depend on the number of heads or rows in the call."""
    b, H, hd = q.shape
    n, G = k_ring.shape[1], k_ring.shape[2]
    qg = q.reshape(b, G, H // G, hd).float()
    s = _softcap(_dot(qg[..., None, :], _heads_first(k_ring)) * sm_scale,
                 softcap)                                # (b, G, Hg, n)
    valid = ((torch.arange(n, device=q.device)[None] <= pos[:, None])
             | (pos[:, None] >= n))
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = _dot(p[..., None, :], _heads_first(v_ring).transpose(-1, -2))
    return out.reshape(b, H, hd)


def cross_decode_attention(q: torch.Tensor, k_media: torch.Tensor,
                           v_media: torch.Tensor, *,
                           sm_scale: float) -> torch.Tensor:
    """A decode step's cross attention: one query row per batch row over
    its slot's static media K/V, every media token visible (no mask, no
    softcap, as the reference's decode) → (b, H, hd) float32. q (b, H,
    hd); k/v_media (b, T, G, hd). A free slot's zero media gives a
    uniform softmax over zeros: finite, and never emitted.

    Float32 scores and a softmax, the contractions written as products
    and sums (``_dot``), so each head's bits do not depend on the number
    of heads or rows in the call."""
    b, H, hd = q.shape
    G = k_media.shape[2]
    qg = q.reshape(b, G, H // G, hd).float()
    s = _dot(qg[..., None, :], _heads_first(k_media)) * sm_scale
    p = torch.softmax(s, dim=-1)                         # (b, G, Hg, T)
    out = _dot(p[..., None, :], _heads_first(v_media).transpose(-1, -2))
    return out.reshape(b, H, hd)


def chunk_fill_attention(q: torch.Tensor, k_pref: torch.Tensor,
                         v_pref: torch.Tensor, pref_pos: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         q_pos: torch.Tensor, new_pos: torch.Tensor, *,
                         sm_scale: float, softcap: float = 0.0,
                         sliding_window: int = 0) -> torch.Tensor:
    """Prefill-chunk attention: the P prompt tokens of one filling slot
    attend to that slot's cached prefix plus the chunk under one joint
    softmax, in float32.

    q (b, P, H, hd); k_pref/v_pref (b, n, G, hd) the prefix as read from
    any layout, pref_pos (b, n) each prefix key's logical position (< 0
    invalid); k_new/v_new (b, P, G, hd) the chunk's keys and values;
    q_pos (b, P) the query positions, new_pos (b, P) the chunk keys'
    positions (< 0: the last chunk's pad tail) → (b, P, H, hd) float32.
    Key j is visible to query t iff 0 <= pos_j <= q_pos_t (and q_pos_t -
    pos_j < ``sliding_window`` when given): the key set a solo prefill's
    causal attention sees. The scores are (b, G, Hg, P, n + P) float32,
    materialized."""
    b, P, H, hd = q.shape
    G = k_pref.shape[2]
    qg = q.reshape(b, P, G, H // G, hd).float()

    def seg(k, v, pos):
        s = torch.einsum("bpghd,bngd->bghpn", qg, k.float())
        ok = (pos[:, None, :] >= 0) & (pos[:, None, :] <= q_pos[:, :, None])
        if sliding_window:
            ok = ok & (q_pos[:, :, None] - pos[:, None, :] < sliding_window)
        return torch.where(ok[:, None, None], s, NEG_INF), v.float()

    s_pref, vp = seg(k_pref, v_pref, pref_pos)
    s_self, vs = seg(k_new, v_new, new_pos)
    scores = _softcap(torch.cat([s_pref, s_self], dim=-1) * sm_scale,
                      softcap)
    p = torch.softmax(scores, dim=-1)
    p_pref, p_self = p.split([k_pref.shape[1], P], dim=-1)
    out = torch.einsum("bghpn,bngd->bpghd", p_pref, vp)
    out = out + torch.einsum("bghpt,btgd->bpghd", p_self, vs)
    return out.reshape(b, P, H, hd)
