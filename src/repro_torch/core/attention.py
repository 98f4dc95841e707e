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
``chunk_fill_attention`` is a prefill chunk's attention in a mixed
prefill+decode step: chunk-causal over the cached prefix and the chunk in
one joint softmax, masked by position (plain torch, as the reference's jnp).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import row_tables
from repro_torch.kernels.gather_kv import gather_decode_paged

NEG_INF = -1e30


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(x / cap)
    return x


def blockwise_causal_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, sm_scale: float,
                               softcap: float = 0.0, q_chunk: int = 1024,
                               kv_chunk: int = 2048) -> torch.Tensor:
    """Flash-style causal attention that never materializes the (S, S)
    score matrix: the working set is one (q_chunk, kv_chunk) tile per head.
    q: (b, S, H, hd), k/v: (b, S, G, hd) → (b, S, H, hd) float32.

    The reference scans every kv chunk for every q chunk; chunks that lie
    wholly after a q chunk are skipped here. That is exact, not an
    approximation: once a real chunk has set the running max, a fully
    masked chunk adds exp(-1e30 - m) = 0 to the sums and rescales by 1.

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
            kv_chunk=kv_chunk)
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
        for k0 in range(0, q0 + q_chunk, kv_chunk):    # causal: skip future
            k_blk = kf[:, k0:k0 + kv_chunk]
            v_blk = vf[:, k0:k0 + kv_chunk]
            kp = pos[k0:k0 + kv_chunk]
            s = torch.einsum("bqghd,bkgd->bgqhk", q_blk, k_blk) * sm_scale
            s = _softcap(s, softcap)
            causal = qp[:, None, None] >= kp[None, None, :]   # (qc, 1, kc)
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
                            v_cache: torch.Tensor, top_idx: torch.Tensor,
                            window_start: torch.Tensor, pos: torch.Tensor,
                            enc_end: torch.Tensor, phys_rows: torch.Tensor,
                            *, sink_size: int, window_size: int,
                            sm_scale: float,
                            softcap: float = 0.0) -> torch.Tensor:
    """Decode attention over a contiguous cache. q (b, H, hd); k/v_cache
    (b, n_max, G, hd); top_idx (b, G, Hg, k) retrieved positions;
    window_start / pos / enc_end (b,) int32; phys_rows (b, G, Hg, k)
    int32 the winners' rows i·n_max + position, as Stage II returns them
    (``RetrievalResult.phys_rows``) → (b, H, hd) float32.

    Sink, window and winner rows come through one gather launch over the
    cache seen as a pool of one block per batch row. As the reference's
    ``dynamic_slice``, the window's start clamps to n_max - W for the
    gather, while its masks keep the unclamped ``window_start``."""
    b, H, hd = q.shape
    n, G = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, G, H // G, hd).float()
    start = window_start.clamp(0, n - window_size).to(torch.int32)
    rows = paged_decode_rows(k_cache, v_cache, row_tables(b, q.device),
                             start, phys_rows, sink_size=sink_size,
                             window_size=window_size)
    return _segment_attention(
        qg, rows.k_sink, rows.v_sink, rows.k_ret, rows.v_ret, rows.k_loc,
        rows.v_loc, top_idx, window_start, pos, enc_end,
        sink_size=sink_size, window_size=window_size, sm_scale=sm_scale,
        softcap=softcap).reshape(b, H, hd)


def dense_segment_scores(qg: torch.Tensor, k_sink: torch.Tensor,
                         k_loc: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw (unmasked, unscaled) sink and window scores.
    qg (b, G, Hg, hd) float32 → (b, G, Hg, sink), (b, G, Hg, W)."""
    s_sink = torch.einsum("bghd,bsgd->bghs", qg, k_sink.float())
    s_loc = torch.einsum("bghd,bwgd->bghw", qg, k_loc.float())
    return s_sink, s_loc


def _segment_attention(qg: torch.Tensor, k_sink: torch.Tensor,
                       v_sink: torch.Tensor, k_ret: torch.Tensor,
                       v_ret: torch.Tensor, k_loc: torch.Tensor,
                       v_loc: torch.Tensor, top_idx: torch.Tensor,
                       window_start: torch.Tensor, pos: torch.Tensor,
                       enc_end: torch.Tensor, *, sink_size: int,
                       window_size: int, sm_scale: float,
                       softcap: float, s_sink: Optional[torch.Tensor] = None,
                       s_loc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Joint softmax over the three gathered segments (Eq. 2-3 core).

    qg (b, G, Hg, hd) float32; k/v_sink (b, sink, G, hd); k/v_ret
    (b, G, Hg, k, hd); k/v_loc (b, W, G, hd); top_idx (b, G, Hg, k)
    logical positions → (b, G, Hg, hd) float32. ``s_sink``/``s_loc`` are
    the raw sink and window scores when the caller computed them already
    (``dense_segment_scores``: the overlapped tiered schedule). Masked
    slots get exactly zero probability (pools hold zeros or real
    activations, never NaN)."""
    dev = qg.device
    s_ret = torch.einsum("bghd,bghkd->bghk", qg, k_ret.float())
    # only positions inside the retrieval region count: with an empty
    # region (early decode) Stage II returns arbitrary indices
    ret_valid = ((top_idx >= sink_size)
                 & (top_idx < enc_end[:, None, None, None]))
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
    out = torch.einsum("bghs,bsgd->bghd", p_sink, v_sink.float())
    out = out + torch.einsum("bghk,bghkd->bghd", p_ret, v_ret.float())
    out = out + torch.einsum("bghw,bwgd->bghd", p_loc, v_loc.float())
    return out


class DecodeRows(NamedTuple):
    """A decode step's gathered K/V rows over a paged pool: sink (b, sink,
    G, hd), window (b, W, G, hd) and winners (b, G, Hg, k, hd)."""
    k_sink: torch.Tensor
    v_sink: torch.Tensor
    k_loc: torch.Tensor
    v_loc: torch.Tensor
    k_ret: Optional[torch.Tensor]
    v_ret: Optional[torch.Tensor]


def paged_decode_rows(pool_k: torch.Tensor, pool_v: torch.Tensor,
                      block_tables: torch.Tensor, window_start: torch.Tensor,
                      phys_rows: Optional[torch.Tensor] = None, *,
                      sink_size: int, window_size: int) -> DecodeRows:
    """Every K/V row a paged decode step attends to, in one gather launch:
    each row's sink ([0, sink)) and window ([ws, ws + W)) through its block
    table, positions computed in the kernel from ``window_start`` (b,)
    int32, and the winners' head rows at ``phys_rows`` (b, G, Hg, k) int32
    flat physical rows (winners None without them: the tiered path reads
    its winners with its own kernel)."""
    k_dense, v_dense, k_ret, v_ret = gather_decode_paged(
        pool_k, pool_v, block_tables, window_start, sink_size, window_size,
        phys_rows)
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
                                  s_loc: Optional[torch.Tensor] = None
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
    changes the values."""
    b, H, hd = q.shape
    G = pool_k.shape[2]
    qg = q.reshape(b, G, H // G, hd).float()
    if rows is None:
        rows = paged_decode_rows(pool_k, pool_v, block_tables, window_start,
                                 phys_rows, sink_size=sink_size,
                                 window_size=window_size)
    return _segment_attention(
        qg, rows.k_sink, rows.v_sink, rows.k_ret, rows.v_ret, rows.k_loc,
        rows.v_loc, top_idx, window_start, pos, enc_end, sink_size=sink_size,
        window_size=window_size, sm_scale=sm_scale, softcap=softcap,
        s_sink=s_sink, s_loc=s_loc).reshape(b, H, hd)


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


def chunk_fill_attention(q: torch.Tensor, k_pref: torch.Tensor,
                         v_pref: torch.Tensor, pref_pos: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         q_pos: torch.Tensor, new_pos: torch.Tensor, *,
                         sm_scale: float, softcap: float = 0.0
                         ) -> torch.Tensor:
    """Prefill-chunk attention: the P prompt tokens of one filling slot
    attend to that slot's cached prefix plus the chunk under one joint
    softmax, in float32.

    q (b, P, H, hd); k_pref/v_pref (b, n, G, hd) the prefix as read from
    any layout, pref_pos (b, n) each prefix key's logical position (< 0
    invalid); k_new/v_new (b, P, G, hd) the chunk's keys and values;
    q_pos (b, P) the query positions, new_pos (b, P) the chunk keys'
    positions (< 0: the last chunk's pad tail) → (b, P, H, hd) float32.
    Key j is visible to query t iff 0 <= pos_j <= q_pos_t: the key set a
    solo prefill's causal attention sees. The scores are (b, G, Hg, P,
    n + P) float32, materialized."""
    b, P, H, hd = q.shape
    G = k_pref.shape[2]
    qg = q.reshape(b, P, G, H // G, hd).float()

    def seg(k, v, pos):
        s = torch.einsum("bpghd,bngd->bghpn", qg, k.float())
        ok = (pos[:, None, :] >= 0) & (pos[:, None, :] <= q_pos[:, :, None])
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
