"""Transformer building blocks (port of the serving parts of
``repro/models/layers.py``): global (ParisKV) layers, the sliding-window
local layers of gemma's local/global pattern, whose decode cache is a ring
buffer of the window size, whisper's bidirectional encoder attention, and
the cross attention of whisper's decoder and llama-3.2-vision's cross
layers, whose keys and values come from the media and stay static after
prefill.

Parameters are plain dicts of tensors with the JAX package's names and
layouts: matmul weights are stored (in_dim, out_dim) — wq/wk/wv/wo for
attention (bq/bk/bv with ``qkv_bias``), wi_gate/wi_up/wo_mlp for the MLP.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.core import attention as A
from repro_torch.core import cache as C
from repro_torch.core import encode as E
from repro_torch.core import retrieval as R
from repro_torch.core.config import ParisKVConfig
from repro_torch.kernels.gather_kv import gather_heads_tiered


def truncated_normal_(t: torch.Tensor,
                      generator: Optional[torch.Generator],
                      std: float = 0.02) -> torch.Tensor:
    """In place: std · N(0, 1) truncated to [-2, 2], the reference's
    ``truncated_normal`` (the values differ: torch draws its own bits). A
    meta tensor (shapes only, ``generator`` None) is returned as it is:
    nothing is drawn."""
    if t.is_meta:
        return t
    return torch.nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2 * std,
                                       b=2 * std, generator=generator)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMS norm in float32; ``plus_one`` scales by ``1 + scale`` (gemma's
    zero-initialized qk-norm)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    s = 1.0 + scale.float() if plus_one else scale.float()
    return (xf * torch.rsqrt(var + eps) * s).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding on half-split heads (NeoX style: the first and
    second halves of each head form the rotated pairs).
    x (..., seq, heads, hd); positions (..., seq)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs            # (..., seq, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    """(n, d) float32 sine / cosine position table, whisper's encoder
    positions (the reference's, computed in numpy)."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * dim / d))
    return np.concatenate([np.sin(ang), np.cos(ang)], -1).astype(np.float32)


def mlp_fwd(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo_mlp"]


def init_mlp(d_model: int, d_ff: int, dtype, device,
             gen: Optional[torch.Generator]) -> dict:
    def w(shape):
        return truncated_normal_(torch.empty(shape, device=device),
                                 gen).to(dtype)
    return {"wi_gate": w((d_model, d_ff)), "wi_up": w((d_model, d_ff)),
            "wo_mlp": w((d_ff, d_model))}


# ------------------------------------------------------------- attention ----
@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Static per-layer attention behaviour (the dense family's subset)."""
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    softcap: float = 0.0
    sliding_window: int = 0      # > 0: local layer (ring-buffer decode cache)
    qk_norm: bool = False
    sm_scale: float = 0.0        # 0 → 1/sqrt(head_dim)
    causal: bool = True          # False for encoder / cross attention

    def scale(self) -> float:
        return self.sm_scale or (1.0 / float(np.sqrt(self.head_dim)))


def init_attn(d_model: int, spec: AttnSpec, dtype, device,
              gen: Optional[torch.Generator]) -> dict:
    H, G, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim

    def w(shape):
        return truncated_normal_(torch.empty(shape, device=device),
                                 gen).to(dtype)
    p = {"wq": w((d_model, H * hd)), "wk": w((d_model, G * hd)),
         "wv": w((d_model, G * hd)), "wo": w((H * hd, d_model))}
    if spec.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", G * hd), ("bv", G * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=device)
    if spec.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p: dict, x: torch.Tensor, spec: AttnSpec,
                 positions: Optional[torch.Tensor]):
    """x (b, s, d) → q (b, s, H, hd), k/v (b, s, G, hd): qk-norm (scale
    1 + s) when the spec has it, then rope."""
    b, s, _ = x.shape
    H, G, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if spec.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, H, hd)
    k = k.reshape(b, s, G, hd)
    v = v.reshape(b, s, G, hd)
    if spec.qk_norm:
        q = rms_norm(q, p["q_norm"], plus_one=True)
        k = rms_norm(k, p["k_norm"], plus_one=True)
    if positions is not None:
        q = rope(q, positions, spec.rope_theta)
        k = rope(k, positions, spec.rope_theta)
    return q, k, v


def attn_prefill(p: dict, x: torch.Tensor, spec: AttnSpec,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal prefill attention (within the spec's sliding window on a
    local layer); also returns (k, v) for the cache. The output projection
    runs in float32, as the reference's float32 attention output promotes
    its product with ``wo``."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, spec, positions)
    out = A.blockwise_causal_attention(
        q, k, v, sm_scale=spec.scale(), softcap=spec.softcap,
        q_chunk=min(1024, s), kv_chunk=min(2048, s),
        sliding_window=spec.sliding_window)
    return out.reshape(b, s, -1) @ p["wo"].float(), k, v


def attn_train(p: dict, x: torch.Tensor, spec: AttnSpec,
               positions: torch.Tensor) -> torch.Tensor:
    """Causal training attention: ``attn_prefill``'s output (b, s, d)
    float32, without the cache's k/v."""
    return attn_prefill(p, x, spec, positions)[0]


def attn_encoder(p: dict, x: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """Bidirectional attention with no rope (whisper's encoder): x (b, s,
    d) → (b, s, d) float32. The caller hands float32 weights with a
    float32 x, as the reference's float32 frames promote every product."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, spec, None)
    out = A.full_attention(q, k, v, None, sm_scale=spec.scale())
    return out.reshape(b, s, -1) @ p["wo"].float()


def cross_kv(p: dict, kv_src: torch.Tensor, spec: AttnSpec
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The media's keys and values (b, t, G, hd) float32 from ``kv_src``
    (b, t, d): no bias, no rope, no norm. The media is float32 (the stub
    embeddings, or whisper's encoder output) and the reference's product
    with the config-dtype weights promotes to float32; torch refuses a
    mixed-dtype product, so the weights are cast up here. The cache
    stores the result in the config's dtype, as the reference's."""
    b, t, _ = kv_src.shape
    G, hd = spec.num_kv_heads, spec.head_dim
    src = kv_src.float()
    return ((src @ p["wk"].float()).reshape(b, t, G, hd),
            (src @ p["wv"].float()).reshape(b, t, G, hd))


def attn_cross(p: dict, x: torch.Tensor, kv_src: torch.Tensor,
               spec: AttnSpec, kv=None) -> torch.Tensor:
    """Cross attention of a prompt: queries from x (b, s, d), keys and
    values from ``kv_src`` (b, t, d) (``kv``: them from ``cross_kv``, when
    the caller has them already); every media token visible, qk-norm when
    the spec has it. → (b, s, d) float32 (whisper's decoder and
    llama-vision's cross layers)."""
    b, s, _ = x.shape
    H, hd = spec.num_heads, spec.head_dim
    q = (x @ p["wq"]).reshape(b, s, H, hd)
    k, v = cross_kv(p, kv_src, spec) if kv is None else kv
    if spec.qk_norm:
        q = rms_norm(q, p["q_norm"], plus_one=True)
        k = rms_norm(k, p["k_norm"], plus_one=True)
    out = A.full_attention(q, k, v, None, sm_scale=spec.scale())
    return out.reshape(b, s, -1) @ p["wo"].float()


def attn_cross_decode(p: dict, x_t: torch.Tensor,
                      media_kv: Tuple[torch.Tensor, torch.Tensor],
                      spec: AttnSpec) -> torch.Tensor:
    """Cross attention of a decode step: one query row per batch row (x_t
    (b, d)) over its slot's static media K/V (b, T, G, hd), free slots
    too, with no bias and no qk-norm, as the reference's decode → (b, d)
    float32."""
    b = x_t.shape[0]
    q = (x_t @ p["wq"]).reshape(b, spec.num_heads, spec.head_dim)
    out = A.cross_decode_attention(q, *media_kv, sm_scale=spec.scale())
    return out.reshape(b, -1) @ p["wo"].float()


def attn_fill_chunk(p: dict, x: torch.Tensor, spec: AttnSpec,
                    q_pos: torch.Tensor, k_pref: torch.Tensor,
                    v_pref: torch.Tensor, pref_pos: torch.Tensor,
                    new_pos: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer of one prefill chunk (a mixed prefill+decode step): qkv
    of x (b, P, d) at the chunk's true positions ``q_pos`` (b, P), then
    chunk-causal attention over the cached prefix (``k_pref``/``v_pref``
    at ``pref_pos``) and the chunk itself (``new_pos``, < 0 for the pad
    tail), within the spec's sliding window on a local layer. → (y (b, P,
    d) float32, k, v (b, P, G, hd)): the caller writes k/v (and on a
    global layer the ParisKV metadata) into the filling slot's cache."""
    return attn_fill_chunk_sharded(p, x, spec, q_pos, k_pref, v_pref,
                                   pref_pos, new_pos, None)


def attn_fill_chunk_sharded(p: dict, x: torch.Tensor, spec: AttnSpec,
                            q_pos: torch.Tensor, k_pref: torch.Tensor,
                            v_pref: torch.Tensor, pref_pos: torch.Tensor,
                            new_pos: torch.Tensor, dist
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """``attn_fill_chunk`` on the KV-head shard of ``dist``
    (``distributed.ShardDist``; None: every head): the prefix k/v are this
    rank's heads (read from its pool), the replicated chunk projection is
    sliced to them, chunk attention runs on them, and the output heads of
    every rank are gathered before the replicated output projection.
    → (y (b, P, d) float32, the local k, v (b, P, G_loc, hd))."""
    b, P, _ = x.shape
    q, k, v = _project_qkv(p, x, spec, q_pos)
    g0, g1 = _heads(dist, spec)
    Hg = spec.num_heads // spec.num_kv_heads
    q = q[:, :, g0 * Hg:g1 * Hg]
    k, v = k[:, :, g0:g1], v[:, :, g0:g1]
    out = A.chunk_fill_attention(q, k_pref, v_pref, pref_pos, k, v, q_pos,
                                 new_pos, sm_scale=spec.scale(),
                                 softcap=spec.softcap,
                                 sliding_window=spec.sliding_window)
    if dist is not None:
        out = dist.all_gather_heads(out, 2)
    return out.reshape(b, P, -1) @ p["wo"].float(), k, v


def _heads(dist, spec: AttnSpec) -> Tuple[int, int]:
    """[g0, g1): the KV heads a call computes (every head without
    ``dist``). Query head h = g·Hg + j, so its query heads are
    [g0·Hg, g1·Hg)."""
    if dist is None:
        return 0, spec.num_kv_heads
    return dist.head_range(spec.num_kv_heads)


def _decode_qkv(p: dict, x_t: torch.Tensor, spec: AttnSpec,
                pos: torch.Tensor):
    """x_t (b, d) one token per row → q (b, H, hd), k/v (b, G, hd), rope
    at the per-row position ``pos`` (b,)."""
    q, k, v = _project_qkv(p, x_t[:, None], spec, pos[:, None])
    return q[:, 0], k[:, 0], v[:, 0]


def attn_decode_dense(p: dict, x_t: torch.Tensor,
                      kv: Tuple[torch.Tensor, torch.Tensor],
                      pos: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """Dense decode over a contiguous cache (b, n, G, hd), appending the
    token at ``pos`` (b,) in place → y (b, d).

    A global layer (the full-attention baseline) appends at ``pos``
    (clamped as ``cache.append_kv``) and attends to positions ≤ pos. A
    local layer's cache is a ring buffer of n = min(window, n_max)
    slots: the token goes to slot pos % n, every slot is valid once
    pos ≥ n and slots ≤ pos before; stale slots of a previous tenant are
    masked by position, never read. A ring holds only the last n ≤ window
    positions, so no slot needs the window mask."""
    k_cache, v_cache = kv
    b, n = x_t.shape[0], k_cache.shape[1]
    q, k_t, v_t = _decode_qkv(p, x_t, spec, pos)
    if not spec.sliding_window:
        C.append_kv(k_cache, v_cache, k_t, v_t, pos)
    else:
        rows, slot = torch.arange(b, device=pos.device), (pos % n).long()
        k_cache[rows, slot] = k_t.to(k_cache.dtype)
        v_cache[rows, slot] = v_t.to(v_cache.dtype)
    attend = (A.ring_decode_attention if spec.sliding_window
              else A.dense_decode_attention)
    out = attend(q, k_cache, v_cache, pos, sm_scale=spec.scale(),
                 softcap=spec.softcap)
    return out.reshape(b, -1).to(x_t.dtype) @ p["wo"]


class ShardRetrieval(NamedTuple):
    """A sequence-sharded layer-step's retrieval on one rank: the merged
    winners every rank agrees on, this rank's local winners before the
    merge, and the query transform and region end they came from (an
    audit can rerun ``seq_local_retrieve`` on the shard from them: the
    metadata in [sink, enc_end) never changes afterwards)."""
    indices: torch.Tensor        # (b, G, Hg, k) int32 merged, global
    scores: torch.Tensor         # (b, G, Hg, k) float32 their estimates
    local_indices: torch.Tensor  # (b, G, Hg, k) int32 this rank's, global
    local_scores: torch.Tensor   # (b, G, Hg, k) float32
    qt: E.QueryTransform
    enc_end: torch.Tensor        # (b,) int32


def seq_local_retrieve(cache: C.LayerKVCache, qt: E.QueryTransform,
                       enc_end: torch.Tensor, pcfg: ParisKVConfig,
                       base: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sequence shard's retrieval: the shard holds the global
    positions [base, base + n_loc) of the store; Stage I, the top-C cut
    (C_loc = min(candidate_count(n_loc), n_loc), the reference's shard
    budget) and Stage II with its top-k over its own metadata, masked to
    the global region [sink, enc_end) (``retrieval.retrieve(base=)``).
    → (scores, global positions), (b, G, Hg, k) each."""
    n_loc = cache.k.shape[1]
    c_loc = min(pcfg.candidate_count(n_loc), n_loc)
    res = R.retrieve(cache.meta_ids, cache.meta_codes, cache.meta_w, qt,
                     enc_end, pcfg, c_loc, pcfg.top_k,
                     hist_sample=pcfg.hist_sample, base=base)
    return res.scores, res.indices + base


def merge_shard_winners(scores: torch.Tensor, indices: torch.Tensor,
                        top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top-k from every shard's local top-k, without
    collectives: scores/indices (S, b, G, Hg, k) in rank order, flattened
    shard-major as the reference's ``moveaxis(all_gather(...), 0, -2)``,
    then ``lax.top_k``'s order (descending, ties to the lower shard, then
    the lower local rank; ``retrieval.lax_top_k``). → (scores, global
    positions int32), (b, G, Hg, top_k) each."""
    lead = scores.shape[1:-1]
    flat_s = scores.movedim(0, -2).reshape(lead + (-1,))
    flat_i = indices.movedim(0, -2).reshape(lead + (-1,))
    top_s, at = R.lax_top_k(flat_s, top_k)
    return top_s, flat_i.gather(-1, at).to(torch.int32)


def distributed_retrieve_fetch(q_grp: torch.Tensor, cache: C.LayerKVCache,
                               regions: C.CacheRegions, pcfg: ParisKVConfig,
                               signs: torch.Tensor, dist
                               ) -> Tuple[ShardRetrieval, A.DecodeRows]:
    """Hierarchical (context-parallel) two-stage retrieval and row fetch
    over a sequence-sharded contiguous cache: this rank (``dist``, a
    ``distributed.SeqShardDist``) holds the global positions [base, base +
    n_loc) of ``cache``. It scores its own metadata and takes its local
    top-k (``seq_local_retrieve``); the shards' k·S winners are
    all-gathered — one ``all_gather_shards`` of scores, one of positions —
    and merged into the global top-k (``merge_shard_winners``); then the
    rank contributes the sink, window and winner rows it owns, zeros
    elsewhere, to one ``all_reduce_sum`` (``attention.
    seq_shard_decode_rows``). Every rank ends with the same winners and
    rows.

    q_grp (b, G, Hg, hd); regions with global positions → (the rank's
    ``ShardRetrieval``, the step's ``DecodeRows`` in float32)."""
    base = dist.shard_of(cache.k.shape[1])[0]
    qt = E.encode_query(q_grp, pcfg, signs)
    loc_s, loc_i = seq_local_retrieve(cache, qt, regions.enc_end, pcfg, base)
    top_s, top_idx = merge_shard_winners(dist.all_gather_shards(loc_s),
                                         dist.all_gather_shards(loc_i),
                                         pcfg.top_k)
    W = C.window_size(pcfg)
    ws = (regions.pos + 2 - W).clamp_min(0)
    rows = A.seq_shard_decode_rows(cache.k, cache.v, ws, top_idx,
                                   sink_size=pcfg.sink_size, window_size=W,
                                   dist=dist)
    return (ShardRetrieval(top_idx, top_s, loc_i.to(torch.int32), loc_s, qt,
                           regions.enc_end), rows)


def attn_decode_pariskv(p: dict, x_t: torch.Tensor, cache: C.LayerKVCache,
                        regions: C.CacheRegions, spec: AttnSpec,
                        pcfg: ParisKVConfig, signs: torch.Tensor,
                        num_candidates: int, dist=None):
    """ParisKV decode of one layer over the contiguous per-slot cache
    (paper Fig. 2 B.1→B.3): append the token in place, retrieve over the
    Retrieval region (Stage I with a per-query bucket histogram, top-C,
    Stage II), attend over Sink ∪ Top-k ∪ Local/Buffer. The caller
    promotes. → (y (b, d), the retrieval result).

    ``dist`` (a ``distributed.SeqShardDist``): the cache is this rank's
    sequence shard; the token lands where its position is owned, and the
    retrieval and rows come from ``distributed_retrieve_fetch`` (each
    shard's own candidate budget, so ``num_candidates`` is unused); the
    result is the rank's ``ShardRetrieval``."""
    b = x_t.shape[0]
    H, G, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    pos = regions.pos + 1
    q, k_t, v_t = _decode_qkv(p, x_t, spec, pos)
    W = C.window_size(pcfg)
    ws = (pos + 1 - W).clamp_min(0)
    q_grp = q.reshape(b, G, H // G, hd)
    rows = phys = None
    if dist is None:
        C.decode_append(cache, k_t, v_t, pos)
        qt = E.encode_query(q_grp, pcfg, signs)
        res = R.retrieve(cache.meta_ids, cache.meta_codes, cache.meta_w, qt,
                         regions.enc_end, pcfg, num_candidates, pcfg.top_k,
                         hist_sample=pcfg.hist_sample)
        phys = res.phys_rows
    else:
        C.decode_append(cache, k_t, v_t, pos,
                        shard=dist.shard_of(cache.k.shape[1]))
        res, rows = distributed_retrieve_fetch(q_grp, cache, regions, pcfg,
                                               signs, dist)
    out = A.sparse_decode_attention(
        q, cache.k, cache.v, res.indices, ws, pos, regions.enc_end, phys,
        sink_size=pcfg.sink_size, window_size=W, sm_scale=spec.scale(),
        softcap=spec.softcap, rows=rows)
    return out.reshape(b, -1).to(x_t.dtype) @ p["wo"], res


def attn_decode_pariskv_paged_sharded(p: dict, x_t: torch.Tensor,
                                      pool: C.PagedLayerKVCache,
                                      hist: Optional[torch.Tensor],
                                      block_tables: torch.Tensor,
                                      regions: C.CacheRegions,
                                      spec: AttnSpec, pcfg: ParisKVConfig,
                                      signs: torch.Tensor,
                                      num_candidates: int, dist,
                                      fused: bool = True, append_index=None
                                      ) -> Tuple[torch.Tensor,
                                                 R.PagedRetrievalResult]:
    """Paged ParisKV decode of one layer on the KV-head shard of ``dist``
    (``distributed.ShardDist``; None: one device, every head): the
    counterpart of the reference's ``attn_decode_pariskv_paged_fused``
    (``fused=True``, the default paged path), ``attn_decode_pariskv_paged``
    (``fused=False``, the meta-view fallback, token-identical) and
    ``attn_decode_pariskv_paged_sharded``.

    ``pool`` and ``hist`` hold this rank's heads; params, ``x_t``, block
    tables and regions are replicated. The replicated qkv projection is
    sliced to the rank's heads, whose token is appended through the block
    table (in place). Retrieval runs on those heads: fused (Stage I over
    the pool with tier weights from ``hist``, the top-C cut, Stage II with
    its top-k reading codes through the table), or with ``fused=False``
    over the materialized metadata view. Attention over sink ∪ winners ∪
    window follows. Every one of these ops is per head, and none rounds
    by the number of heads in the call (``core/centroids.py:
    centroid_scores``, ``core/attention.py:_dot``), so each rank computes
    exactly its heads' slice of the one-device result, on the card too;
    the output heads of all ranks are gathered in rank order before the
    replicated output projection. Every stage that was a Pallas kernel on the TPU is
    a Hopper kernel on a CUDA pool (Stage I, top-C, Stage II, the K/V
    gathers). ``append_index`` is the step's shared
    ``cache.paged_append_index``.
    → (y (b, d), this rank's retrieval result)."""
    b = x_t.shape[0]
    H, G, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    Hg = H // G
    g0, g1 = _heads(dist, spec)
    with trace.span("attn.qkv"):
        pos = regions.pos + 1
        q, k_t, v_t = _decode_qkv(p, x_t, spec, pos)
        q = q[:, g0 * Hg:g1 * Hg].contiguous()
    with trace.span("cache.append"):
        C.paged_decode_append(pool, block_tables, k_t[:, g0:g1],
                              v_t[:, g0:g1], pos, index=append_index)

    with trace.span("retrieve", C=num_candidates, k=pcfg.top_k):
        with trace.span("retrieve.encode_query"):
            qt = E.encode_query(q.reshape(b, g1 - g0, Hg, hd), pcfg, signs)
        if fused:
            res = R.retrieve_paged_fused(pool, block_tables, qt, hist,
                                         regions.enc_end, pcfg,
                                         num_candidates, pcfg.top_k)
        else:
            view = C.paged_meta_view(pool, block_tables)
            res = R.retrieve_paged(view, qt, regions.enc_end, pcfg,
                                   num_candidates, pcfg.top_k, block_tables,
                                   pool.k.shape[1],
                                   hist_sample=pcfg.hist_sample)
    W = C.window_size(pcfg)
    ws = (pos + 1 - W).clamp_min(0)
    out = A.sparse_decode_attention_paged(
        q, pool.k, pool.v, block_tables, res.indices, ws, pos,
        regions.enc_end, res.phys_rows, sink_size=pcfg.sink_size,
        window_size=W, sm_scale=spec.scale(), softcap=spec.softcap)
    with trace.span("attn.out"):
        if dist is not None:
            out = dist.all_gather_heads(out, 1)           # (b, H, hd)
        return out.reshape(b, -1).to(x_t.dtype) @ p["wo"], res


class SideStream(NamedTuple):
    """The CUDA stream of the overlapped winner gather and the two events
    that order it against the main stream (recorded anew at each layer,
    so none is created per step)."""
    stream: "torch.cuda.Stream"
    ready: "torch.cuda.Event"
    done: "torch.cuda.Event"

    @classmethod
    def create(cls, device) -> "SideStream":
        return cls(torch.cuda.Stream(device), torch.cuda.Event(),
                   torch.cuda.Event())


def attn_decode_pariskv_tiered(p: dict, x_t: torch.Tensor,
                               pool: C.PagedLayerKVCache, hist: torch.Tensor,
                               block_tables: torch.Tensor,
                               kv_tables: torch.Tensor,
                               dev_map: torch.Tensor, host_k: torch.Tensor,
                               host_v: torch.Tensor,
                               regions: C.CacheRegions, spec: AttnSpec,
                               pcfg: ParisKVConfig, signs: torch.Tensor,
                               num_candidates: int, fused: bool = True,
                               append_index=None, side=None, count=None,
                               fetch=None) -> Tuple[torch.Tensor,
                                          R.PagedRetrievalResult, dict]:
    """ParisKV decode of one layer over a **tiered** pool: metadata,
    Stage I/II and promotion as on the paged paths (host block tables;
    ``fused=False`` takes the meta view), K/V through the staging pool.

    The append and the sink/window gathers go through ``kv_tables``
    (``cache.tiered_kv_tables(block_tables, dev_map)``, composed once per
    chunk); the engine pins those blocks staged. Stage-II winners are
    resolved against ``dev_map`` inside one kernel launch
    (``gather_heads_tiered``): staged rows from the staging pool, missed
    rows from this layer's host rows ``host_k``/``host_v`` (nb·bs, G, hd),
    pinned on a card and read through unified virtual addressing. A
    winner's K/V is the same bytes on either tier, so residency moves
    bytes, never tokens.

    With a ``SideStream`` ``side`` the winner gather runs on its CUDA
    stream, after an event recorded once Stage II is done, while the main
    stream gathers the sink and window and scores them
    (``dense_segment_scores``); the main stream waits for the side
    stream's event before the joint softmax. With ``side`` None everything
    runs in order on one stream; the values are identical. ``count``, an
    int64 tensor, grows by the gather's distinct missed (row, kv head)
    pairs: the host rows it read.

    ``fetch``, when given, runs the step's host fetch under the fetch
    policy before the gather is launched (``HostKVPool.fetch_attempt``
    bound to this layer's entry and ``kind="heads"``) → (ok, retries,
    timeouts, stall seconds). When it gives up (``ok`` False) the step
    **degrades**: the same gather is launched with every missed winner
    at -1, so it reads no host row and writes zeros there, and those
    winners are masked out of the attention (``ret_keep = resident``): the
    step attends to sink, window and the staged winners.

    → (y (b, d), the retrieval result, fetch-stat increments
    {"touched": (num_blocks,) int32 winner references per host block (the
    prefetch predictor's signal), "rows": (b, 3) int32 [winner rows,
    staging hits, host fetches], "calls": tiered gathers issued (1),
    "retries"/"timeouts"/"stall": the fetch policy's host numbers,
    "degraded": None, or on a degraded step (b,) bool rows whose misses
    were dropped})."""
    b = x_t.shape[0]
    H, G, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    bs = pool.k.shape[1]
    pos = regions.pos + 1
    q, k_t, v_t = _decode_qkv(p, x_t, spec, pos)
    C.paged_decode_append(pool, kv_tables, k_t, v_t, pos, index=append_index)

    qt = E.encode_query(q.reshape(b, G, H // G, hd), pcfg, signs)
    if fused:
        res = R.retrieve_paged_fused(pool, block_tables, qt, hist,
                                     regions.enc_end, pcfg, num_candidates,
                                     pcfg.top_k)
    else:
        view = C.paged_meta_view(pool, block_tables)
        res = R.retrieve_paged(view, qt, regions.enc_end, pcfg,
                               num_candidates, pcfg.top_k, block_tables, bs,
                               hist_sample=pcfg.hist_sample)
    resident, _ = R.tiered_winner_rows(res.phys_rows, dev_map, bs)
    ret_valid = ((res.indices >= pcfg.sink_size)
                 & (res.indices < regions.enc_end[:, None, None, None]))
    ok, retries, timeouts, stall = ((True, 0, 0, 0.0) if fetch is None
                                    else fetch())
    # the reference's blend: staged rows whatever their validity, host
    # rows for valid misses (none on a degraded step), zeros for the rest
    rows = torch.where((ret_valid | resident) if ok else resident,
                       res.phys_rows, -1).to(torch.int32).contiguous()
    W = C.window_size(pcfg)
    ws = (pos + 1 - W).clamp_min(0)
    scores = {}
    if side is not None:
        main = torch.cuda.current_stream()
        side.ready.record(main)
        side.stream.wait_event(side.ready)
        with torch.cuda.stream(side.stream):
            k_ret, v_ret = gather_heads_tiered(pool.k, pool.v, host_k,
                                               host_v, dev_map, rows, count)
            side.done.record()
        rows.record_stream(side.stream)
        dense = A.paged_decode_rows(pool.k, pool.v, kv_tables, ws,
                                    sink_size=pcfg.sink_size, window_size=W)
        s_sink, s_loc = A.dense_segment_scores(
            q.reshape(b, G, H // G, hd).float(), dense.k_sink, dense.k_loc)
        scores = dict(s_sink=s_sink, s_loc=s_loc)
        main.wait_event(side.done)
        k_ret.record_stream(main)
        v_ret.record_stream(main)
    else:
        k_ret, v_ret = gather_heads_tiered(pool.k, pool.v, host_k, host_v,
                                           dev_map, rows, count)
        dense = A.paged_decode_rows(pool.k, pool.v, kv_tables, ws,
                                    sink_size=pcfg.sink_size, window_size=W)

    touched = torch.zeros((dev_map.shape[0],), dtype=torch.int32,
                          device=x_t.device)
    touched.index_add_(0, res.block_ids.flatten().long(),
                       ret_valid.flatten().to(torch.int32))
    stats = {"touched": touched, "calls": 1,
             "rows": torch.stack([ret_valid, ret_valid & resident,
                                  ret_valid & ~resident], -1).sum(
                                      (1, 2, 3), dtype=torch.int32),
             "retries": retries, "timeouts": timeouts, "stall": stall,
             "degraded": None if ok else (ret_valid & ~resident).flatten(
                 1).any(1)}
    out = A.sparse_decode_attention_paged(
        q, pool.k, pool.v, kv_tables, res.indices, ws, pos, regions.enc_end,
        sink_size=pcfg.sink_size, window_size=W, sm_scale=spec.scale(),
        softcap=spec.softcap, rows=dense._replace(k_ret=k_ret, v_ret=v_ret),
        ret_keep=None if ok else resident, **scores)
    return out.reshape(b, -1).to(x_t.dtype) @ p["wo"], res, stats
