"""Transformer building blocks for the dense family (port of the main-path
and chunked-fill parts of ``repro/models/layers.py``).

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

from repro_torch.core import attention as A
from repro_torch.core import cache as C
from repro_torch.core import encode as E
from repro_torch.core import retrieval as R
from repro_torch.core.config import ParisKVConfig
from repro_torch.kernels.gather_kv import gather_heads_tiered


def truncated_normal_(t: torch.Tensor, generator: torch.Generator,
                      std: float = 0.02) -> torch.Tensor:
    """In place: std · N(0, 1) truncated to [-2, 2], the reference's
    ``truncated_normal`` (the values differ: torch draws its own bits)."""
    return torch.nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2 * std,
                                       b=2 * std, generator=generator)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


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


def mlp_fwd(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo_mlp"]


def init_mlp(d_model: int, d_ff: int, dtype, device,
             gen: torch.Generator) -> dict:
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
    sm_scale: float = 0.0        # 0 → 1/sqrt(head_dim)

    def scale(self) -> float:
        return self.sm_scale or (1.0 / float(np.sqrt(self.head_dim)))


def init_attn(d_model: int, spec: AttnSpec, dtype, device,
              gen: torch.Generator) -> dict:
    H, G, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim

    def w(shape):
        return truncated_normal_(torch.empty(shape, device=device),
                                 gen).to(dtype)
    p = {"wq": w((d_model, H * hd)), "wk": w((d_model, G * hd)),
         "wv": w((d_model, G * hd)), "wo": w((H * hd, d_model))}
    if spec.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", G * hd), ("bv", G * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=device)
    return p


def _project_qkv(p: dict, x: torch.Tensor, spec: AttnSpec,
                 positions: Optional[torch.Tensor]):
    """x (b, s, d) → q (b, s, H, hd), k/v (b, s, G, hd), rope applied."""
    b, s, _ = x.shape
    H, G, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if spec.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, H, hd)
    k = k.reshape(b, s, G, hd)
    v = v.reshape(b, s, G, hd)
    if positions is not None:
        q = rope(q, positions, spec.rope_theta)
        k = rope(k, positions, spec.rope_theta)
    return q, k, v


def attn_prefill(p: dict, x: torch.Tensor, spec: AttnSpec,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal prefill attention; also returns (k, v) for the cache. The
    output projection runs in float32, as the reference's float32
    attention output promotes its product with ``wo``."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, spec, positions)
    out = A.blockwise_causal_attention(
        q, k, v, sm_scale=spec.scale(), softcap=spec.softcap,
        q_chunk=min(1024, s), kv_chunk=min(2048, s))
    return out.reshape(b, s, -1) @ p["wo"].float(), k, v


def attn_fill_chunk(p: dict, x: torch.Tensor, spec: AttnSpec,
                    q_pos: torch.Tensor, k_pref: torch.Tensor,
                    v_pref: torch.Tensor, pref_pos: torch.Tensor,
                    new_pos: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer of one prefill chunk (a mixed prefill+decode step): qkv
    of x (b, P, d) at the chunk's true positions ``q_pos`` (b, P), then
    chunk-causal attention over the cached prefix (``k_pref``/``v_pref``
    at ``pref_pos``) and the chunk itself (``new_pos``, < 0 for the pad
    tail). → (y (b, P, d) float32, k, v (b, P, G, hd)): the caller writes
    k/v and the ParisKV metadata into the filling slot's cache."""
    b, P, _ = x.shape
    q, k, v = _project_qkv(p, x, spec, q_pos)
    out = A.chunk_fill_attention(q, k_pref, v_pref, pref_pos, k, v, q_pos,
                                 new_pos, sm_scale=spec.scale(),
                                 softcap=spec.softcap)
    return out.reshape(b, P, -1) @ p["wo"].float(), k, v


def _decode_qkv(p: dict, x_t: torch.Tensor, spec: AttnSpec,
                pos: torch.Tensor):
    """x_t (b, d) one token per row → q (b, H, hd), k/v (b, G, hd), rope
    at the per-row position ``pos`` (b,)."""
    q, k, v = _project_qkv(p, x_t[:, None], spec, pos[:, None])
    return q[:, 0], k[:, 0], v[:, 0]


def attn_decode_dense(p: dict, x_t: torch.Tensor,
                      kv: Tuple[torch.Tensor, torch.Tensor],
                      pos: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """Full-attention decode over a contiguous cache (the baseline; global
    layers only, the reference's ring-buffer branch serves sliding layers,
    which qwen2 has none of). Appends the token at ``pos`` (b,) in place
    (clamped as ``cache.append_kv``) → y (b, d)."""
    k_cache, v_cache = kv
    b = x_t.shape[0]
    q, k_t, v_t = _decode_qkv(p, x_t, spec, pos)
    C.append_kv(k_cache, v_cache, k_t, v_t, pos)
    out = A.dense_decode_attention(q, k_cache, v_cache, pos,
                                   sm_scale=spec.scale(), softcap=spec.softcap)
    return out.reshape(b, -1).to(x_t.dtype) @ p["wo"]


def attn_decode_pariskv(p: dict, x_t: torch.Tensor, cache: C.LayerKVCache,
                        regions: C.CacheRegions, spec: AttnSpec,
                        pcfg: ParisKVConfig, signs: torch.Tensor,
                        num_candidates: int
                        ) -> Tuple[torch.Tensor, R.RetrievalResult]:
    """ParisKV decode of one layer over the contiguous per-slot cache
    (paper Fig. 2 B.1→B.3): append the token in place, retrieve over the
    Retrieval region (Stage I with a per-query bucket histogram, top-C,
    Stage II), attend over Sink ∪ Top-k ∪ Local/Buffer. The caller
    promotes. → (y (b, d), the retrieval result)."""
    b = x_t.shape[0]
    H, G, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    pos = regions.pos + 1
    q, k_t, v_t = _decode_qkv(p, x_t, spec, pos)
    C.decode_append(cache, k_t, v_t, pos)

    qt = E.encode_query(q.reshape(b, G, H // G, hd), pcfg, signs)
    res = R.retrieve(cache.meta_ids, cache.meta_codes, cache.meta_w, qt,
                     regions.enc_end, pcfg, num_candidates, pcfg.top_k,
                     hist_sample=pcfg.hist_sample)
    W = C.window_size(pcfg)
    ws = (pos + 1 - W).clamp_min(0)
    out = A.sparse_decode_attention(
        q, cache.k, cache.v, res.indices, ws, pos, regions.enc_end,
        res.phys_rows, sink_size=pcfg.sink_size, window_size=W,
        sm_scale=spec.scale(), softcap=spec.softcap)
    return out.reshape(b, -1).to(x_t.dtype) @ p["wo"], res


def attn_decode_pariskv_paged(p: dict, x_t: torch.Tensor,
                              pool: C.PagedLayerKVCache,
                              block_tables: torch.Tensor,
                              regions: C.CacheRegions, spec: AttnSpec,
                              pcfg: ParisKVConfig, signs: torch.Tensor,
                              num_candidates: int, append_index=None
                              ) -> Tuple[torch.Tensor,
                                         R.PagedRetrievalResult]:
    """The meta-view fallback (``PagedServingEngine(fused=False)``): the
    same math as ``attn_decode_pariskv`` over the block pool. The token is
    appended through the block table, retrieval runs over the materialized
    logical metadata view (Stage I over the view, a per-query histogram),
    the winners come back block-relative, and the three attention segments
    are gathered from the pool. Token-identical to the fused path."""
    b = x_t.shape[0]
    H, G, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    pos = regions.pos + 1
    q, k_t, v_t = _decode_qkv(p, x_t, spec, pos)
    C.paged_decode_append(pool, block_tables, k_t, v_t, pos,
                          index=append_index)

    qt = E.encode_query(q.reshape(b, G, H // G, hd), pcfg, signs)
    view = C.paged_meta_view(pool, block_tables)
    res = R.retrieve_paged(view, qt, regions.enc_end, pcfg, num_candidates,
                           pcfg.top_k, block_tables, pool.k.shape[1],
                           hist_sample=pcfg.hist_sample)
    W = C.window_size(pcfg)
    ws = (pos + 1 - W).clamp_min(0)
    out = A.sparse_decode_attention_paged(
        q, pool.k, pool.v, block_tables, res.indices, ws, pos,
        regions.enc_end, res.phys_rows, sink_size=pcfg.sink_size,
        window_size=W, sm_scale=spec.scale(), softcap=spec.softcap)
    return out.reshape(b, -1).to(x_t.dtype) @ p["wo"], res


def attn_decode_pariskv_paged_fused(p: dict, x_t: torch.Tensor,
                                    pool: C.PagedLayerKVCache,
                                    hist: torch.Tensor,
                                    block_tables: torch.Tensor,
                                    regions: C.CacheRegions, spec: AttnSpec,
                                    pcfg: ParisKVConfig, signs: torch.Tensor,
                                    num_candidates: int, append_index=None
                                    ) -> Tuple[torch.Tensor,
                                               R.PagedRetrievalResult]:
    """Fused paged ParisKV decode of one layer (the default paged path).

    Appends the token through the block table (in place), scores the
    pool's centroid ids against tier weights from the incremental bucket
    histogram ``hist`` (b, G, B, 2^m) — read only here; promotion updates
    it — reranks the top-C candidates from their codes read by physical
    row, and attends over sink ∪ winners ∪ window. Every stage that was a
    Pallas kernel on the TPU is a Hopper kernel on a CUDA pool (Stage I,
    top-C, Stage II, the K/V gathers). ``append_index`` is the step's
    shared ``cache.paged_append_index``.
    → (y (b, d), the retrieval result)."""
    b = x_t.shape[0]
    H, G, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    pos = regions.pos + 1
    q, k_t, v_t = _decode_qkv(p, x_t, spec, pos)
    C.paged_decode_append(pool, block_tables, k_t, v_t, pos,
                          index=append_index)

    qt = E.encode_query(q.reshape(b, G, H // G, hd), pcfg, signs)
    res = R.retrieve_paged_fused(pool, block_tables, qt, hist,
                                 regions.enc_end, pcfg, num_candidates,
                                 pcfg.top_k)
    W = C.window_size(pcfg)
    ws = (pos + 1 - W).clamp_min(0)
    out = A.sparse_decode_attention_paged(
        q, pool.k, pool.v, block_tables, res.indices, ws, pos,
        regions.enc_end, res.phys_rows, sink_size=pcfg.sink_size,
        window_size=W, sm_scale=spec.scale(), softcap=spec.softcap)
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
                               append_index=None, side=None, count=None
                               ) -> Tuple[torch.Tensor,
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

    → (y (b, d), the retrieval result, fetch-stat increments
    {"touched": (num_blocks,) int32 winner references per host block (the
    prefetch predictor's signal), "rows": (b, 3) int32 [winner rows,
    staging hits, host fetches], "calls": tiered gathers issued (1)})."""
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
    # the reference's blend: staged rows whatever their validity, host
    # rows for valid misses, zeros for invalid misses
    rows = torch.where(ret_valid | resident, res.phys_rows,
                       -1).to(torch.int32).contiguous()
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
                                      (1, 2, 3), dtype=torch.int32)}
    out = A.sparse_decode_attention_paged(
        q, pool.k, pool.v, kv_tables, res.indices, ws, pos, regions.enc_end,
        sink_size=pcfg.sink_size, window_size=W, sm_scale=spec.scale(),
        softcap=spec.softcap, rows=dense._replace(k_ret=k_ret, v_ret=v_ret),
        **scores)
    return out.reshape(b, -1).to(x_t.dtype) @ p["wo"], res, stats
