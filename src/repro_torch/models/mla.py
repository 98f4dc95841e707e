"""Multi-head latent attention (DeepSeek-V2), with ParisKV in the latent
space (port of the serving part of ``repro/models/mla.py``).

Prefill uses the *decompressed* form (``mla_train``: per-head K/V from the
latent, then causal attention). Decode uses the *absorbed* form: the cache
holds only the normalized latent ``c_kv`` (r) and the shared rope key
``k_r`` (dr) per token, and the scores are

    s(i) = (q_nope W_UK) · c_kv[i] + q_rope · k_r[i],

so ParisKV indexes the one (r + dr)-wide latent [c_kv; k_r] (576 wide on
deepseek-v2-lite: B = 128 subspaces after the SRHT's padding to 1024) for
every query head: G = 1 kv "head", Hg = num_heads queries. The latent is
both key and value of the attention, so the decode gather reads it once
(``core/attention.py:sparse_decode_attention`` with no V store), and the
attended latent is decompressed through ``w_uv``.

Retrieval is the contiguous route of ``core/retrieval.py:retrieve`` over
the latent's (b, 1, n, B) metadata: ``bucket_count``, Stage I over one
block per batch row, the top-C cut, Stage II with its top-k, on the card
each a hand-written kernel (the wide modes at B = 128, Hg = 16).

The reference's casts are kept: the query is absorbed in float32, the
attention runs on the absorbed query cast to the latent's dtype, and the
softmax scale is 1 / sqrt(dn + dr). Caches update in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import attention as A
from repro_torch.core import cache as CC
from repro_torch.core import encode as E
from repro_torch.core import retrieval as R
from repro_torch.core.config import ModelConfig, ParisKVConfig
from repro_torch.kernels import row_tables
from repro_torch.kernels.gather_kv import gather_rows_paged
from repro_torch.models.layers import rms_norm, rope, truncated_normal_


def init_mla(cfg: ModelConfig, dtype, device,
             gen: Optional[torch.Generator]) -> dict:
    """The query projection ``wq`` (d, H·(dn + dr)) (v2-lite has no
    q-lora), the down-projection to the latent and the shared rope key
    ``w_dkv`` (d, r + dr), the latent's norm ``kv_norm`` (r,), the
    up-projections ``w_uk`` (r, H·dn) and ``w_uv`` (r, H·dv), and ``wo``
    (H·dv, d), in the reference's names and layouts."""
    d, H = cfg.d_model, cfg.num_heads
    r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    dn, dv = cfg.head_dim, cfg.v_head_dim

    def w(shape):
        return truncated_normal_(torch.empty(shape, device=device),
                                 gen).to(dtype)
    return {"wq": w((d, H * (dn + dr))), "w_dkv": w((d, r + dr)),
            "kv_norm": torch.ones((r,), dtype=dtype, device=device),
            "w_uk": w((r, H * dn)), "w_uv": w((r, H * dv)),
            "wo": w((H * dv, d))}


def _split_q(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (b, s, d) → (q_nope (b, s, H, dn), q_rope (b, s, H, dr))."""
    b, s, _ = x.shape
    H, dn, dr = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim
    q = (x @ p["wq"]).reshape(b, s, H, dn + dr)
    return q[..., :dn], q[..., dn:]


def _latent_kv(p: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor):
    """x (b, s, d) → (c_kv (b, s, r) normalized, k_rope (b, s, dr)
    rope'd), both in x's dtype."""
    r = cfg.kv_lora_rank
    ckv = x @ p["w_dkv"]
    c = rms_norm(ckv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_r = rope(ckv[..., r:][..., None, :], positions, cfg.rope_theta)
    return c, k_r[..., 0, :]


def _sm_scale(cfg: ModelConfig) -> float:
    return 1.0 / float(np.sqrt(cfg.head_dim + cfg.rope_head_dim))


def mla_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor) -> torch.Tensor:
    """Decompressed causal attention (prefill): x (b, s, d) → (b, s, d)
    float32 (the float32 attention output's product with ``wo``, as the
    reference's promotes)."""
    b, s, _ = x.shape
    H, dn, dr, dv = (cfg.num_heads, cfg.head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    q_n, q_r = _split_q(p, x, cfg)
    q_r = rope(q_r, positions, cfg.rope_theta)
    c, k_r = _latent_kv(p, x, cfg, positions)
    k_n = (c @ p["w_uk"]).reshape(b, s, H, dn)
    v = (c @ p["w_uv"]).reshape(b, s, H, dv)
    q = torch.cat([q_n, q_r], -1)
    k = torch.cat([k_n, k_r[:, :, None].expand(b, s, H, dr)], -1)
    out = A.blockwise_causal_attention(
        q, k, v, sm_scale=_sm_scale(cfg), q_chunk=min(1024, s),
        kv_chunk=min(2048, s))
    return out.reshape(b, s, H * dv) @ p["wo"].float()


# ------------------------------------------------------------- decode -------
class MLACache(NamedTuple):
    """The latent store and its ParisKV metadata over [c_kv; k_rope], one
    kv "head" (G = 1)."""
    latent: torch.Tensor      # (b, n_max, r + dr) in the config's dtype
    meta_ids: torch.Tensor    # (b, 1, n_max, B) uint8
    meta_codes: torch.Tensor  # (b, 1, n_max, B) int32
    meta_w: torch.Tensor      # (b, 1, n_max, B) float32


def init_mla_cache(batch: int, n_max: int, cfg: ModelConfig, dtype,
                   device) -> MLACache:
    r = cfg.retrieval_dim()
    B = cfg.pariskv.num_subspaces(r)
    meta = (batch, 1, n_max, B)
    return MLACache(
        latent=torch.zeros((batch, n_max, r), dtype=dtype, device=device),
        meta_ids=torch.zeros(meta, dtype=torch.uint8, device=device),
        meta_codes=torch.zeros(meta, dtype=torch.int32, device=device),
        meta_w=torch.zeros(meta, dtype=torch.float32, device=device))


def _lat4(cache: MLACache) -> torch.Tensor:
    """The latent as a (b, n_max, 1, r + dr) store: K (and V) of one kv
    head, the layout the gathers and attention take."""
    return cache.latent[:, :, None]


def mla_prefill_cache(p: dict, x: torch.Tensor, cache: MLACache,
                      cfg: ModelConfig, positions: torch.Tensor,
                      signs: torch.Tensor) -> MLACache:
    """Write the prompt's latent (b, S, r + dr) at positions [0, S) and
    encode metadata for every position, in place. As in the reference no
    prompt lengths are taken: a padded row's pads are encoded too, and
    decode masks them by position."""
    c, k_r = _latent_kv(p, x, cfg, positions)
    lat = torch.cat([c, k_r], -1)
    S = lat.shape[1]
    cache.latent[:, :S] = lat.to(cache.latent.dtype)
    meta = E.encode_keys(lat[:, None], cfg.pariskv, signs)   # (b, 1, S, B)
    for dst, new in zip(cache[1:], meta):
        dst[:, :, :S] = new
    return cache


def mla_promote_rows(cache: MLACache, starts: torch.Tensor,
                     mask: torch.Tensor, pcfg: ParisKVConfig,
                     signs: torch.Tensor) -> MLACache:
    """Per-row promotion, in place: row ``i`` with ``mask[i]`` gets
    metadata for latent rows [starts[i], starts[i] + update_interval);
    every row's block is encoded (one batched computation) and unmasked
    rows keep their old metadata; each start clamps to [0, n - interval].
    The block comes through the K-only gather over the latent's
    one-block-per-row table."""
    U = pcfg.update_interval
    b, n = cache.latent.shape[:2]
    st = starts.to(torch.int32).clamp(0, n - U)
    lidx = (st[:, None] + torch.arange(U, dtype=torch.int32,
                                       device=st.device)).contiguous()
    blk = gather_rows_paged(_lat4(cache), None,
                            row_tables(b, cache.latent.device), lidx)
    meta = E.encode_keys(blk.transpose(1, 2), pcfg, signs)   # (b, 1, U, B)
    rows, at = torch.arange(b, device=st.device)[:, None], lidx.long()
    keep = mask[:, None, None, None]
    for dst, new in zip(cache[1:], meta):
        old = dst[rows, :, at]                                # (b, U, 1, B)
        dst[rows, :, at] = torch.where(keep, new.transpose(1, 2), old)
    return cache


def mla_decode(p: dict, x_t: torch.Tensor, cache: MLACache,
               regions: CC.CacheRegions, cfg: ModelConfig,
               signs: torch.Tensor, num_candidates: int,
               use_pariskv: bool = True
               ) -> Tuple[torch.Tensor, Optional[R.RetrievalResult]]:
    """Absorbed-form decode of one step with latent-space retrieval: x_t
    (b, d) the normed input, ``regions`` per row (b,) → (y (b, d) in x_t's
    dtype, the retrieval result, None with ``use_pariskv=False``, the
    dense attention over every position <= pos). The step's latent is
    written at pos + 1 (clamped to the store), in place; the caller
    promotes."""
    b = x_t.shape[0]
    H, dn, dr, dv = (cfg.num_heads, cfg.head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    r = cfg.kv_lora_rank
    pcfg = cfg.pariskv
    pos = regions.pos + 1

    q = (x_t @ p["wq"]).reshape(b, H, dn + dr)
    q_n, q_r = q[..., :dn], q[..., dn:]
    pos_arr = pos[:, None]
    q_r = rope(q_r[:, None], pos_arr, cfg.rope_theta)[:, 0]
    c, k_r = _latent_kv(p, x_t[:, None], cfg, pos_arr)
    lat_t = torch.cat([c, k_r], -1)[:, 0]                     # (b, r + dr)
    n_max = cache.latent.shape[1]
    rows = torch.arange(b, device=x_t.device)
    cache.latent[rows, pos.long().clamp(0, n_max - 1)] = lat_t.to(
        cache.latent.dtype)

    # absorb W_UK into the query: q_eff = q_nope · W_UK(head)^T ∈ R^r
    w_uk = p["w_uk"].reshape(r, H, dn)
    q_eff = torch.einsum("bhd,rhd->bhr", q_n.float(), w_uk.float())
    q_lat = torch.cat([q_eff, q_r.float()], -1)               # (b, H, r + dr)
    q_att = q_lat.to(cache.latent.dtype)
    lat4 = _lat4(cache)
    sm = _sm_scale(cfg)
    res = None
    if use_pariskv:
        qt = E.encode_query(q_lat[:, None], pcfg, signs)      # group dim 1
        res = R.retrieve(cache.meta_ids, cache.meta_codes, cache.meta_w, qt,
                         regions.enc_end, pcfg, num_candidates, pcfg.top_k,
                         hist_sample=pcfg.hist_sample)
        W = CC.window_size(pcfg)
        ws = (pos + 1 - W).clamp_min(0)
        attn_lat = A.sparse_decode_attention(
            q_att, lat4, None, res.indices, ws, pos, regions.enc_end,
            res.phys_rows, sink_size=pcfg.sink_size, window_size=W,
            sm_scale=sm)                                      # (b, H, r + dr)
    else:
        attn_lat = A.dense_decode_attention(q_att, lat4, lat4, pos,
                                            sm_scale=sm)

    # decompress the attended latent through W_UV, heads concatenated
    w_uv = p["w_uv"].reshape(r, H, dv)
    out = torch.einsum("bhr,rhv->bhv", attn_lat[..., :r].float(),
                       w_uv.float())
    return out.reshape(b, H * dv).to(x_t.dtype) @ p["wo"], res
