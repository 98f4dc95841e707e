"""Serving-side forward passes (port of the solo-prefill and chunked-fill
paths of ``repro/models/serve.py``).

* ``prefill`` runs LEFT-aligned prompts (or right-aligned ones with no
  ``lengths``, as the wave engine sends them) through every layer into
  contiguous caches (``core.cache.LayerKVCache``) with ParisKV metadata.
* ``admit_slot`` copies a batch-1 prefill into a contiguous slot;
  ``admit_paged`` scatters it into the shared block pool and computes the
  slot's incremental bucket histogram; ``admit_tiered`` scatters only the
  metadata and the histogram into a tiered pool (the engine writes the
  prompt's K/V to the host pool).
* ``decode_step`` / ``decode_chunk`` run greedy decode steps over
  contiguous caches (``block_tables`` None) or the paged pool (fused, or
  the meta-view fallback with ``paged_fused=False``), ParisKV or the
  full-attention baseline (``use_pariskv=False``, contiguous only); with
  ``dev_map`` the paged pool is tiered (staging K/V on the device, the
  full K/V in host memory).
* With ``prefill_budget`` P > 0 (chunked prefill), ``admit_fill`` copies a
  prompt to the slot's device buffer and ``decode_chunk``'s steps become
  mixed prefill+decode steps: each also runs one P-token chunk of the (at
  most one) filling slot through every layer (``decode_fill_step``),
  after that layer's decode, and the slot emits its first token the step
  its fill completes. The host knows each fill's progress, so the filling
  slot, its frontier and the chunk's length are Python ints: a mixed step
  adds no host synchronization, and a step with no filling slot is the
  plain ``decode_step``.

The reference scans layers and steps with ``lax.scan`` and guards the
promotion encode with ``lax.cond``; here they are Python loops and a host
``if``. Deciding "any row promotes" reads a bool back from the device once
per step; the paged paths also select the rows whose append block is
allocated (a second synchronization), both shared by all layers. Cache,
pool and histogram tensors are updated in place.
"""
from __future__ import annotations

import functools
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import cache as CC
from repro_torch.core import srht
from repro_torch.core.config import ModelConfig
from repro_torch.kernels.gather_kv import gather_heads_tiered
from repro_torch.models import layers as L
from repro_torch.models.model import (LayerDef, _embed, _unembed, layer_defs,
                                      param_device, torch_dtype)


class ServeState(NamedTuple):
    caches: Any              # list over layers of {"kv": ..., "hist": ...}
    regions: CC.CacheRegions


class TierView(NamedTuple):
    """One decode chunk's view of the host-offloaded tier: the residency
    map (frozen for the chunk), the host block tables composed with it,
    each layer's host K/V rows (k, v) (num_blocks·block_size, G, hd), and
    the ``layers.SideStream`` of the overlapped winner gather (None: one
    stream)."""
    dev_map: torch.Tensor
    kv_tables: torch.Tensor
    host_kv: list
    side: Any


class SlotState(NamedTuple):
    """State of the slot engine: per-layer caches plus per-slot ``pos`` /
    ``enc_end`` / ``cur_tok`` / ``remaining`` (b,) on the device.

    Under chunked prefill (``prefill_budget`` > 0; None otherwise)
    ``prompt`` holds each slot's prompt tokens on the device, ``n_max + P``
    wide so that the last chunk's slice never runs past it, and the host
    arrays ``fill_pos`` / ``fill_len`` track each fill: a slot with
    ``fill_pos < fill_len`` is filling."""
    caches: Any
    regions: CC.CacheRegions
    cur_tok: torch.Tensor    # (b,) int32
    remaining: torch.Tensor  # (b,) int32
    fill_pos: Any = None     # (b,) int64 numpy: prompt tokens written
    fill_len: Any = None     # (b,) int64 numpy: prompt length (0: no fill)
    prompt: Any = None       # (b, n_max + P) int32 device prompt buffer


def rotation_signs(cfg: ModelConfig, device) -> torch.Tensor:
    pcfg = cfg.pariskv
    return _signs(pcfg.padded_dim(cfg.retrieval_dim()), pcfg.srht_seed,
                  str(device))


@functools.lru_cache(maxsize=16)
def _signs(dim: int, seed: int, device: str) -> torch.Tensor:
    """The shared Rademacher signs on ``device``, copied there once."""
    return torch.from_numpy(srht.rademacher_signs(dim, seed)).to(device)


def _check_params(params: dict, dev: torch.device) -> None:
    pd = param_device(params)
    if pd.type != dev.type or (dev.index is not None
                               and pd.index != dev.index):
        raise ValueError(f"params live on {pd}, the call runs on {dev}")


def make_caches(cfg: ModelConfig, batch: int, n_max: int,
                device) -> List[dict]:
    """Contiguous per-layer caches (solo prefill)."""
    dt = torch_dtype(cfg)
    return [{"kv": CC.init_layer_cache(batch, n_max, cfg.num_kv_heads,
                                       cfg.head_dim, cfg.pariskv, dt, device)}
            for _ in layer_defs(cfg)]


def make_paged_caches(cfg: ModelConfig, batch: int, num_blocks: int,
                      block_size: int, device,
                      num_device_blocks: Optional[int] = None) -> List[dict]:
    """Per layer: the shared block pool ``kv`` and the slot-local
    (batch, G, B, 2^m) int32 incremental bucket histogram ``hist``.

    ``num_device_blocks`` makes the pool tiered: metadata for all
    ``num_blocks`` blocks, K/V for a staging pool of ``num_device_blocks``
    (the full K/V lives in ``serving.offload.HostKVPool``), plus the
    ``fetch`` statistics of a chunk: ``touched`` (num_blocks,) int32
    winner references per host block, ``rows`` (batch, 4) int32 [winner
    rows, staging hits, host fetches, fill prefix rows read from host
    memory], ``uniq`` (2,) int64 distinct (row, kv head) pairs the tiered
    gathers read from host memory [winners, fill prefix], ``calls`` the
    tiered gathers issued (a host count) — zeroed at each ``decode_chunk``
    entry."""
    pcfg = cfg.pariskv
    dt = torch_dtype(cfg)
    hist_shape = (batch, cfg.num_kv_heads,
                  pcfg.num_subspaces(cfg.head_dim), pcfg.num_centroids())
    nd = num_blocks if num_device_blocks is None else num_device_blocks
    out = []
    for ld in layer_defs(cfg):
        if not ld.use_pariskv:
            raise NotImplementedError("only ParisKV layers are paged "
                                      "(ROADMAP A13)")
        entry = {
            "kv": CC.init_tiered_cache(num_blocks, nd, block_size,
                                       cfg.num_kv_heads, cfg.head_dim, pcfg,
                                       dt, device),
            "hist": torch.zeros(hist_shape, dtype=torch.int32,
                                device=device)}
        if num_device_blocks is not None:
            entry["fetch"] = {
                "touched": torch.zeros((num_blocks,), dtype=torch.int32,
                                       device=device),
                "rows": torch.zeros((batch, 4), dtype=torch.int32,
                                    device=device),
                "uniq": torch.zeros((2,), dtype=torch.int64, device=device),
                "calls": 0}
        out.append(entry)
    return out


def offload_support_reason(cfg: ModelConfig) -> Optional[str]:
    """Why the tiered host-offloaded pool cannot serve this architecture,
    or None when it can: it pages exactly what ``make_paged_caches`` pages
    (ParisKV attention K/V), so only MLA's latent caches are out."""
    for i, ld in enumerate(layer_defs(cfg)):
        if ld.mixer == "mla":
            return (f"config {cfg.name!r}: layer {i} mixer 'mla' keeps "
                    f"latent caches contiguous")
    return None


def fill_support_reason(cfg: ModelConfig) -> Optional[str]:
    """Why chunked prefill cannot serve this architecture, or None when it
    can: every mixer must be plain attention."""
    for i, ld in enumerate(layer_defs(cfg)):
        if ld.mixer != "attn":
            return (f"config {cfg.name!r}: layer {i} mixer {ld.mixer!r} has "
                    f"no chunk-resumable prefill (attention mixers only)")
    return None


def fill_supported(cfg: ModelConfig) -> bool:
    return fill_support_reason(cfg) is None


def regions_init(batch: int, device) -> CC.CacheRegions:
    return CC.CacheRegions(
        pos=torch.full((batch,), -1, dtype=torch.int32, device=device),
        enc_end=torch.zeros((batch,), dtype=torch.int32, device=device))


# ------------------------------------------------------------- prefill -----
def _layer_prefill(p: dict, x: torch.Tensor, ld: LayerDef, cfg: ModelConfig,
                   positions: torch.Tensor, cache: dict,
                   signs: torch.Tensor,
                   lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """One layer over the full prompt; fills this layer's cache in place."""
    h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
    y, k_new, v_new = L.attn_prefill(p["attn"], h, ld.attn, positions)
    CC.prefill_write(cache["kv"], k_new, v_new, cfg.pariskv, signs,
                     lengths=lengths)
    x = x + y.to(x.dtype)
    h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    return x + L.mlp_fwd(p["mlp"], h).to(x.dtype)


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, tokens, n_max: int,
            lengths=None, device=None):
    """Process LEFT-aligned prompts ``tokens`` (b, S); returns the logits
    at each row's last real token (b, vocab) and a ServeState holding
    contiguous (b, n_max) caches. ``lengths`` (b,) are the true prompt
    lengths (default: all S). Runs on the first CUDA card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    _check_params(params, dev)
    tokens = torch.as_tensor(tokens, device=dev)
    b, S = tokens.shape
    signs = rotation_signs(cfg, dev)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=dev).expand(b, S)
    lens = None if lengths is None else torch.as_tensor(
        lengths, dtype=torch.int32, device=dev)
    caches = make_caches(cfg, b, n_max, dev)
    for ld, p, cache in zip(layer_defs(cfg), params["layers"], caches):
        x = _layer_prefill(p, x, ld, cfg, positions, cache, signs, lens)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if lens is None:
        lens = torch.full((b,), S, dtype=torch.int32, device=dev)
    x_last = x[torch.arange(b, device=dev), (lens - 1).long()]
    logits = _unembed(params, cfg, x_last)
    return logits, ServeState(caches, CC.initial_regions(lens, cfg.pariskv))


# --------------------------------------------------------------- decode ----
def _layer_decode(p: dict, x_t: torch.Tensor, ld: LayerDef, cfg: ModelConfig,
                  cache: dict, regions: CC.CacheRegions, signs: torch.Tensor,
                  num_candidates: int, will_promote: torch.Tensor,
                  any_promote: bool, block_tables: Optional[torch.Tensor],
                  append_index, record: Optional[list], use_pariskv: bool,
                  paged_fused: bool, tier: Optional[TierView] = None,
                  host_kv=None) -> torch.Tensor:
    """One layer of one decode step. ParisKV layers run the contiguous
    path (``block_tables`` None), the fused paged path, or the paged
    meta-view fallback (``paged_fused=False``) — over a tiered pool when
    ``tier`` is given, with this layer's host rows ``host_kv`` and the
    step's fetch statistics added to the cache's ``fetch`` entry — then
    (when ``any_promote``) promote every triggered row's oldest
    ``update_interval`` window tokens — on the paged paths with the
    histogram maintained (a tiered pool gathers the keys through the
    composed staging tables). ``use_pariskv=False`` is the full-attention
    baseline over the contiguous cache (no promotion)."""
    pcfg = cfg.pariskv
    h = L.rms_norm(x_t, p["norm_attn"], cfg.norm_eps)
    kv = cache["kv"]
    res = None
    if not (use_pariskv and ld.use_pariskv):
        y = L.attn_decode_dense(p["attn"], h, (kv.k, kv.v), regions.pos + 1,
                                ld.attn)
    elif block_tables is None:
        y, res = L.attn_decode_pariskv(p["attn"], h, kv, regions, ld.attn,
                                       pcfg, signs, num_candidates)
        if any_promote:
            CC.promote_rows(kv, regions.enc_end, will_promote, pcfg, signs)
    elif tier is not None:
        f = cache["fetch"]
        y, res, delta = L.attn_decode_pariskv_tiered(
            p["attn"], h, kv, cache["hist"], block_tables, tier.kv_tables,
            tier.dev_map, *host_kv, regions, ld.attn, pcfg, signs,
            num_candidates, fused=paged_fused, append_index=append_index,
            side=tier.side, count=f["uniq"][0:1])
        if any_promote:
            CC.paged_promote_rows_hist(kv, cache["hist"], block_tables,
                                       regions.enc_end, will_promote, pcfg,
                                       signs, kv_tables=tier.kv_tables)
        f["touched"] += delta["touched"]
        f["rows"][:, :3] += delta["rows"]
        f["calls"] += delta["calls"]
    else:
        if paged_fused:
            y, res = L.attn_decode_pariskv_paged_fused(
                p["attn"], h, kv, cache["hist"], block_tables, regions,
                ld.attn, pcfg, signs, num_candidates,
                append_index=append_index)
        else:
            y, res = L.attn_decode_pariskv_paged(
                p["attn"], h, kv, block_tables, regions, ld.attn, pcfg,
                signs, num_candidates, append_index=append_index)
        if any_promote:
            CC.paged_promote_rows_hist(kv, cache["hist"], block_tables,
                                       regions.enc_end, will_promote, pcfg,
                                       signs)
    if record is not None and res is not None:
        record.append(res)
    x_t = x_t + y.to(x_t.dtype)
    h = L.rms_norm(x_t, p["norm_mlp"], cfg.norm_eps)
    return x_t + L.mlp_fwd(p["mlp"], h).to(x_t.dtype)


# ------------------------------------------------------- chunked fill -----
class FillCtx(NamedTuple):
    """One prompt chunk of the filling slot inside a mixed prefill+decode
    step: host ints, and the index tensors every layer shares (built once
    per step by ``fill_ctx``)."""
    slot: int                # the filling slot's batch row
    start: int               # fill frontier before the step
    valid_n: int             # real prompt tokens in the chunk (<= P)
    q_pos: torch.Tensor      # (1, P) positions start + arange(P)
    new_pos: torch.Tensor    # (1, P) q_pos, -1 on the pad tail
    pref_pos: torch.Tensor   # (1, n) prefix key positions, -1 at >= start
    bt_row: Optional[torch.Tensor] = None     # (1, nblk) int32 table row
    pref_lidx: Optional[torch.Tensor] = None  # (1, n) int32 positions read
    index: Any = None        # paged_fill_index of the host table row
    kv_index: Any = None     # tiered: of the composed staging row
    pref_rows: Optional[torch.Tensor] = None  # tiered: (1, G, 1, n) rows
    host_rows: int = 0       # tiered: prefix rows read from host memory


def filling_slot(state: SlotState) -> Optional[int]:
    """The slot whose fill is in progress (at most one), or None."""
    if state.fill_len is None:
        return None
    rows = np.flatnonzero((state.fill_len > 0)
                          & (state.fill_pos < state.fill_len))
    return int(rows[0]) if rows.size else None


def fill_ctx(state: SlotState, slot: int, budget: int, device,
             bt_host: Optional[np.ndarray] = None,
             block_tables: Optional[torch.Tensor] = None,
             block_size: int = 0, num_kv_heads: int = 0,
             dev_map_host: Optional[np.ndarray] = None) -> FillCtx:
    """The next chunk of ``slot``'s fill: ``budget`` prompt positions from
    its frontier. Contiguous caches (no ``block_tables``) read the slot's
    row [0, start) directly. Paged pools read the written prefix rounded
    up to whole blocks through the slot's table row; the reference reads
    the whole row and masks the rest, so only the summation order
    differs. With ``dev_map_host`` the pool is tiered: the prefix comes
    through the tiered gather, staged blocks from staging, the others
    from host memory."""
    start = int(state.fill_pos[slot])
    valid_n = min(budget, int(state.fill_len[slot]) - start)
    ar = torch.arange(budget, device=device)
    q_pos = (start + ar)[None]
    new_pos = torch.where(ar < valid_n, q_pos[0], -1)[None]
    if block_tables is None:
        return FillCtx(slot, start, valid_n, q_pos, new_pos,
                       torch.arange(start, device=device)[None])
    bs = block_size
    row = bt_host[slot]
    n = min(-(-start // bs), row.shape[0]) * bs
    idx = torch.arange(n, dtype=torch.int32, device=device)
    pref_pos = torch.where(idx < start, idx, -1)[None]
    bt_row = block_tables[slot:slot + 1]
    index = CC.paged_fill_index(row, start, valid_n, bs, device)
    if dev_map_host is None:
        return FillCtx(slot, start, valid_n, q_pos, new_pos, pref_pos,
                       bt_row, idx[None], index)
    kv_row = np.where(row >= 0, dev_map_host[np.clip(row, 0, None)], -1)
    pb = bt_row[0, torch.div(idx, bs, rounding_mode="floor").long()]
    rows = torch.where((idx < start) & (pb >= 0), pb * bs + idx % bs, -1)
    pref_rows = rows.to(torch.int32).view(1, 1, 1, n).expand(
        1, num_kv_heads, 1, n).contiguous()
    written = np.minimum(start - np.arange(row.shape[0]) * bs, bs)
    host_rows = int(written[(written > 0) & (row >= 0)
                            & (kv_row < 0)].sum())
    return FillCtx(slot, start, valid_n, q_pos, new_pos, pref_pos, bt_row,
                   None, index,
                   CC.paged_fill_index(kv_row, start, valid_n, bs, device),
                   pref_rows, host_rows)


def _layer_fill(p: dict, x_f: torch.Tensor, ld: LayerDef, cfg: ModelConfig,
                cache: dict, fctx: FillCtx, signs: torch.Tensor,
                use_pariskv: bool, tier: Optional[TierView] = None,
                host_kv=None) -> torch.Tensor:
    """One layer of one prefill chunk of the filling slot: the prefix read
    (the slot's contiguous row, the paged gather's logical mode through
    its table row, or the tiered gather), chunk-causal attention over the
    prefix and the chunk, the chunk's K/V and metadata written, and on a
    paged pool the slot's histogram advanced (``paged_fill_hist_update``),
    so it stays exact mid-fill. A tiered pool adds the prefix's host rows
    to the chunk's ``fetch`` statistics. Runs after the layer's decode:
    the filling row's dead decode append lands at the fill frontier, which
    the chunk overwrites."""
    pcfg = cfg.pariskv
    h = L.rms_norm(x_f, p["norm_attn"], cfg.norm_eps)
    kv = cache["kv"]
    slot, start, n = fctx.slot, fctx.start, fctx.valid_n
    if fctx.bt_row is None:
        k_pref, v_pref = kv.k[slot:slot + 1, :start], kv.v[slot:slot + 1,
                                                           :start]
    elif start == 0:                     # the first chunk: no prefix yet
        k_pref = v_pref = kv.k.new_empty((1, 0) + kv.k.shape[2:])
    elif tier is None:
        k_pref, v_pref = CC.paged_gather_rows(kv.k, kv.v, fctx.bt_row,
                                              fctx.pref_lidx)
    else:
        f = cache["fetch"]
        k_h, v_h = gather_heads_tiered(kv.k, kv.v, *host_kv, tier.dev_map,
                                       fctx.pref_rows, f["uniq"][1:2])
        k_pref, v_pref = (t[:, :, 0].transpose(1, 2) for t in (k_h, v_h))
        f["calls"] += 1
        if fctx.host_rows:
            f["rows"][slot, 3] += fctx.host_rows
    y, k_new, v_new = L.attn_fill_chunk(p["attn"], h, ld.attn, fctx.q_pos,
                                        k_pref, v_pref, fctx.pref_pos,
                                        fctx.new_pos)
    meta = (CC._encode_block(k_new, pcfg, signs)
            if use_pariskv and ld.use_pariskv else None)
    if fctx.bt_row is None:
        CC.fill_chunk_write(kv, slot, start, k_new[0], v_new[0], n, meta)
    else:
        if tier is None:
            CC.paged_fill_chunk_write(kv, None, start, k_new[0], v_new[0], n,
                                      meta, index=fctx.index)
        else:
            CC.tiered_fill_chunk_write(kv, None, None, start, k_new[0],
                                       v_new[0], n, meta, index=fctx.index,
                                       kv_index=fctx.kv_index)
        CC.paged_fill_hist_update(kv, cache["hist"][slot:slot + 1],
                                  fctx.bt_row, start, start + n, pcfg)
    x_f = x_f + y.to(x_f.dtype)
    h = L.rms_norm(x_f, p["norm_mlp"], cfg.norm_eps)
    return x_f + L.mlp_fwd(p["mlp"], h).to(x_f.dtype)


# --------------------------------------------------------------- steps -----
def _step(params: dict, cfg: ModelConfig, token: torch.Tensor,
          state: ServeState, block_tables: Optional[torch.Tensor],
          active: Optional[torch.Tensor], record: Optional[list],
          use_pariskv: bool, paged_fused: bool, tier: Optional[TierView],
          fill=None):
    """One decode step, with ``fill`` = (fill tokens (1, P), FillCtx) one
    prefill chunk of the filling slot after each layer's decode. →
    (logits (b, vocab), fill logits (1, vocab) or None, new state)."""
    pcfg = cfg.pariskv
    b = token.shape[0]
    dev = token.device
    signs = rotation_signs(cfg, dev)
    x_t = _embed(params, cfg, token)
    x_f = None if fill is None else _embed(params, cfg, fill[0])
    regions = state.regions
    act = (torch.ones((b,), dtype=torch.bool, device=dev) if active is None
           else active)
    will_promote = CC.promote_trigger(regions, pcfg) & act
    append_index = None
    if block_tables is None:
        n_max = state.caches[0]["kv"].k.shape[1]
    else:
        if not use_pariskv:
            raise ValueError("paged decode serves the ParisKV path only")
        bs = state.caches[0]["kv"].k.shape[1]
        n_max = block_tables.shape[1] * bs
        append_index = CC.paged_append_index(
            block_tables if tier is None else tier.kv_tables,
            regions.pos + 1, bs)
    any_promote = use_pariskv and bool(will_promote.any())   # host sync
    num_candidates = pcfg.candidate_count(n_max)
    for li, (ld, p, cache) in enumerate(zip(layer_defs(cfg), params["layers"],
                                            state.caches)):
        host_kv = None if tier is None else tier.host_kv[li]
        x_t = _layer_decode(p, x_t, ld, cfg, cache, regions, signs,
                            num_candidates, will_promote, any_promote,
                            block_tables, append_index, record, use_pariskv,
                            paged_fused, tier, host_kv)
        if x_f is not None:
            x_f = _layer_fill(p, x_f, ld, cfg, cache, fill[1], signs,
                              use_pariskv, tier, host_kv)
    x_t = L.rms_norm(x_t, params["final_norm"], cfg.norm_eps)
    logits = _unembed(params, cfg, x_t)
    fill_logits = None
    if x_f is not None:
        x_last = L.rms_norm(x_f[:, fill[1].valid_n - 1],
                            params["final_norm"], cfg.norm_eps)
        fill_logits = _unembed(params, cfg, x_last)
    new_regions = CC.CacheRegions(
        pos=torch.where(act, regions.pos + 1, regions.pos),
        enc_end=torch.where(will_promote,
                            regions.enc_end + pcfg.update_interval,
                            regions.enc_end))
    return logits, fill_logits, ServeState(state.caches, new_regions)


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                state: ServeState, block_tables: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None,
                record: Optional[list] = None, use_pariskv: bool = True,
                paged_fused: bool = True, tier: Optional[TierView] = None):
    """One decode step: token (b,) int32 → (logits (b, vocab), new state).
    The caches update in place.

    ``block_tables`` (b, nblk) int32 selects the paged pool (caches from
    ``make_paged_caches``), None the contiguous per-slot caches
    (``make_caches``); ``paged_fused=False`` takes the paged meta-view
    fallback and ``use_pariskv=False`` the full-attention baseline
    (contiguous only). Rows advance independently: ``active`` (b,) bool
    freezes the ``pos``/``enc_end`` of inactive rows (free or finished
    slots) and keeps them from promoting; their compute still runs and
    their append lands at the dead position pos + 1 (clamped to the store,
    or dropped through an unallocated table entry). ``record``, when a
    list, receives each layer's retrieval result (audits and parity
    tests). ``tier`` serves a tiered pool (``decode_chunk`` builds it).

    Deciding "any row promotes" reads one bool back from the device; the
    paged paths also select the rows whose append block is allocated, once
    per step for all layers."""
    logits, _, new = _step(params, cfg, token, state, block_tables, active,
                           record, use_pariskv, paged_fused, tier)
    return logits, new


@torch.no_grad()
def decode_fill_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                     state: ServeState, fill_tokens: torch.Tensor,
                     fctx: FillCtx,
                     block_tables: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None,
                     use_pariskv: bool = True, paged_fused: bool = True,
                     tier: Optional[TierView] = None):
    """One mixed prefill+decode step: ``decode_step``'s math for every row
    plus the chunk ``fill_tokens`` (1, P) of the filling slot ``fctx``,
    layer by layer after each layer's decode (the slot must be inactive in
    ``active``). → (decode logits (b, vocab), the filling slot's logits at
    its last valid chunk token (1, vocab), new state). The caller advances
    the fill and emits the first token when it completes."""
    return _step(params, cfg, token, state, block_tables, active, None,
                 use_pariskv, paged_fused, tier, fill=(fill_tokens, fctx))


# ------------------------------------------------------- slot state ---------
def _zeros_slot_state(caches, batch: int, dev, n_max: int = 0,
                      prefill_budget: int = 0) -> SlotState:
    def z():
        return torch.zeros((batch,), dtype=torch.int32, device=dev)
    fill = {}
    if prefill_budget > 0:
        fill = dict(fill_pos=np.zeros((batch,), np.int64),
                    fill_len=np.zeros((batch,), np.int64),
                    prompt=torch.zeros((batch, n_max + prefill_budget),
                                       dtype=torch.int32, device=dev))
    return SlotState(caches=caches, regions=regions_init(batch, dev),
                     cur_tok=z(), remaining=z(), **fill)


def init_slot_state(cfg: ModelConfig, batch: int, n_max: int,
                    device=None, prefill_budget: int = 0) -> SlotState:
    """Empty slot state over contiguous per-slot caches of ``n_max``
    positions on ``device`` (the first CUDA card unless ``device="cpu"``);
    every slot starts free at ``pos = -1``. ``prefill_budget`` > 0 adds
    the chunked-fill state."""
    dev = resolve_device(device)
    return _zeros_slot_state(make_caches(cfg, batch, n_max, dev), batch, dev,
                             n_max, prefill_budget)


def init_paged_slot_state(cfg: ModelConfig, batch: int, num_blocks: int,
                          block_size: int, device=None,
                          num_device_blocks: Optional[int] = None,
                          n_max: int = 0, prefill_budget: int = 0
                          ) -> SlotState:
    """Empty slot state over a shared block pool on ``device`` (the first
    CUDA card unless ``device="cpu"``); ``num_device_blocks`` makes the
    pool tiered (``make_paged_caches``). Block tables are host-managed by
    the engine and passed to ``decode_chunk`` per call. ``prefill_budget``
    > 0 adds the chunked-fill state, its prompt buffer ``n_max + P``
    wide."""
    dev = resolve_device(device)
    return _zeros_slot_state(
        make_paged_caches(cfg, batch, num_blocks, block_size, dev,
                          num_device_blocks), batch, dev, n_max,
        prefill_budget)


@torch.no_grad()
def decode_chunk(params: dict, cfg: ModelConfig, state: SlotState,
                 num_steps: int, block_tables: Optional[torch.Tensor] = None,
                 eos_id: Optional[int] = None, device=None,
                 nonfinite: Optional[torch.Tensor] = None,
                 use_pariskv: bool = True, paged_fused: bool = True,
                 dev_map=None, host_kv=None, side=None,
                 prefill_budget: int = 0):
    """``num_steps`` greedy decode steps with per-slot active masking.
    Returns (tokens (b, num_steps) int32 with -1 at inactive steps, state).
    ``block_tables`` None means contiguous caches (``init_slot_state``);
    ``use_pariskv`` and ``paged_fused`` as in ``decode_step``. Runs on the
    first CUDA card unless ``device="cpu"``; the state, params and tables
    must live there (the tables and ``dev_map`` may also come from the
    host, as the engines pass them). ``nonfinite``, a 0-d int64 device
    tensor, accumulates the count of non-finite logits (no
    synchronization).

    ``dev_map`` (num_blocks,) int32 (host block → staging block, -1 = not
    staged) serves a tiered pool (``init_paged_slot_state(...,
    num_device_blocks=)``) with the per-layer host rows ``host_kv`` and,
    on a card, the overlap's ``side`` stream: the map is uploaded and
    composed with the tables once, frozen for the chunk, and the chunk's
    ``fetch`` statistics restart at zero.

    ``prefill_budget`` P > 0 (a state built with the same budget) makes a
    step with a filling slot a mixed step (``decode_fill_step``): the slot
    writes up to P more prompt tokens instead of decoding, and on the step
    its fill completes emits its first token, the argmax of the fill's
    logits, in that step's column. Its regions then stand at ``pos = f1 -
    1``, ``enc_end = fill_enc_end(f1)`` for frontier f1, so a completed
    fill lands on a solo prefill's ``initial_regions``."""
    dev = resolve_device(device)
    _check_params(params, dev)
    if state.cur_tok.device.type != dev.type:
        raise ValueError(f"state lives on {state.cur_tok.device}, the call "
                         f"runs on {dev}")
    P = int(prefill_budget)
    if P > 0 and state.prompt is None:
        raise ValueError("prefill_budget > 0 needs a state built with the "
                         "same budget")
    bt_host = dm_host = None
    if block_tables is not None:
        if P > 0:
            bt_host = block_tables.cpu().numpy()
        block_tables = block_tables.to(dev)
    tier = None
    if dev_map is not None:
        dev_map = torch.as_tensor(dev_map, dtype=torch.int32)
        if P > 0:
            dm_host = dev_map.cpu().numpy()
        dev_map = dev_map.to(dev)
        tier = TierView(dev_map, CC.tiered_kv_tables(block_tables, dev_map),
                        host_kv, side)
        for lc in state.caches:
            for key in ("touched", "rows", "uniq"):
                lc["fetch"][key].zero_()
            lc["fetch"]["calls"] = 0
    kv0 = state.caches[0]["kv"]
    emitted = []
    for _ in range(num_steps):
        active = state.remaining > 0
        fs = filling_slot(state) if P > 0 else None
        if fs is None:
            logits, new = decode_step(params, cfg, state.cur_tok,
                                      ServeState(state.caches, state.regions),
                                      block_tables, active=active,
                                      use_pariskv=use_pariskv,
                                      paged_fused=paged_fused, tier=tier)
        else:
            active[fs] = False
            fctx = fill_ctx(state, fs, P, dev, bt_host, block_tables,
                            kv0.k.shape[1], kv0.k.shape[2], dm_host)
            logits, fill_logits, new = decode_fill_step(
                params, cfg, state.cur_tok,
                ServeState(state.caches, state.regions),
                state.prompt[fs:fs + 1, fctx.start:fctx.start + P], fctx,
                block_tables, active, use_pariskv, paged_fused, tier)
        if nonfinite is not None:
            nonfinite += (~torch.isfinite(logits)).sum()
        nxt = logits.argmax(-1).to(torch.int32)
        emit = torch.where(active, nxt, -1)
        rem = state.remaining - active.to(torch.int32)
        if eos_id is not None:
            rem = torch.where(active & (nxt == eos_id), 0, rem)
        cur = torch.where(active, nxt, state.cur_tok)
        if fs is not None:
            f1 = fctx.start + fctx.valid_n
            state.fill_pos[fs] = f1
            new.regions.pos[fs] = f1 - 1
            new.regions.enc_end[fs] = CC.fill_enc_end(f1, cfg.pariskv)
            if f1 >= int(state.fill_len[fs]):
                ftok = fill_logits[0].argmax(-1).to(torch.int32)
                emit[fs] = ftok
                cur[fs] = ftok
                rem_f = rem[fs] - 1
                if eos_id is not None:
                    rem_f = torch.where(ftok == eos_id, 0, rem_f)
                rem[fs] = rem_f
        emitted.append(emit)
        state = state._replace(caches=new.caches, regions=new.regions,
                               cur_tok=cur, remaining=rem)
    return torch.stack(emitted, dim=1), state


@torch.no_grad()
def admit_paged(state: SlotState, slot: int, phys_blocks: torch.Tensor,
                caches1: List[dict], regions1: CC.CacheRegions, tok0: int,
                rem: int, pcfg, scatter=CC.paged_scatter_prefill
                ) -> SlotState:
    """Install a solo (batch=1) prefill result into slot ``slot``, in
    place: pool blocks scatter to ``phys_blocks`` (n_max // block_size
    entries, sentinels >= num_blocks for unallocated ones) and the slot's
    histogram is computed from the prefilled metadata. ``scatter`` writes
    one layer's blocks (``admit_tiered`` passes the metadata-only one)."""
    phys_blocks = phys_blocks.to(state.cur_tok.device)
    for lc, lc1 in zip(state.caches, caches1):
        scatter(lc["kv"], lc1["kv"], phys_blocks)
        lc["hist"][slot] = CC.bucket_hist_from_meta(lc1["kv"].meta_ids,
                                                    regions1, pcfg)[0]
    state.regions.pos[slot] = regions1.pos[0]
    state.regions.enc_end[slot] = regions1.enc_end[0]
    state.cur_tok[slot] = tok0
    state.remaining[slot] = rem
    return state


def admit_tiered(state: SlotState, slot: int, phys_blocks: torch.Tensor,
                 caches1: List[dict], regions1: CC.CacheRegions, tok0: int,
                 rem: int, pcfg) -> SlotState:
    """``admit_paged`` for a tiered pool: the device gets the metadata and
    the histogram only; the engine writes the prompt's K/V to the host
    pool and stages what the staging policy wants. ``phys_blocks`` may
    cover just the prefill's bucketed capacity: later logical blocks get
    metadata through promotion, before they enter the retrieval region."""
    return admit_paged(state, slot, phys_blocks, caches1, regions1, tok0,
                       rem, pcfg, scatter=CC.tiered_scatter_prefill_meta)


@torch.no_grad()
def admit_slot(state: SlotState, slot: int, caches1: List[dict],
               regions1: CC.CacheRegions, tok0: int, rem: int) -> SlotState:
    """Install a solo (batch=1) prefill result into contiguous slot
    ``slot``, in place: every cache tensor's row ``slot`` takes the batch-1
    row whole (the reference's ``ServingEngine._admit_impl``)."""
    for lc, lc1 in zip(state.caches, caches1):
        for big, small in zip(lc["kv"], lc1["kv"]):
            big[slot] = small[0]
    state.regions.pos[slot] = regions1.pos[0]
    state.regions.enc_end[slot] = regions1.enc_end[0]
    state.cur_tok[slot] = tok0
    state.remaining[slot] = rem
    return state


@torch.no_grad()
def admit_fill(state: SlotState, slot: int, prompt_row, length: int,
               max_new: int) -> SlotState:
    """Admit a request for chunked prefill, in place: copy its prompt
    (``prompt_row``, padded to the buffer's width) to the slot's device
    buffer and arm its fill; no forward pass runs here, the mixed steps of
    ``decode_chunk`` consume the prompt. The slot opens at ``pos = -1``,
    ``enc_end = 0`` with a zero histogram on a paged pool (a re-admitted
    slot counts from an empty retrieval region)."""
    for lc in state.caches:
        if "hist" in lc:
            lc["hist"][slot] = 0
    state.regions.pos[slot] = -1
    state.regions.enc_end[slot] = 0
    state.cur_tok[slot] = 0
    state.remaining[slot] = max_new
    state.fill_pos[slot] = 0
    state.fill_len[slot] = length
    state.prompt[slot] = torch.as_tensor(prompt_row, dtype=torch.int32).to(
        state.prompt.device)
    return state


def cancel_slot(state: SlotState, slot: int) -> SlotState:
    """Deactivate ``slot`` (no more decode steps, no more fill chunks);
    the engine reclaims its blocks and histogram row."""
    state.remaining[slot] = 0
    if state.fill_len is not None:
        state.fill_pos[slot] = 0
        state.fill_len[slot] = 0
    return state
