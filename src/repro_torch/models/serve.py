"""Serving-side forward passes over the paged pool (port of the solo-prefill
paged path of ``repro/models/serve.py``).

* ``prefill`` runs the prompt through every layer into a contiguous
  batch=1 cache (``core.cache.LayerKVCache``) with ParisKV metadata.
* ``admit_paged`` scatters that cache into the shared block pool and
  computes the slot's incremental bucket histogram.
* ``decode_chunk`` runs ``num_steps`` greedy decode steps; every layer
  goes through ``layers.attn_decode_pariskv_paged_fused`` and promotes its
  oldest window tokens when a row's window fills.

The reference scans layers and steps with ``lax.scan`` and guards the
promotion encode with ``lax.cond``; here they are Python loops and a host
``if``. Deciding "any row promotes" and selecting the rows whose append
block is allocated each read a small tensor back from the device: two
synchronizations per decode step, shared by all layers. Pool and
histogram tensors are updated in place.
"""
from __future__ import annotations

import functools
from typing import Any, List, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import cache as CC
from repro_torch.core import srht
from repro_torch.core.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.model import (LayerDef, _embed, _unembed, layer_defs,
                                      param_device, torch_dtype)


class ServeState(NamedTuple):
    caches: Any              # list over layers of {"kv": ..., "hist": ...}
    regions: CC.CacheRegions


class SlotState(NamedTuple):
    """Device state of the slot engine: per-layer pool caches plus
    per-slot ``pos`` / ``enc_end`` / ``cur_tok`` / ``remaining`` (b,)."""
    caches: Any
    regions: CC.CacheRegions
    cur_tok: torch.Tensor    # (b,) int32
    remaining: torch.Tensor  # (b,) int32


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
                      block_size: int, device) -> List[dict]:
    """Per layer: the shared block pool ``kv`` and the slot-local
    (batch, G, B, 2^m) int32 incremental bucket histogram ``hist``."""
    pcfg = cfg.pariskv
    dt = torch_dtype(cfg)
    hist_shape = (batch, cfg.num_kv_heads,
                  pcfg.num_subspaces(cfg.head_dim), pcfg.num_centroids())
    out = []
    for ld in layer_defs(cfg):
        if not ld.use_pariskv:
            raise NotImplementedError("only ParisKV layers are paged "
                                      "(ROADMAP A13)")
        out.append({
            "kv": CC.init_paged_cache(num_blocks, block_size,
                                      cfg.num_kv_heads, cfg.head_dim, pcfg,
                                      dt, device),
            "hist": torch.zeros(hist_shape, dtype=torch.int32,
                                device=device)})
    return out


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
                  any_promote: bool, block_tables: torch.Tensor,
                  append_index, record: Optional[list]) -> torch.Tensor:
    """One layer of one decode step: fused paged ParisKV attention, then
    (when ``any_promote``) promotion of every triggered row's oldest
    ``update_interval`` window tokens with the histogram maintained."""
    pcfg = cfg.pariskv
    h = L.rms_norm(x_t, p["norm_attn"], cfg.norm_eps)
    y, res = L.attn_decode_pariskv_paged_fused(
        p["attn"], h, cache["kv"], cache["hist"], block_tables, regions,
        ld.attn, pcfg, signs, num_candidates, append_index=append_index)
    if record is not None:
        record.append(res)
    if any_promote:
        CC.paged_promote_rows_hist(cache["kv"], cache["hist"], block_tables,
                                   regions.enc_end, will_promote, pcfg,
                                   signs)
    x_t = x_t + y.to(x_t.dtype)
    h = L.rms_norm(x_t, p["norm_mlp"], cfg.norm_eps)
    return x_t + L.mlp_fwd(p["mlp"], h).to(x_t.dtype)


def _stage_pass(params: dict, cfg: ModelConfig, x_t: torch.Tensor,
                caches: List[dict], regions: CC.CacheRegions,
                signs: torch.Tensor, num_candidates: int,
                will_promote: torch.Tensor, any_promote: bool,
                block_tables: torch.Tensor,
                record: Optional[list]) -> torch.Tensor:
    """One step's layer stack, layer by layer (the reference scans each
    stage's stacked layers). The rows whose append block is allocated are
    selected once and shared by every layer."""
    bs = caches[0]["kv"].k.shape[1]
    append_index = CC.paged_append_index(block_tables, regions.pos + 1, bs)
    for ld, p, cache in zip(layer_defs(cfg), params["layers"], caches):
        x_t = _layer_decode(p, x_t, ld, cfg, cache, regions, signs,
                            num_candidates, will_promote, any_promote,
                            block_tables, append_index, record)
    return x_t


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                state: ServeState, block_tables: torch.Tensor,
                active: Optional[torch.Tensor] = None,
                record: Optional[list] = None):
    """One decode step over the paged pool: token (b,) int32 → (logits
    (b, vocab), new state). The caches update in place.

    Rows advance independently: ``active`` (b,) bool freezes the
    ``pos``/``enc_end`` of inactive rows (free or finished slots) and keeps
    them from promoting; their compute still runs and their append lands
    at the dead position pos + 1 (or is dropped through an unallocated
    table entry). ``record``, when a list, receives each layer's
    PagedRetrievalResult (for audits and parity tests)."""
    pcfg = cfg.pariskv
    b = token.shape[0]
    dev = token.device
    signs = rotation_signs(cfg, dev)
    x_t = _embed(params, cfg, token)
    regions = state.regions
    act = (torch.ones((b,), dtype=torch.bool, device=dev) if active is None
           else active)
    will_promote = CC.promote_trigger(regions, pcfg) & act
    any_promote = bool(will_promote.any())           # host sync
    bs = state.caches[0]["kv"].k.shape[1]
    num_candidates = pcfg.candidate_count(block_tables.shape[1] * bs)
    x_t = _stage_pass(params, cfg, x_t, state.caches, regions, signs,
                      num_candidates, will_promote, any_promote,
                      block_tables, record)
    x_t = L.rms_norm(x_t, params["final_norm"], cfg.norm_eps)
    logits = _unembed(params, cfg, x_t)
    new_regions = CC.CacheRegions(
        pos=torch.where(act, regions.pos + 1, regions.pos),
        enc_end=torch.where(will_promote,
                            regions.enc_end + pcfg.update_interval,
                            regions.enc_end))
    return logits, ServeState(state.caches, new_regions)


# ------------------------------------------------------- slot state ---------
def init_paged_slot_state(cfg: ModelConfig, batch: int, num_blocks: int,
                          block_size: int, device=None) -> SlotState:
    """Empty slot state over a shared block pool on ``device`` (the first
    CUDA card unless ``device="cpu"``). Block tables are host-managed by
    the engine and passed to ``decode_chunk`` per call."""
    dev = resolve_device(device)

    def z():
        return torch.zeros((batch,), dtype=torch.int32, device=dev)
    return SlotState(
        caches=make_paged_caches(cfg, batch, num_blocks, block_size, dev),
        regions=regions_init(batch, dev), cur_tok=z(), remaining=z())


@torch.no_grad()
def decode_chunk(params: dict, cfg: ModelConfig, state: SlotState,
                 num_steps: int, block_tables: torch.Tensor,
                 eos_id: Optional[int] = None, device=None,
                 nonfinite: Optional[torch.Tensor] = None):
    """``num_steps`` greedy decode steps with per-slot active masking.
    Returns (tokens (b, num_steps) int32 with -1 at inactive steps, state).
    Runs on the first CUDA card unless ``device="cpu"``; the state, params
    and tables must live there. ``nonfinite``, a 0-d int64 device tensor,
    accumulates the count of non-finite logits (no synchronization)."""
    dev = resolve_device(device)
    _check_params(params, dev)
    if state.cur_tok.device.type != dev.type:
        raise ValueError(f"state lives on {state.cur_tok.device}, the call "
                         f"runs on {dev}")
    block_tables = block_tables.to(dev)
    emitted = []
    for _ in range(num_steps):
        active = state.remaining > 0
        logits, new = decode_step(params, cfg, state.cur_tok,
                                  ServeState(state.caches, state.regions),
                                  block_tables, active=active)
        if nonfinite is not None:
            nonfinite += (~torch.isfinite(logits)).sum()
        nxt = logits.argmax(-1).to(torch.int32)
        emitted.append(torch.where(active, nxt, -1))
        rem = state.remaining - active.to(torch.int32)
        if eos_id is not None:
            rem = torch.where(active & (nxt == eos_id), 0, rem)
        state = SlotState(new.caches, new.regions,
                          torch.where(active, nxt, state.cur_tok), rem)
    return torch.stack(emitted, dim=1), state


@torch.no_grad()
def admit_paged(state: SlotState, slot: int, phys_blocks: torch.Tensor,
                caches1: List[dict], regions1: CC.CacheRegions, tok0: int,
                rem: int, pcfg) -> SlotState:
    """Install a solo (batch=1) prefill result into slot ``slot``, in
    place: pool blocks scatter to ``phys_blocks`` (n_max // block_size
    entries, sentinels >= num_blocks for unallocated ones) and the slot's
    histogram is computed from the prefilled metadata."""
    phys_blocks = phys_blocks.to(state.cur_tok.device)
    for lc, lc1 in zip(state.caches, caches1):
        CC.paged_scatter_prefill(lc["kv"], lc1["kv"], phys_blocks)
        lc["hist"][slot] = CC.bucket_hist_from_meta(lc1["kv"].meta_ids,
                                                    regions1, pcfg)[0]
    state.regions.pos[slot] = regions1.pos[0]
    state.regions.enc_end[slot] = regions1.enc_end[0]
    state.cur_tok[slot] = tok0
    state.remaining[slot] = rem
    return state


def cancel_slot(state: SlotState, slot: int) -> SlotState:
    """Deactivate ``slot`` (no more decode steps); the engine reclaims its
    blocks and histogram row."""
    state.remaining[slot] = 0
    return state
