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
* ``dist`` (a ``distributed.ShardDist``) runs the paged paths on one
  rank's KV heads of a head-sharded group: the pool, its metadata and the
  histograms hold ``G / N`` heads (``make_paged_caches``), the replicated
  solo prefill is sliced to them at admission (``admit_paged``), and each
  global layer's decode and fill chunk run on them and gather the
  attention output heads of every rank
  (``layers.attn_decode_pariskv_paged_sharded``,
  ``attn_fill_chunk_sharded``); the rest of the model runs replicated,
  local layers and their ring buffers included.
* Local (sliding-window) layers (gemma's local/global pattern,
  ``LayerDef.use_pariskv`` False) cache their window in a ring buffer:
  the entry's ``kv`` is a plain (k, v) tuple of (batch, w, G, hd)
  tensors, w = min(window, n_max), position t at slot t % w, with no
  ``hist`` and no ``fetch`` entry. On the paged engines it stays
  slot-local beside the pool (``is_ring``, ``pool_entries``): admission
  copies it into the slot's row, decode writes at pos % w, a fill chunk
  reads its prefix from it by position and keeps each slot's last
  write; stale slots of a previous tenant are masked by position.
* Cross attention (llama-3.2-vision's ``cross`` layers, whisper's
  ``cross=True`` sublayers) reads the slot's media K/V, (batch, T, G, hd)
  in the config's dtype, computed once by the prefill from the request's
  media (whisper: from ``models.model.encoder_fwd`` of it) and static
  after it: a ``media_kv`` entry beside a whisper layer's ParisKV store
  or pool, a vision cross layer's entry alone (``_cross_cache``, tagged
  ``cross``, no ``kv``, so ``pool_entries`` skips it). It is slot-local
  on every layout (contiguous, paged, tiered, replicated at full heads on
  a head-sharded rank): admission copies it into the slot's row, and
  decode attends one query row to it (free slots too, over whatever
  media their row holds), whole on every rank. Chunked prefill and
  sharing refuse these families (``fill_support_reason``).
* SSD mixers (mamba2's ``ssm`` layers, the SSM half of hymba's
  ``hybrid`` layers, ``models.ssm``) keep their recurrent state, an
  ``ssm`` entry ``SSMCache`` (state (batch, h, p, n) float32, conv tail
  (batch, k - 1, conv_dim) in the config's dtype): alone on a mamba2
  layer (no ``kv``, so ``pool_entries`` skips it), beside the ParisKV
  store or pool on a hybrid layer, whose output is 0.5 · (attention +
  SSM). It is slot-local on every layout, whole on every rank:
  admission copies the slot's state and tail, decode advances every
  row's. The prefill skips a LEFT-aligned row's pads exactly (dt = 0
  there, ``token_valid``) and takes its tail from its last real inputs.
  A config with no ParisKV layer (mamba2) has no pool: the paged engines
  refuse it (``UnsupportedPagedConfig``), the slot and wave engines serve
  it. Chunked prefill and sharing refuse both families.
* MLA layers (deepseek-v2, ``models.mla``) keep a latent store and its
  ParisKV metadata, an ``MLACache`` under ``kv`` tagged ``mla``
  (``_mla_cache``, ``is_mla``; ``pool_entries`` skips it): contiguous on
  every engine, as in the reference. The prefill runs the decompressed
  attention and encodes the latent of every position (no ``lengths``);
  decode retrieves over the latent with the contiguous route and
  promotes, in the baseline (``use_pariskv=False``) too. Every paged
  engine, the offloaded tier and head sharding refuse such a config
  (``paged_refusal``, ``offload_support_reason``,
  ``sharded_support_reason``), and so do chunked prefill and sharing.
* With ``prefill_budget`` P > 0 (chunked prefill), ``admit_fill`` copies a
  prompt to the slot's device buffer (a shared-prefix admission starts
  the fill past the mapped prefix and rebuilds the slot's histogram from
  its blocks' metadata) and ``decode_chunk``'s steps become
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
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, trace
from repro_torch.core import cache as CC
from repro_torch.core import srht
from repro_torch.core.config import ModelConfig
from repro_torch.distributed import SeqShardDist
from repro_torch.kernels.gather_kv import gather_heads_tiered
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.model import (LayerDef, _embed, _gate, _unembed,
                                      encoder_fwd, layer_defs, layer_places,
                                      layer_plan, param_device, torch_dtype)


class ServeState(NamedTuple):
    caches: Any              # list over layers of {"kv": ..., "hist": ...}
    regions: CC.CacheRegions


def is_ring(lc: dict) -> bool:
    """Whether a layer's cache entry is a local layer's ring buffer
    (``_ring_cache`` tags it), not a ParisKV store or pool."""
    return lc.get("ring", False)


def is_cross(lc: dict) -> bool:
    """Whether a layer's cache entry is a cross layer's media K/V alone
    (``_cross_cache`` tags it): no ``kv``, no ``hist``."""
    return lc.get("cross", False)


def is_mla(lc: dict) -> bool:
    """Whether a layer's cache entry is an MLA layer's latent store
    (``_mla_cache`` tags it): its ``kv`` is a ``models.mla.MLACache``,
    contiguous on every engine, never a pool."""
    return lc.get("mla", False)


def is_pool(lc: dict) -> bool:
    """Whether a layer's cache entry holds a ParisKV store or pool (with
    its histograms on the paged layouts): not a ring, not a cross layer's
    media alone, not a mamba2 layer's SSM state alone, not an MLA latent.
    A whisper entry is one, with ``media_kv`` beside it, and a hymba
    entry, with ``ssm``."""
    return "kv" in lc and not is_ring(lc) and not is_mla(lc)


def pool_layers(cfg: ModelConfig) -> List[bool]:
    """Each layer, in layer order: whether its cache entry is a pool entry
    (``is_pool``), i.e. a ParisKV attention layer or a hybrid layer's
    attention half; the caches are built from this list, and a host pool
    names its entries from it."""
    return [ld.mixer in ("attn", "hybrid") and ld.use_pariskv
            for ld in layer_defs(cfg)]


def pool_entries(caches: List[dict]) -> List[dict]:
    """The ParisKV (global-layer) entries of ``caches``, in layer order:
    the contiguous stores or the pool with its histograms. Every walk
    over the pool (evictions, audits, staging, fetch statistics, host
    pool names) goes through this list."""
    return [lc for lc in caches if is_pool(lc)]


def _store(caches: List[dict]):
    """The first ParisKV store or pool: its shape gives n_max (contiguous)
    or the block size and KV heads (paged); None where there is none
    (mamba2, deepseek-v2)."""
    pool = pool_entries(caches)
    return pool[0]["kv"] if pool else None


def _contiguous_n_max(caches: List[dict], shards: int = 1) -> int:
    """The positions of contiguous caches, from the first ParisKV store or
    MLA latent (the reference's ``_cache_n_max``); 0 where there is none
    (mamba2: nothing retrieves). ``shards``: the ParisKV stores are
    sequence shards of that many ranks (``seq_shard_state``)."""
    for lc in caches:
        if is_pool(lc):
            return lc["kv"].k.shape[1] * shards
        if is_mla(lc):
            return lc["kv"].latent.shape[1]
    return 0


def _clone_tree(x):
    """A copy of a cache entry's tensors (dicts, tuples, NamedTuples)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [_clone_tree(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def seq_shard_state(state: ServeState, dist: SeqShardDist) -> ServeState:
    """Rank ``dist.rank``'s shard of a one-device contiguous ``ServeState``
    (``prefill``'s), as copies the rank updates in place: a ParisKV
    layer's store keeps its positions ``dist.rows(n_max)`` of ``k``,
    ``v`` and the three metadata arrays; everything else — ring buffers,
    media K/V, SSM state, MLA latents and the regions — stays whole on
    every rank, as the reference passes no sequence mesh to those layers
    (the counterpart of ``launch/mesh.py``'s rule that the retrieval
    region is sequence-sharded). Raises ``ValueError`` when n_max does
    not split into the shards."""
    caches = []
    for lc in state.caches:
        kv = lc.get("kv")
        if isinstance(kv, CC.LayerKVCache):
            base, n_loc = dist.rows(kv.k.shape[1])
            rows = slice(base, base + n_loc)
            kv = CC.LayerKVCache(kv.k[:, rows].clone(), kv.v[:, rows].clone(),
                                 *(m[:, :, rows].clone() for m in kv[2:]))
            lc = {**{k: _clone_tree(v) for k, v in lc.items() if k != "kv"},
                  "kv": kv}
        else:
            lc = _clone_tree(lc)
        caches.append(lc)
    return type(state)(caches, _clone_tree(state.regions))


class TierView(NamedTuple):
    """One decode chunk's view of the host-offloaded tier: the residency
    map (frozen for the chunk), the host block tables composed with it,
    each layer's host K/V rows (k, v) (num_blocks·block_size, G, hd), and
    the ``layers.SideStream`` of the overlapped winner gather (None: one
    stream), and the fetch policy ``fetch(name, kind) → (ok, retries,
    timeouts, stall seconds)`` (``HostKVPool.fetch_attempt``; None: every
    fetch succeeds) with each layer's entry name for it (``entry_names``).
    """
    dev_map: torch.Tensor
    kv_tables: torch.Tensor
    host_kv: list
    side: Any
    fetch: Any = None
    names: Optional[List[str]] = None

    def fetch_of(self, li: int, kind: str):
        """Layer ``li``'s fetch of ``kind`` as a zero-argument call, or
        None without a policy."""
        if self.fetch is None:
            return None
        return functools.partial(self.fetch, self.names[li], kind)


def _plan_places(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """Each model layer's (stage, layer within the stage's period), in
    layer order: the reference's way of naming a layer
    (``model.layer_places``)."""
    return [(si, i) for si, _, i in layer_places(cfg)]


def entry_names(cfg: ModelConfig) -> List[str]:
    """Each layer's cache-entry name as the reference gives it,
    ``s<stage>.l<layer in stage>`` (a stage's repeats share one): the
    ``name`` a ``fetch.gather`` fault sees, so one ``FaultPlan`` matches
    and logs the same visits on both sides."""
    return [f"s{si}.l{i}" for si, i in _plan_places(cfg)]


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


def _ring_cache(cfg: ModelConfig, ld: LayerDef, batch: int, n_max: int,
                device) -> dict:
    """A local layer's entry, tagged ``ring``: (k, v) ring tensors (batch,
    w, G, hd), w = min(window, n_max), every KV head (replicated on a
    head-sharded rank)."""
    shape = (batch, min(ld.attn.sliding_window, n_max), cfg.num_kv_heads,
             cfg.head_dim)
    return {"kv": tuple(torch.zeros(shape, dtype=torch_dtype(cfg),
                                    device=device) for _ in range(2)),
            "ring": True}


def media_len(cfg: ModelConfig) -> int:
    """The media tokens a request carries: llama-vision's patch
    embeddings, whisper's encoder frames (0 without cross attention)."""
    return {"vlm": cfg.num_media_tokens,
            "audio": cfg.encoder_seq}.get(cfg.family, 0)


def _media_kv(cfg: ModelConfig, batch: int, device):
    """Zero media K/V (k, v), each (batch, T, G, hd) in the config's
    dtype, every KV head (replicated on a head-sharded rank)."""
    shape = (batch, media_len(cfg), cfg.num_kv_heads, cfg.head_dim)
    return tuple(torch.zeros(shape, dtype=torch_dtype(cfg), device=device)
                 for _ in range(2))


def _cross_cache(cfg: ModelConfig, batch: int, device) -> dict:
    """A cross layer's entry, tagged ``cross``: its media K/V only."""
    return {"media_kv": _media_kv(cfg, batch, device), "cross": True}


def _mla_cache(cfg: ModelConfig, batch: int, n_max: int, device) -> dict:
    """An MLA layer's entry, tagged ``mla``: the latent store and its
    metadata (``models.mla.MLACache``, (batch, n_max, r + dr) in the
    config's dtype), contiguous on every engine."""
    return {"kv": MLA.init_mla_cache(batch, n_max, cfg, torch_dtype(cfg),
                                     device), "mla": True}


def _with_slot_local(cfg: ModelConfig, ld: LayerDef, entry: dict,
                     batch: int, device) -> dict:
    """``entry`` with a ``media_kv`` beside it when ``ld`` has a cross
    sublayer (whisper's decoder layers), an ``ssm`` state when it has an
    SSD mixer (mamba2, hymba)."""
    if ld.cross:
        entry["media_kv"] = _media_kv(cfg, batch, device)
    if ld.mixer in ("ssm", "hybrid"):
        entry["ssm"] = SSM.init_ssm_cache(batch, cfg, torch_dtype(cfg),
                                          device)
    return entry


def make_caches(cfg: ModelConfig, batch: int, n_max: int,
                device) -> List[dict]:
    """Contiguous per-layer caches (solo prefill): a ParisKV store per
    global layer (with the media K/V of its cross sublayer on whisper, the
    SSM state of a hybrid layer), a ring buffer per local layer, the media
    K/V of a cross layer, the SSM state of a mamba2 layer, the latent of
    an MLA layer."""
    dt = torch_dtype(cfg)
    out = []
    for ld, pooled in zip(layer_defs(cfg), pool_layers(cfg)):
        if ld.mixer == "mla":
            out.append(_mla_cache(cfg, batch, n_max, device))
        elif ld.mixer == "cross":
            out.append(_cross_cache(cfg, batch, device))
        elif ld.mixer == "ssm":
            out.append(_with_slot_local(cfg, ld, {}, batch, device))
        elif not pooled:
            out.append(_ring_cache(cfg, ld, batch, n_max, device))
        else:
            out.append(_with_slot_local(cfg, ld, {"kv": CC.init_layer_cache(
                batch, n_max, cfg.num_kv_heads, cfg.head_dim, cfg.pariskv,
                dt, device)}, batch, device))
    return out


class UnsupportedPagedConfig(NotImplementedError):
    """A config whose cache structure the paged or offloaded pool cannot
    serve, with the config's name and the offending ``stage``, ``layer``
    (within the stage's period) and ``mixer``, raised instead of a bare
    "not implemented" (the reference's message)."""

    def __init__(self, cfg: ModelConfig, stage: int, layer: int,
                 mixer: str, hint: str):
        self.config_name = getattr(cfg, "name", cfg.family)
        self.stage = stage
        self.layer = layer
        self.mixer = mixer
        super().__init__(
            f"config {self.config_name!r}: stage {stage} layer {layer} "
            f"uses mixer={mixer!r}, which the paged block pool does not "
            f"serve — {hint}")


def paged_refusal(cfg: ModelConfig) -> Optional[UnsupportedPagedConfig]:
    """The ``UnsupportedPagedConfig`` for a config the paged block pool
    cannot serve, or None: one with an MLA layer (its latent caches stay
    contiguous), or one with no ParisKV attention layer at all (mamba2:
    nothing to page), named by its first layer. The paged engines raise
    it at construction (``check_pageable``), ``make_paged_caches`` again;
    the offload and shard gates give its message as their reason."""
    place = _mla_place(cfg)
    if place is not None:
        return UnsupportedPagedConfig(
            cfg, *place, "mla",
            "MLA latent caches stay contiguous (ROADMAP); serve this config "
            "with the slot engine (ServingEngine) or an attention-mixer "
            "config")
    if not any(pool_layers(cfg)):
        return UnsupportedPagedConfig(
            cfg, 0, 0, layer_defs(cfg)[0].mixer,
            "no ParisKV attention layer to page; serve it with "
            "ServingEngine or WaveServingEngine")
    return None


def check_pageable(cfg: ModelConfig) -> None:
    """Raise ``paged_refusal(cfg)``, if there is one."""
    err = paged_refusal(cfg)
    if err is not None:
        raise err


# a tiered cache's host-side fetch statistics, reset with every chunk
_FETCH_HOST_ZERO = {"calls": 0, "retries": 0, "timeouts": 0, "stall": 0.0}


def make_paged_caches(cfg: ModelConfig, batch: int, num_blocks: int,
                      block_size: int, device,
                      num_device_blocks: Optional[int] = None,
                      dist=None, n_max: int = 0) -> List[dict]:
    """Per global layer: the shared block pool ``kv`` and the slot-local
    (batch, G, B, 2^m) int32 incremental bucket histogram ``hist``; per
    local layer a slot-local ring buffer of min(window, ``n_max``) slots
    (``make_caches``'s), not paged; the slot-local media K/V of a cross
    layer or sublayer and the SSM state of a hybrid layer
    (``make_caches``'s), not paged either. A config with no global layer
    raises ``UnsupportedPagedConfig`` (``check_pageable``). With ``dist``
    (a ``distributed.ShardDist``) the pool and the histograms hold that
    rank's G / N KV heads and the rings, media and SSM states every head:
    the counterpart of the reference's ``sharded_state_specs``, which
    partitions exactly the pool and histogram leaves and replicates the
    rest.

    ``num_device_blocks`` makes the pool tiered: metadata for all
    ``num_blocks`` blocks, K/V for a staging pool of ``num_device_blocks``
    (the full K/V lives in ``serving.offload.HostKVPool``), plus the
    ``fetch`` statistics of a chunk: ``touched`` (num_blocks,) int32
    winner references per host block, ``rows`` (batch, 5) int32 [winner
    rows, staging hits, host fetches, fill prefix rows read from host
    memory, degraded fetches (layer-steps whose misses were dropped)],
    ``uniq`` (2,) int64 distinct (row, kv head) pairs the tiered gathers
    read from host memory [winners, fill prefix], ``dropped`` (2,) int64
    the host rows that degraded fetches gave up [winner head rows, fill
    prefix rows] (counted in ``rows`` too), and host numbers:
    ``calls`` the tiered gathers issued, ``retries`` / ``timeouts`` /
    ``stall`` the fetch policy's re-issues, deadlines and seconds — all
    zeroed at each ``decode_chunk`` entry."""
    pcfg = cfg.pariskv
    dt = torch_dtype(cfg)
    G = cfg.num_kv_heads // (1 if dist is None else dist.shards)
    hist_shape = (batch, G, pcfg.num_subspaces(cfg.head_dim),
                  pcfg.num_centroids())
    nd = num_blocks if num_device_blocks is None else num_device_blocks
    check_pageable(cfg)
    out = []
    for ld, pooled in zip(layer_defs(cfg), pool_layers(cfg)):
        if ld.mixer == "cross":
            out.append(_cross_cache(cfg, batch, device))
            continue
        if not pooled:
            if n_max <= 0:
                raise ValueError(f"config {cfg.name!r}: a local layer's ring "
                                 f"buffer needs n_max")
            out.append(_ring_cache(cfg, ld, batch, n_max, device))
            continue
        entry = {
            "kv": CC.init_tiered_cache(num_blocks, nd, block_size, G,
                                       cfg.head_dim, pcfg, dt, device),
            "hist": torch.zeros(hist_shape, dtype=torch.int32,
                                device=device)}
        if num_device_blocks is not None:
            entry["fetch"] = {
                "touched": torch.zeros((num_blocks,), dtype=torch.int32,
                                       device=device),
                "rows": torch.zeros((batch, 5), dtype=torch.int32,
                                    device=device),
                "uniq": torch.zeros((2,), dtype=torch.int64, device=device),
                "dropped": torch.zeros((2,), dtype=torch.int64,
                                       device=device),
                **_FETCH_HOST_ZERO}
        out.append(_with_slot_local(cfg, ld, entry, batch, device))
    return out


def _mla_place(cfg: ModelConfig) -> Optional[Tuple[int, int]]:
    """(stage, layer within the stage's period) of the first MLA layer,
    or None."""
    for si, stage in enumerate(layer_plan(cfg)):
        for i, ld in enumerate(stage.layers):
            if ld.mixer == "mla":
                return si, i
    return None


def has_mla(cfg: ModelConfig) -> bool:
    """Whether the config has an MLA layer (deepseek-v2)."""
    return _mla_place(cfg) is not None


def offload_support_reason(cfg: ModelConfig) -> Optional[str]:
    """Why the tiered host-offloaded pool cannot serve this architecture,
    or None when it can: it pages exactly what ``make_paged_caches`` pages
    (ParisKV attention K/V), so MLA's latent caches are out (the
    reference's message) and so is a config with no ParisKV layer
    (``paged_refusal``'s message)."""
    place = _mla_place(cfg)
    if place is not None:
        return (f"config {cfg.name!r}: stage {place[0]} layer {place[1]} "
                f"mixer 'mla' keeps latent caches contiguous "
                f"(UnsupportedPagedConfig; ROADMAP)")
    err = paged_refusal(cfg)
    return None if err is None else str(err)


def fill_support_reason(cfg: ModelConfig) -> Optional[str]:
    """Why chunked prefill cannot serve this architecture, or None when it
    can: the media K/V of the cross-attention families come from one
    encoder pass over the whole prompt's media (the reference's message,
    checked first), and every mixer must be plain attention with no cross
    sublayer: an SSD recurrence (mamba2, hymba) has no chunk-resumable
    prefill. Layers are named as the reference names them, ``stage {si}
    layer {i}``."""
    if cfg.family in ("vlm", "audio"):
        return (f"config {cfg.name!r}: family {cfg.family!r} computes media "
                f"K/V in one encoder pass, so prompts prefill solo")
    for ld, (si, i) in zip(layer_defs(cfg), _plan_places(cfg)):
        if ld.mixer != "attn":
            return (f"config {cfg.name!r}: stage {si} layer {i} mixer "
                    f"{ld.mixer!r} has no chunk-resumable prefill "
                    f"(attention mixers only)")
        if ld.cross:
            return (f"config {cfg.name!r}: stage {si} layer {i} has a "
                    f"cross-attention sublayer, which reads encoder-pass "
                    f"media K/V")
    return None


def fill_supported(cfg: ModelConfig) -> bool:
    return fill_support_reason(cfg) is None


def share_support_reason(cfg: ModelConfig) -> Optional[str]:
    """Why block-granular prefix sharing cannot serve this architecture,
    or None when it can. A sharer maps cached pool blocks into its table
    and skips their fill, so every layer's prompt state must live in the
    shared pool: chunked prefill must be supported, and every attention
    layer must be a ParisKV layer (a sliding-window layer's ring buffer is
    slot-local, and a slot that skipped the prefix would find it empty).
    The message is the reference's."""
    reason = fill_support_reason(cfg)
    if reason is not None:
        return reason
    for ld, (si, li) in zip(layer_defs(cfg), _plan_places(cfg)):
        if not ld.use_pariskv:
            return (f"config {cfg.name!r}: stage {si} layer {li} caches its "
                    f"window in a slot-local ring buffer, which a shared "
                    f"prefix cannot populate (ParisKV-attention layers only)")
    return None


def share_supported(cfg: ModelConfig) -> bool:
    return share_support_reason(cfg) is None


class UnsupportedShardedConfig(NotImplementedError):
    """A config or option that head-sharded serving cannot run, with the
    config's name and the offending ``feature``, raised instead of falling
    back to one device."""

    def __init__(self, cfg: ModelConfig, feature: str, hint: str,
                 how: str = "head-sharded"):
        self.config_name = cfg.name
        self.feature = feature
        super().__init__(f"config {cfg.name!r}: {feature} cannot run "
                         f"{how} — {hint}")


def sharded_support_reason(cfg: ModelConfig) -> Optional[str]:
    """Why head-sharded paged serving cannot serve this architecture, or
    None when it can: the shards split the paged ParisKV pool on the KV
    head axis, so a cache the pool cannot hold is out: MLA's latent caches
    (the reference's message), and a config with no pool
    (``paged_refusal``'s message); slot-local state (rings, media, SSM) is
    replicated."""
    place = _mla_place(cfg)
    if place is not None:
        return (f"config {cfg.name!r}: stage {place[0]} layer {place[1]} "
                f"mixer 'mla' keeps latent caches contiguous — the mesh "
                f"shards the paged block pool only (ROADMAP)")
    err = paged_refusal(cfg)
    return None if err is None else str(err)


def sharded_supported(cfg: ModelConfig) -> bool:
    return sharded_support_reason(cfg) is None


def check_shard_heads(cfg: ModelConfig, shards: int) -> None:
    """The reference's first sharding check: ``shards`` ranks split whole
    KV heads."""
    if shards < 1 or cfg.num_kv_heads % shards:
        raise ValueError(
            f"mesh_shards={shards} must divide num_kv_heads="
            f"{cfg.num_kv_heads}: the ranks split whole KV heads, and an "
            f"uneven split would give them different pool shapes")


def check_paged_engine(cfg: ModelConfig, mesh_shards: int,
                       use_pariskv: bool, n_max: int,
                       block_size: int) -> None:
    """``PagedServingEngine``'s refusals of a configuration, in its order,
    all but the process group's (which needs the ranks): head sharding
    of an MLA config (the reference's refusal, before any paging check),
    a config the pool cannot page (``check_pageable``, which also covers
    every ``sharded_support_reason``), shards that do not split whole KV
    heads, the baseline, an ``n_max`` that is no whole number of blocks.
    The engine and the capacity planner (``launch.dryrun``) call it."""
    if mesh_shards > 1 and has_mla(cfg):
        check_shard_heads(cfg, mesh_shards)
        raise UnsupportedShardedConfig(cfg, f"mesh_shards={mesh_shards}",
                                       sharded_support_reason(cfg))
    check_pageable(cfg)
    if mesh_shards != 1:
        check_shard_heads(cfg, mesh_shards)
    if not use_pariskv:
        raise ValueError("the paged engine serves the ParisKV path only")
    if n_max % block_size != 0:
        raise ValueError(f"n_max={n_max} must be a multiple of "
                         f"block_size={block_size}")


def regions_init(batch: int, device) -> CC.CacheRegions:
    return CC.CacheRegions(
        pos=torch.full((batch,), -1, dtype=torch.int32, device=device),
        enc_end=torch.zeros((batch,), dtype=torch.int32, device=device))


# ----------------------------------------------------------------- FFN -----
def _ffn(p: dict, h: torch.Tensor, ld: LayerDef,
         cfg: ModelConfig) -> torch.Tensor:
    """The layer's FFN on its normed input: the MLP, or the mixture of
    experts — ``moe_decode`` on a decode step's rows h (b, d), free slots
    too, and ``moe_fwd`` on a (padded) prompt or fill chunk h (b, S, d),
    pad tokens too: capacity follows the padded token count and the batch,
    as in the reference."""
    if ld.ffn != "moe":
        return L.mlp_fwd(p["mlp"], h)
    if h.dim() == 2:
        return MOE.moe_decode(p["moe"], h, cfg.experts_per_token)
    return MOE.moe_fwd(p["moe"], h, cfg.experts_per_token)[0]


# ------------------------------------------------------------- prefill -----
def _ring_prefill(kv: Tuple[torch.Tensor, torch.Tensor],
                  k_new: torch.Tensor, v_new: torch.Tensor,
                  lengths: Optional[torch.Tensor]) -> None:
    """Fill a ring buffer (b, w, G, hd) from a LEFT-aligned padded prompt's
    k/v (b, S, G, hd), in place: slot j of row i takes the latest real
    position p < lengths[i] with p ≡ j (mod w), or zeros where there is
    none (masked at decode by position). ``lengths`` None: every row spans
    S."""
    w = kv[0].shape[1]
    b, S = k_new.shape[:2]
    dev = k_new.device
    if lengths is None:
        lengths = torch.full((b,), S, dtype=torch.int32, device=dev)
    last = (lengths.long() - 1)[:, None]                       # (b, 1)
    p_src = last - (last - torch.arange(w, device=dev)[None]) % w
    ok = (p_src >= 0)[..., None, None]
    rows = torch.arange(b, device=dev)[:, None]
    src = p_src.clamp(0, S - 1)
    for ring, new in zip(kv, (k_new, v_new)):
        ring.copy_(torch.where(ok, new[rows, src], 0).to(ring.dtype))


def _ring_prefix_pos(start: int, w: int, device) -> torch.Tensor:
    """(1, w) the position a fill's ring holds in each slot before the
    chunk at ``start``: the latest p < start with p ≡ slot (mod w), -1
    where there is none."""
    last = start - 1
    p_s = last - (last - torch.arange(w, device=device)) % w
    return torch.where(p_s >= 0, p_s, -1)[None]


def _cross_prefill(p: dict, h: torch.Tensor, media: torch.Tensor,
                   spec, cache: dict, dt: torch.dtype) -> torch.Tensor:
    """Cross attention of the prompt's normed states ``h`` over ``media``
    (b, T, d) float32; the media's K/V (float32 products, as the
    reference's) go to the entry's ``media_kv`` in the config's dtype
    ``dt``, which decode reads. → (b, S, d) float32."""
    kv = L.cross_kv(p, media, spec)
    cache["media_kv"] = tuple(t.to(dt) for t in kv)
    return L.attn_cross(p, h, media, spec, kv=kv)


def _layer_prefill(p: dict, x: torch.Tensor, ld: LayerDef, cfg: ModelConfig,
                   positions: torch.Tensor, cache: dict,
                   signs: torch.Tensor, lengths: Optional[torch.Tensor],
                   media: Optional[torch.Tensor] = None,
                   token_valid: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """One layer over the full prompt; fills this layer's cache (a ParisKV
    store, a local layer's ring, a cross layer's or sublayer's media K/V
    from ``media``, an SSD mixer's state and conv tail, an MLA latent and
    its metadata) in place.
    ``lengths`` (b,) / ``token_valid`` (b, S) describe LEFT-aligned rows:
    causal attention already hides a row's pad tail from its real tokens,
    the SSD recurrence skips the pads (dt = 0 there)."""
    dt = torch_dtype(cfg)
    h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
    if ld.mixer == "cross":
        y = _gate(p) * _cross_prefill(p["attn"], h, media, ld.attn, cache,
                                      dt)
    elif ld.mixer == "ssm":
        y, cache["ssm"] = SSM.ssm_prefill(p["ssm"], h, cfg,
                                          token_valid=token_valid,
                                          lengths=lengths)
    elif ld.mixer == "mla":              # as the reference: no lengths
        y = MLA.mla_train(p["attn"], h, cfg, positions)
        MLA.mla_prefill_cache(p["attn"], h, cache["kv"], cfg, positions,
                              signs)
    else:
        y, k_new, v_new = L.attn_prefill(p["attn"], h, ld.attn, positions)
        if is_ring(cache):
            _ring_prefill(cache["kv"], k_new, v_new, lengths)
        else:
            CC.prefill_write(cache["kv"], k_new, v_new, cfg.pariskv, signs,
                             lengths=lengths)
        if ld.mixer == "hybrid":
            ys, cache["ssm"] = SSM.ssm_prefill(p["ssm"], h, cfg,
                                               token_valid=token_valid,
                                               lengths=lengths)
            y = 0.5 * (y + ys)
    x = x + y.to(x.dtype)
    if ld.cross:
        h = L.rms_norm(x, p["norm_cross"], cfg.norm_eps)
        x = x + _cross_prefill(p["cross"], h, media, ld.attn, cache,
                               dt).to(x.dtype)
    if ld.ffn == "none":
        return x
    h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    return x + _ffn(p, h, ld, cfg).to(x.dtype)


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, tokens, n_max: int,
            lengths=None, device=None, media=None):
    """Process LEFT-aligned prompts ``tokens`` (b, S); returns the logits
    at each row's last real token (b, vocab) and a ServeState holding
    contiguous (b, n_max) caches. ``lengths`` (b,) are the true prompt
    lengths (default: all S). ``media`` (b, T, d) float32, each row's
    patch or frame embeddings, is required by the cross-attention
    families (whisper's rows first go through ``encoder_fwd``). Runs on
    the first CUDA card unless ``device="cpu"``."""
    dev = resolve_device(device)
    _check_params(params, dev)
    tokens = torch.as_tensor(tokens, device=dev)
    b, S = tokens.shape
    if media_len(cfg):
        if media is None:
            raise ValueError(f"config {cfg.name!r}: family {cfg.family!r} "
                             f"needs each request's media (b, T, d)")
        media = torch.as_tensor(media, dtype=torch.float32, device=dev)
        if cfg.family == "audio":
            media = encoder_fwd(params, cfg, media)
    signs = rotation_signs(cfg, dev)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=dev).expand(b, S)
    lens = valid = None
    if lengths is not None:
        lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        valid = torch.arange(S, device=dev)[None] < lens[:, None]
    caches = make_caches(cfg, b, n_max, dev)
    for ld, p, cache in zip(layer_defs(cfg), params["layers"], caches):
        x = _layer_prefill(p, x, ld, cfg, positions, cache, signs, lens,
                           media, valid)
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
                  host_kv=None, fetch=None, dist=None) -> torch.Tensor:
    """One layer of one decode step. ParisKV layers run the contiguous
    path (``block_tables`` None), the fused paged path, or the paged
    meta-view fallback (``paged_fused=False``) — on one rank's KV heads
    with ``dist``, or over a tiered pool when
    ``tier`` is given, with this layer's host rows ``host_kv``, its
    winner fetch under the policy ``fetch`` (``TierView.fetch_of``) and
    the step's fetch statistics added to the cache's ``fetch`` entry — then
    (when ``any_promote``) promote every triggered row's oldest
    ``update_interval`` window tokens — on the paged paths with the
    histogram maintained (a tiered pool gathers the keys through the
    composed staging tables). With a ``SeqShardDist`` the contiguous
    ParisKV stores are this rank's sequence shards: their layers append,
    retrieve (``attn_decode_pariskv(dist=)``) and promote shard-locally.
    ``use_pariskv=False`` is the full-attention
    baseline over the contiguous cache (no promotion). A local layer
    decodes densely over its ring buffer, a cross layer (and a whisper
    layer's cross sublayer, after its ParisKV attention) attends to the
    slot's media K/V, gated by tanh(cross_gate) on a cross layer: whole on
    every rank. An SSD mixer (a mamba2 layer, the SSM half of a hybrid
    layer, whose output is 0.5 · (attention + SSM)) advances every row's
    state and conv tail, whole on every rank. A hybrid layer's attention
    and an MLA layer (``models.mla.mla_decode``, over its contiguous
    latent) retrieve and promote in the baseline too
    (``use_pariskv=False``), as the reference's do: only plain attention
    layers turn dense."""
    pcfg = cfg.pariskv
    h = L.rms_norm(x_t, p["norm_attn"], cfg.norm_eps)
    kv = cache.get("kv")
    y = res = None
    if ld.mixer == "ssm":
        pass                             # no attention: the SSD mixer below
    elif ld.mixer == "mla":              # contiguous only; retrieves always
        y, res = MLA.mla_decode(p["attn"], h, kv, regions, cfg, signs,
                                num_candidates)
        if any_promote:
            MLA.mla_promote_rows(kv, regions.enc_end, will_promote, pcfg,
                                 signs)
    elif ld.mixer == "cross":
        y = _gate(p) * L.attn_cross_decode(p["attn"], h, cache["media_kv"],
                                           ld.attn)
    elif is_ring(cache):
        y = L.attn_decode_dense(p["attn"], h, kv, regions.pos + 1, ld.attn)
    elif not (use_pariskv and ld.use_pariskv) and ld.mixer != "hybrid":
        y = L.attn_decode_dense(p["attn"], h, (kv.k, kv.v), regions.pos + 1,
                                ld.attn)
    elif block_tables is None:
        y, res = L.attn_decode_pariskv(p["attn"], h, kv, regions, ld.attn,
                                       pcfg, signs, num_candidates, dist)
        if any_promote:
            CC.promote_rows(kv, regions.enc_end, will_promote, pcfg, signs,
                            shard=None if dist is None
                            else dist.shard_of(kv.k.shape[1]))
    elif tier is not None:
        f = cache["fetch"]
        y, res, delta = L.attn_decode_pariskv_tiered(
            p["attn"], h, kv, cache["hist"], block_tables, tier.kv_tables,
            tier.dev_map, *host_kv, regions, ld.attn, pcfg, signs,
            num_candidates, fused=paged_fused, append_index=append_index,
            side=tier.side, count=f["uniq"][0:1], fetch=fetch)
        if any_promote:
            with trace.span("cache.promote"):
                CC.paged_promote_rows_hist(kv, cache["hist"], block_tables,
                                           regions.enc_end, will_promote,
                                           pcfg, signs,
                                           kv_tables=tier.kv_tables)
        f["touched"] += delta["touched"]
        f["rows"][:, :3] += delta["rows"]
        if delta["degraded"] is not None:
            f["rows"][:, 4] += delta["degraded"].to(torch.int32)
            f["dropped"][0] += delta["rows"][:, 2].sum()
        for key in ("calls", "retries", "timeouts", "stall"):
            f[key] += delta[key]
    else:
        y, res = L.attn_decode_pariskv_paged_sharded(
            p["attn"], h, kv, cache["hist"], block_tables, regions, ld.attn,
            pcfg, signs, num_candidates, dist, fused=paged_fused,
            append_index=append_index)
        if any_promote:
            with trace.span("cache.promote"):
                CC.paged_promote_rows_hist(kv, cache["hist"], block_tables,
                                           regions.enc_end, will_promote,
                                           pcfg, signs)
    if record is not None and res is not None:
        record.append(res)
    if ld.mixer in ("ssm", "hybrid"):
        ys, cache["ssm"] = SSM.ssm_decode(p["ssm"], h, cache["ssm"], cfg)
        y = ys if y is None else 0.5 * (y + ys)
    x_t = x_t + y.to(x_t.dtype)
    if ld.cross:
        h = L.rms_norm(x_t, p["norm_cross"], cfg.norm_eps)
        x_t = x_t + L.attn_cross_decode(p["cross"], h, cache["media_kv"],
                                        ld.attn).to(x_t.dtype)
    if ld.ffn == "none":
        return x_t
    with trace.span("mlp"):
        h = L.rms_norm(x_t, p["norm_mlp"], cfg.norm_eps)
        return x_t + _ffn(p, h, ld, cfg).to(x_t.dtype)


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
    pref_staged: Optional[np.ndarray] = None  # tiered: (n,) block staged

    def staged_only(self):
        """A degraded chunk's prefix read (the host fetch gave up): the
        rows of unstaged blocks at -1 in both ``pref_rows`` (the gather
        reads no host row) and ``pref_pos`` (attention skips them).
        → (pref_rows, pref_pos)."""
        keep = torch.from_numpy(self.pref_staged).to(self.pref_pos.device)
        return (torch.where(keep, self.pref_rows, -1),
                torch.where(keep, self.pref_pos, -1))


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
                   pref_rows, host_rows,
                   np.repeat(kv_row[:n // bs] >= 0, bs))


def _layer_fill(p: dict, x_f: torch.Tensor, ld: LayerDef, cfg: ModelConfig,
                cache: dict, fctx: FillCtx, signs: torch.Tensor,
                use_pariskv: bool, tier: Optional[TierView] = None,
                host_kv=None, fetch=None, dist=None) -> torch.Tensor:
    """One layer of one prefill chunk of the filling slot: the prefix read
    (the slot's contiguous row, the paged gather's logical mode through
    its table row, or the tiered gather), chunk-causal attention over the
    prefix and the chunk, the chunk's K/V and metadata written, and on a
    paged pool the slot's histogram advanced (``paged_fill_hist_update``),
    so it stays exact mid-fill. A tiered pool adds the prefix's host rows
    to the chunk's ``fetch`` statistics and runs the prefix read under the
    fetch policy ``fetch`` first — in every chunk, the first one (no
    prefix yet) included, as the reference visits it; when the policy
    gives up, no host row is read and the host rows leave the prefix
    (``fill_keep``), and the slot's degraded count grows by one if the
    chunk needed any. With ``dist`` the chunk runs on the rank's KV heads
    (its pool's prefix, its heads' K/V and metadata written; the output
    heads gathered). Runs after the layer's decode:
    the filling row's dead decode append lands at the fill frontier, which
    the chunk overwrites (in a ring, at the slot of position start - w,
    which lies outside every chunk query's window).

    A local layer reads its prefix from the slot's ring by position
    (``_ring_prefix_pos``), attends within its window on every head (no
    fetch, no head split), and writes the chunk's last ``w`` valid tokens
    (a chunk longer than the ring keeps only each slot's last write)."""
    if ld.mixer != "attn" or ld.cross:
        raise NotImplementedError(fill_support_reason(cfg))
    pcfg = cfg.pariskv
    h = L.rms_norm(x_f, p["norm_attn"], cfg.norm_eps)
    kv = cache["kv"]
    slot, start, n = fctx.slot, fctx.start, fctx.valid_n
    if is_ring(cache):
        w = kv[0].shape[1]
        y, k_new, v_new = L.attn_fill_chunk(
            p["attn"], h, ld.attn, fctx.q_pos, kv[0][slot:slot + 1],
            kv[1][slot:slot + 1], _ring_prefix_pos(start, w, h.device),
            fctx.new_pos)
        t = torch.arange(max(0, n - w), n, device=h.device)
        for ring, new in zip(kv, (k_new, v_new)):
            ring[slot, (start + t) % w] = new[0, t].to(ring.dtype)
        x_f = x_f + y.to(x_f.dtype)
        h = L.rms_norm(x_f, p["norm_mlp"], cfg.norm_eps)
        return x_f + _ffn(p, h, ld, cfg).to(x_f.dtype)
    pref_pos = fctx.pref_pos
    ok = True
    if fetch is not None:                # tiered, under a fault plan
        f = cache["fetch"]
        ok, retries, timeouts, stall = fetch()
        f["retries"] += retries
        f["timeouts"] += timeouts
        f["stall"] += stall
        if not ok and fctx.host_rows:
            f["rows"][slot, 4] += 1
            f["dropped"][1] += fctx.host_rows
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
        rows = fctx.pref_rows
        if not ok and fctx.host_rows:
            rows, pref_pos = fctx.staged_only()
        k_h, v_h = gather_heads_tiered(kv.k, kv.v, *host_kv, tier.dev_map,
                                       rows, f["uniq"][1:2])
        k_pref, v_pref = (t[:, :, 0].transpose(1, 2) for t in (k_h, v_h))
        f["calls"] += 1
        if fctx.host_rows:
            f["rows"][slot, 3] += fctx.host_rows
    y, k_new, v_new = L.attn_fill_chunk_sharded(
        p["attn"], h, ld.attn, fctx.q_pos, k_pref, v_pref, pref_pos,
        fctx.new_pos, dist)
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
    return x_f + _ffn(p, h, ld, cfg).to(x_f.dtype)


# --------------------------------------------------------------- steps -----
def _check_seq_shard(cfg: ModelConfig, block_tables, use_pariskv: bool,
                     fill) -> None:
    """The decode a ``SeqShardDist`` can run: contiguous caches (the
    reference's refusal text for paged ones), the ParisKV path, no fill."""
    if block_tables is not None:
        raise ValueError(
            "paged decode takes dist=ShardedPagedDist (mesh head sharding "
            "under shard_map); the contiguous (mesh, seq_axes, batch_axes) "
            "tuple is for contiguous caches only")
    if not use_pariskv:
        raise UnsupportedShardedConfig(
            cfg, "the full-attention baseline (use_pariskv=False)",
            "a dense decode over a sequence-sharded cache would all-gather "
            "the cache or round apart from one device's; serve the "
            "baseline on one device (baselines/full_attention.py)",
            how="sequence-sharded")
    if fill is not None:
        raise NotImplementedError(
            "a mixed prefill+decode step (decode_fill_step) takes no "
            "sequence-sharded dist: chunked prefill runs on one device")


def _step(params: dict, cfg: ModelConfig, token: torch.Tensor,
          state: ServeState, block_tables: Optional[torch.Tensor],
          active: Optional[torch.Tensor], record: Optional[list],
          use_pariskv: bool, paged_fused: bool, tier: Optional[TierView],
          fill=None, dist=None):
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
    kv0 = _store(state.caches)
    seq = isinstance(dist, SeqShardDist)
    if seq:
        _check_seq_shard(cfg, block_tables, use_pariskv, fill)
    if block_tables is None:
        n_max = _contiguous_n_max(state.caches, dist.shards if seq else 1)
    else:
        if not use_pariskv:
            raise ValueError("paged decode serves the ParisKV path only")
        bs = kv0.k.shape[1]
        n_max = block_tables.shape[1] * bs
        with trace.span("sync.append_index"):
            append_index = CC.paged_append_index(
                block_tables if tier is None else tier.kv_tables,
                regions.pos + 1, bs)
    # host sync; hybrid and MLA layers promote in the baseline too
    # (_layer_decode)
    with trace.span("sync.promote"):
        any_promote = ((use_pariskv or any(ld.mixer in ("hybrid", "mla")
                                           for ld in layer_defs(cfg)))
                       and bool(will_promote.any()))
    num_candidates = pcfg.candidate_count(n_max)
    for li, (ld, p, cache) in enumerate(zip(layer_defs(cfg), params["layers"],
                                            state.caches)):
        host_kv = None if tier is None else tier.host_kv[li]
        with trace.span("layer", index=li):
            x_t = _layer_decode(p, x_t, ld, cfg, cache, regions, signs,
                                num_candidates, will_promote, any_promote,
                                block_tables, append_index, record,
                                use_pariskv, paged_fused, tier, host_kv,
                                None if tier is None else
                                tier.fetch_of(li, "heads"), dist)
            if x_f is not None:
                with trace.span("fill.layer"):
                    x_f = _layer_fill(p, x_f, ld, cfg, cache, fill[1], signs,
                                      use_pariskv, tier, host_kv,
                                      None if tier is None else
                                      tier.fetch_of(li, "rows"), dist)
    with trace.span("decode.unembed"):
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
                paged_fused: bool = True, tier: Optional[TierView] = None,
                dist=None):
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
    tests; with ``dist``, the rank's heads, or with a ``SeqShardDist`` the
    rank's ``layers.ShardRetrieval``). ``tier`` serves a tiered pool
    (``decode_chunk`` builds it); ``dist`` one rank's KV heads of a
    head-sharded paged pool (``distributed.ShardDist``), or one rank's
    sequence shard of the contiguous caches (``distributed.SeqShardDist``,
    the caches from ``seq_shard_state``: the reference's
    ``dist=(mesh, seq_axes, batch_axes)``); a sequence shard refuses paged
    caches and the full-attention baseline.

    Deciding "any row promotes" reads one bool back from the device; the
    paged paths also select the rows whose append block is allocated, once
    per step for all layers."""
    logits, _, new = _step(params, cfg, token, state, block_tables, active,
                           record, use_pariskv, paged_fused, tier, dist=dist)
    return logits, new


@torch.no_grad()
def decode_fill_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                     state: ServeState, fill_tokens: torch.Tensor,
                     fctx: FillCtx,
                     block_tables: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None,
                     use_pariskv: bool = True, paged_fused: bool = True,
                     tier: Optional[TierView] = None, dist=None):
    """One mixed prefill+decode step: ``decode_step``'s math for every row
    plus the chunk ``fill_tokens`` (1, P) of the filling slot ``fctx``,
    layer by layer after each layer's decode (the slot must be inactive in
    ``active``). → (decode logits (b, vocab), the filling slot's logits at
    its last valid chunk token (1, vocab), new state). The caller advances
    the fill and emits the first token when it completes."""
    return _step(params, cfg, token, state, block_tables, active, None,
                 use_pariskv, paged_fused, tier, fill=(fill_tokens, fctx),
                 dist=dist)


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
                          n_max: int = 0, prefill_budget: int = 0,
                          dist=None) -> SlotState:
    """Empty slot state over a shared block pool on ``device`` (the first
    CUDA card unless ``device="cpu"``); ``num_device_blocks`` makes the
    pool tiered and ``dist`` holds one rank's KV heads
    (``make_paged_caches``), local layers' rings span min(window,
    ``n_max``). Block tables are host-managed by the engine and passed to
    ``decode_chunk`` per call. ``prefill_budget`` > 0 adds the
    chunked-fill state, its prompt buffer ``n_max + P`` wide."""
    dev = resolve_device(device)
    return _zeros_slot_state(
        make_paged_caches(cfg, batch, num_blocks, block_size, dev,
                          num_device_blocks, dist, n_max), batch, dev, n_max,
        prefill_budget)


@torch.no_grad()
def decode_chunk(params: dict, cfg: ModelConfig, state: SlotState,
                 num_steps: int, block_tables: Optional[torch.Tensor] = None,
                 eos_id: Optional[int] = None, device=None,
                 nonfinite: Optional[torch.Tensor] = None,
                 use_pariskv: bool = True, paged_fused: bool = True,
                 dev_map=None, host_kv=None, side=None, fetch=None,
                 prefill_budget: int = 0, dist=None):
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
    ``fetch`` statistics restart at zero. ``fetch(name, kind)``, the host
    pool's ``fetch_attempt``, runs every host fetch under the fetch policy
    (``TierView``); None means every fetch succeeds.

    ``prefill_budget`` P > 0 (a state built with the same budget) makes a
    step with a filling slot a mixed step (``decode_fill_step``): the slot
    writes up to P more prompt tokens instead of decoding, and on the step
    its fill completes emits its first token, the argmax of the fill's
    logits, in that step's column. Its regions then stand at ``pos = f1 -
    1``, ``enc_end = fill_enc_end(f1)`` for frontier f1, so a completed
    fill lands on a solo prefill's ``initial_regions``.

    ``dist`` (a ``distributed.ShardDist``) runs the chunk on one rank of a
    head-sharded group over a resident paged state built with the same
    ``dist``; every rank runs the same chunk."""
    dev = resolve_device(device)
    _check_params(params, dev)
    if state.cur_tok.device.type != dev.type:
        raise ValueError(f"state lives on {state.cur_tok.device}, the call "
                         f"runs on {dev}")
    P = int(prefill_budget)
    if dist is not None and (block_tables is None or dev_map is not None):
        raise ValueError("a head-sharded chunk runs over a resident paged "
                         "pool only")
    if P > 0 and state.prompt is None:
        raise ValueError("prefill_budget > 0 needs a state built with the "
                         "same budget")
    with trace.span("decode.chunk"):
        bt_host = dm_host = None
        if block_tables is not None:
            if P > 0:
                bt_host = block_tables.cpu().numpy()
            with trace.span("sync.block_tables"):
                block_tables = block_tables.to(dev)
        tier = None
        if dev_map is not None:
            dev_map = torch.as_tensor(dev_map, dtype=torch.int32)
            if P > 0:
                dm_host = dev_map.cpu().numpy()
            with trace.span("sync.dev_map"):
                dev_map = dev_map.to(dev)
            tier = TierView(dev_map,
                            CC.tiered_kv_tables(block_tables, dev_map),
                            host_kv, side, fetch,
                            None if fetch is None else entry_names(cfg))
            for lc in pool_entries(state.caches):
                for key in ("touched", "rows", "uniq", "dropped"):
                    lc["fetch"][key].zero_()
                lc["fetch"].update(_FETCH_HOST_ZERO)
        kv0 = _store(state.caches)
        emitted = []
        for _ in range(num_steps):
            with trace.span("decode.step") as sp:
                active = state.remaining > 0
                fs = filling_slot(state) if P > 0 else None
                sp.set(mixed=fs is not None)
                if fs is None:
                    logits, new = decode_step(
                        params, cfg, state.cur_tok,
                        ServeState(state.caches, state.regions),
                        block_tables, active=active, use_pariskv=use_pariskv,
                        paged_fused=paged_fused, tier=tier, dist=dist)
                else:
                    with trace.span("sync.fill_mask"):
                        active[fs] = False
                    fctx = fill_ctx(state, fs, P, dev, bt_host, block_tables,
                                    kv0.k.shape[1], kv0.k.shape[2], dm_host)
                    logits, fill_logits, new = decode_fill_step(
                        params, cfg, state.cur_tok,
                        ServeState(state.caches, state.regions),
                        state.prompt[fs:fs + 1, fctx.start:fctx.start + P],
                        fctx, block_tables, active, use_pariskv, paged_fused,
                        tier, dist)
                with trace.span("decode.emit"):
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
                        with trace.span("sync.fill_regions"):
                            new.regions.pos[fs] = f1 - 1
                            new.regions.enc_end[fs] = CC.fill_enc_end(
                                f1, cfg.pariskv)
                        if f1 >= int(state.fill_len[fs]):
                            ftok = fill_logits[0].argmax(-1).to(torch.int32)
                            emit[fs] = ftok
                            cur[fs] = ftok
                            rem_f = rem[fs] - 1
                            if eos_id is not None:
                                rem_f = torch.where(ftok == eos_id, 0, rem_f)
                            rem[fs] = rem_f
                    emitted.append(emit)
                state = state._replace(caches=new.caches,
                                       regions=new.regions, cur_tok=cur,
                                       remaining=rem)
        return torch.stack(emitted, dim=1), state


def _admit_slot_local(lc: dict, lc1: dict, slot: int) -> None:
    """Copy a batch-1 prefill's media K/V and SSM state and conv tail, if
    the entry has them, into row ``slot`` whole (the media's length is the
    media's, not the prompt bucket's)."""
    for key in ("media_kv", "ssm"):
        if key in lc:
            for big, small in zip(lc[key], lc1[key]):
                big[slot] = small[0]


@torch.no_grad()
def admit_paged(state: SlotState, slot: int, phys_blocks: torch.Tensor,
                caches1: List[dict], regions1: CC.CacheRegions, tok0: int,
                rem: int, pcfg, scatter=CC.paged_scatter_prefill,
                dist=None) -> SlotState:
    """Install a solo (batch=1) prefill result into slot ``slot``, in
    place: pool blocks scatter to ``phys_blocks`` (n_max // block_size
    entries, sentinels >= num_blocks for unallocated ones) and the slot's
    histogram is computed from the prefilled metadata. ``scatter`` writes
    one layer's blocks (``admit_tiered`` passes the metadata-only one).
    With ``dist`` the prefill ran replicated, every head, while the pool
    holds the rank's heads: the rank scatters, and counts its histogram
    from, its heads' slice only. A local layer's ring is slot-local: the
    prefill's ring (every head) goes to the slot's row, into its first
    slots when a bucketed prefill's ring is shorter (its positions all lie
    below its length, so they sit where the longer ring keeps them). Media
    K/V (every head) and SSM states and conv tails go to the slot's row
    whole."""
    phys_blocks = phys_blocks.to(state.cur_tok.device)
    for lc, lc1 in zip(state.caches, caches1):
        _admit_slot_local(lc, lc1, slot)
        if not is_pool(lc):
            if is_ring(lc):
                for big, small in zip(lc["kv"], lc1["kv"]):
                    big[slot, :small.shape[1]] = small[0]
            continue
        kv1 = lc1["kv"] if dist is None else CC.head_slice(
            lc1["kv"], *dist.head_range(lc1["kv"].k.shape[2]))
        scatter(lc["kv"], kv1, phys_blocks)
        lc["hist"][slot] = CC.bucket_hist_from_meta(kv1.meta_ids, regions1,
                                                    pcfg)[0]
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
        _admit_slot_local(lc, lc1, slot)
        if "kv" in lc:
            for big, small in zip(lc["kv"], lc1["kv"]):
                big[slot] = small[0]
    state.regions.pos[slot] = regions1.pos[0]
    state.regions.enc_end[slot] = regions1.enc_end[0]
    state.cur_tok[slot] = tok0
    state.remaining[slot] = rem
    return state


@torch.no_grad()
def admit_fill(state: SlotState, slot: int, prompt_row, length: int,
               max_new: int, fill_start: Optional[int] = None,
               bt_row=None, pcfg=None) -> SlotState:
    """Admit a request for chunked prefill, in place: copy its prompt
    (``prompt_row``, padded to the buffer's width) to the slot's device
    buffer and arm its fill; no forward pass runs here, the mixed steps of
    ``decode_chunk`` consume the prompt. The slot opens at ``pos = -1``,
    ``enc_end = 0`` with a zero histogram on a paged pool (a re-admitted
    slot counts from an empty retrieval region).

    A shared-prefix admission passes ``fill_start`` f0, the end of the
    block-granular prefix the engine mapped into the slot's table row
    ``bt_row`` (nblk,) (-1 where unallocated), and ``pcfg``: the fill then
    writes only [f0, length), and the slot opens where a fill that had
    written the prefix itself would stand (``pos = f0 - 1``, ``enc_end =
    fill_enc_end(f0)``), its histogram rebuilt from the mapped blocks'
    metadata (``bucket_hist_from_paged_meta``, one launch per layer).
    ``fill_start=0`` is the unshared admission. f0 stays a host int, so
    the mixed steps still add no host synchronization."""
    f0 = enc0 = 0
    if fill_start is not None:
        if bt_row is None or pcfg is None:
            raise ValueError("a shared-prefix admission needs the slot's "
                             "block-table row and pcfg")
        f0 = int(fill_start)
        enc0 = CC.fill_enc_end(f0, pcfg)
        with trace.span("sync.bt_row"):        # one upload for every layer
            bt_row = torch.as_tensor(bt_row, dtype=torch.int32).to(
                state.prompt.device)
    for lc in state.caches:
        if "hist" in lc:
            lc["hist"][slot] = (0 if fill_start is None else
                                CC.bucket_hist_from_paged_meta(
                                    lc["kv"], bt_row, enc0, pcfg))
    with trace.span("sync.admit_regions"):  # each host scalar is a copy
        state.regions.pos[slot] = f0 - 1
        state.regions.enc_end[slot] = enc0
        state.cur_tok[slot] = 0
        state.remaining[slot] = max_new
    state.fill_pos[slot] = f0
    state.fill_len[slot] = length
    with trace.span("sync.prompt_row"):
        state.prompt[slot] = torch.as_tensor(prompt_row,
                                             dtype=torch.int32).to(
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
