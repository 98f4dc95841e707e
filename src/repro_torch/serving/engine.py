"""Serving engines (port of ``repro/serving/engine.py`` without prefix
sharing, fault handling and mesh sharding).

``ServingEngine`` is slot-based continuous batching over contiguous
per-slot caches of ``n_max`` positions: the stepwise loop — cancellations
→ admission → one decode chunk → collection/eviction — with honest
per-request timing: ``ttft_s`` runs from admission (the request leaves the
queue) to its first token on the host, ``decode_s`` from the first token
to the end of the chunk in which the request finished, and ``token_times``
stamps each token with the chunk boundary at which it became host-visible.
A queued request is prefilled solo (batch 1, LEFT-aligned, padded to a
power-of-two bucket capped at ``n_max``) and copied into its slot.
``use_pariskv=False`` serves the full-attention baseline.

With ``prefill_budget=P > 0`` (chunked prefill) admission only copies the
prompt to the slot's device buffer (at most one slot fills at a time) and
the decode chunk prefills it: each mixed step runs P prompt tokens of the
filling slot beside one decode token of every other active slot, so an
admitted prompt no longer stalls the decoding slots for a whole solo
prefill. The slot emits its first token the step its fill completes; its
``ttft_s`` runs from admission to the end of that chunk.

``PagedServingEngine`` runs the same loop over one global pool of
``num_blocks × block_size`` token blocks shared by all ``max_batch``
slots:

* admission needs ``⌈(prompt + gen) / block_size⌉`` unreserved blocks
  (worst-case reservation, FIFO backpressure: the head of the queue waits);
* a queued request is prefilled solo (batch 1, LEFT-aligned, padded to a
  power-of-two bucket capped at ``n_max``) and its cache scattered into
  the pool, or chunk-filled through its block table (``prefill_budget``);
  the prompt's blocks are taken at admission, later blocks lazily before
  the chunk whose appends reach them;
* a finished or cancelled slot's blocks and histogram row are zeroed and
  its blocks return to the free list.

Its decode runs the fused retrieval path, or with ``fused=False`` the
meta-view fallback (token-identical). ``offload=True`` returns an
``OffloadedPagedServingEngine``: the K/V pool lives in (pinned) host
memory and the device keeps the metadata and a bounded staging pool.

``WaveServingEngine`` is the legacy lockstep baseline: each wave of up to
``max_batch`` requests is prefilled as one right-aligned batch (the pad
zeros are real tokens to attention, as in the reference) and decoded
together to the wave's longest generation.

Every stage that was a Pallas kernel on the TPU runs a Hopper kernel on
the card. Options that are not ported yet raise ``NotImplementedError``
naming the ROADMAP item that will port them.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import cache as CC
from repro_torch.core.config import ModelConfig
from repro_torch.models import serve as SV
from repro_torch.models.layers import SideStream
from repro_torch.models.model import param_device, torch_dtype
from repro_torch.serving import offload as offload_lib


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (s,) int32
    max_new_tokens: int = 32
    # filled by the engine:
    output: Optional[np.ndarray] = None
    ttft_s: float = 0.0             # admission → first token (per request)
    decode_s: float = 0.0           # first token → completion (per request)
    cancelled: bool = False
    token_times: Optional[list] = None   # host-visibility time per token
    promotions: int = 0             # sliding-window promotions of its slot
    # offloaded engine only (OffloadedPagedServingEngine's docstring):
    staging_hits: int = 0
    staging_misses: int = 0
    fetched_bytes: int = 0
    fetched_unique_bytes: int = 0
    prefetched_blocks: int = 0
    prefetch_hits: int = 0
    fetch_stall_s: float = 0.0
    fetch_callbacks: int = 0
    # engine-internal:
    _tokens: Optional[list] = None
    _t_admit: float = 0.0
    _t_first: float = 0.0


def _bucket(n: int, floor: int = 8, cap: Optional[int] = None) -> int:
    """Smallest power of two ≥ max(n, floor), clamped to ``cap`` (the clamp
    applies before the doubling, so the loop never overshoots the cap)."""
    if cap is not None and n >= cap:
        return cap
    b = floor if cap is None else min(floor, cap)
    while b < n:
        b *= 2
    return b if cap is None else min(b, cap)


def _solo_prefill(params, cfg: ModelConfig, req: Request, cap: int,
                  device):
    """Solo (batch=1) prefill of a request's prompt, LEFT-aligned and
    padded to a power-of-two bucket capped at ``cap``, into caches of
    ``cap`` positions. → (state1, tok0)."""
    s = _bucket(len(req.prompt), cap=cap)
    toks = np.zeros((1, s), np.int32)
    toks[0, :len(req.prompt)] = req.prompt
    logits, state1 = SV.prefill(params, cfg, toks, cap,
                                lengths=[len(req.prompt)], device=device)
    return state1, int(logits[0].argmax(-1))     # blocks: first token


def _collect_chunk_row(req: Request, row: np.ndarray, t_now: float) -> int:
    """Append a slot's valid chunk emissions (the contiguous non-negative
    run; -1 marks steps the slot did not emit) to the request, stamped
    with ``t_now``. Returns the number of tokens emitted this chunk."""
    nonneg = np.flatnonzero(row >= 0)
    if nonneg.size == 0:
        return 0
    tail = row[nonneg[0]:]
    n_emit = int(np.argmax(tail < 0)) if (tail < 0).any() else len(tail)
    req._tokens.extend(tail[:n_emit].tolist())
    req.token_times.extend([t_now] * n_emit)
    return n_emit


def _finalize_output(req: Request, eos_id: Optional[int],
                     t_now: float) -> None:
    """Clip to max_new_tokens, truncate at the first eos, set decode time."""
    out = np.asarray(req._tokens[:req.max_new_tokens], np.int32)
    if eos_id is not None and eos_id in out:
        out = out[:int(np.argmax(out == eos_id)) + 1]
    req.output = out
    req.token_times = req.token_times[:len(out)]
    req.decode_s = t_now - req._t_first


def _not_ported(engine: str, options) -> None:
    for flag, value, default, item in options:
        if value != default:
            raise NotImplementedError(
                f"{engine}({flag}={value!r}) is not ported yet: ROADMAP "
                f"{item}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    """Slot-based continuous batching over contiguous per-slot caches (see
    module docstring). Runs on the first CUDA card unless
    ``device="cpu"``; ``params`` must live there. ``PagedServingEngine``
    overrides the device state and the paging hooks."""

    def __init__(self, cfg: ModelConfig, params, n_max: int = 4096,
                 max_batch: int = 8, greedy: bool = True,
                 use_pariskv: bool = True, chunk_size: int = 8,
                 eos_id: Optional[int] = None, prefill_budget: int = 0,
                 faults=None, device=None):
        if not greedy:
            raise ValueError("sampling is on-device argmax; greedy only")
        _not_ported(type(self).__name__, (
            ("faults", faults, None, "A10 (fault handling)"),))
        if prefill_budget and not SV.fill_supported(cfg):
            raise ValueError(f"chunked prefill (prefill_budget="
                             f"{prefill_budget}) unavailable — "
                             f"{SV.fill_support_reason(cfg)}; use "
                             f"prefill_budget=0")
        self.device = resolve_device(device)
        if param_device(params).type != self.device.type:
            raise ValueError(f"params live on {param_device(params)}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.n_max = n_max
        self.max_batch = max_batch
        self.use_pariskv = use_pariskv
        self.chunk_size = chunk_size
        self.eos_id = eos_id
        self.prefill_budget = prefill_budget
        self.queue: List[Request] = []
        self.peak_concurrency = 0   # max slots simultaneously decoding
        self.decode_steps = 0       # decode steps run (chunks × chunk_size)
        self.nonfinite_logits = None  # device count of NaN/inf logits
        self._state = None
        self._slots: List[Optional[Request]] = []
        self._done: List[Request] = []
        self._cancelled: set = set()
        self._filling: Optional[int] = None      # slot chunk-filling now
        self._enc: Dict[int, int] = {}           # slot → host view of enc_end
        self._enc_after = np.zeros((max_batch,), np.int64)

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.n_max:
            raise ValueError(
                f"request {req.uid}: prompt {len(req.prompt)} + "
                f"{req.max_new_tokens} new tokens exceeds n_max={self.n_max}")
        self.queue.append(req)

    def cancel(self, uid: int) -> None:
        """Evict request ``uid`` at the next chunk boundary (queued → drop;
        in flight → slot and cache reclaimed, partial output kept)."""
        self._cancelled.add(uid)

    def start(self) -> None:
        """(Re)initialize the serving loop state; pair with step_serve()."""
        self._state = self._init_state()
        self.nonfinite_logits = torch.zeros((), dtype=torch.int64,
                                            device=self.device)
        self._slots = [None] * self.max_batch
        self._done = []
        self._filling = None
        # uids are per run: keep only cancels aimed at the current queue
        self._cancelled &= {r.uid for r in self.queue}

    def pending(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self._slots)

    # -- device state and hooks (the paged engine overrides) ----------------
    def _init_state(self) -> SV.SlotState:
        return SV.init_slot_state(self.cfg, self.max_batch, self.n_max,
                                  device=self.device,
                                  prefill_budget=self.prefill_budget)

    def _can_admit(self) -> bool:
        return True

    def _pre_admit(self, slot: int, req: Request) -> None:
        """Reserve engine resources for an admission (paged: blocks)."""

    def _abort_admit(self, slot: int) -> None:
        """Undo _pre_admit for a request that finished at prefill."""

    def _install_solo(self, slot: int, req: Request, state1, tok0) -> None:
        self._state = SV.admit_slot(
            self._state, slot, state1.caches, state1.regions, tok0,
            req.max_new_tokens - 1)
        self._enc[slot] = int(state1.regions.enc_end[0])

    def _pre_chunk_slot(self, slot: int, req: Request) -> None:
        """Per-slot host work before a chunk (paged: lazy allocation)."""

    def _solo_cap(self, plen: int) -> int:
        """Capacity of a solo prefill (the offloaded engine buckets it)."""
        return self.n_max

    def _decode_chunk(self, block_tables=None, paged_fused: bool = True,
                      **tier):
        tokens, self._state = SV.decode_chunk(
            self.params, self.cfg, self._state, self.chunk_size,
            block_tables, eos_id=self.eos_id, device=self.device,
            nonfinite=self.nonfinite_logits, use_pariskv=self.use_pariskv,
            paged_fused=paged_fused, prefill_budget=self.prefill_budget,
            **tier)
        self._enc_after = self._state.regions.enc_end.cpu().numpy()
        return tokens.cpu().numpy(), self._state.remaining.cpu().numpy()

    def _run_chunk(self):
        return self._decode_chunk()

    def _release_slot(self, slot: int) -> None:
        """Reclaim a finished slot's resources (paged: blocks)."""
        self._enc.pop(slot, None)

    def _evict_device(self, slot: int) -> None:
        self._state = SV.cancel_slot(self._state, slot)
        self._enc.pop(slot, None)

    def _fill_complete(self, slot: int, req: Request) -> None:
        """A chunked fill just finished: the slot's prompt is fully
        written (prefix sharing, ROADMAP A8, would register its blocks)."""

    def _after_collect(self, slot: int, req: Request) -> None:
        """Count the slot's sliding-window promotions from its enc_end (a
        fill moves enc_end without promoting: not while filling)."""
        if slot == self._filling:
            return
        enc = int(self._enc_after[slot])
        req.promotions += (enc - self._enc[slot]) // \
            self.cfg.pariskv.update_interval
        self._enc[slot] = enc

    # -- loop phases ----------------------------------------------------------
    def _finish_request(self, req: Request, t_now: float) -> None:
        _finalize_output(req, self.eos_id, t_now)
        self._done.append(req)

    def _process_cancellations(self) -> None:
        if not self._cancelled:
            return
        t_now = time.perf_counter()
        for req in [r for r in self.queue if r.uid in self._cancelled]:
            self.queue.remove(req)
            req.cancelled = True
            req._tokens, req.token_times = [], []
            req._t_first = req._t_admit = t_now
            self._finish_request(req, t_now)
        for slot, req in enumerate(self._slots):
            if req is None or req.uid not in self._cancelled:
                continue
            req.cancelled = True
            self._evict_device(slot)
            self._finish_request(req, t_now)
            self._slots[slot] = None
            if self._filling == slot:
                self._filling = None
        self._cancelled.clear()

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self._slots[slot] is not None or not self.queue:
                continue
            if not self._can_admit():
                break                        # backpressure: head waits
            if self.prefill_budget:
                if self._filling is not None:
                    break                    # at most one filling slot
                req = self.queue.pop(0)
                self._pre_admit(slot, req)
                self._admit_chunked(slot, req)
                continue
            req = self.queue.pop(0)
            t_admit = time.perf_counter()
            self._pre_admit(slot, req)
            state1, tok0 = _solo_prefill(self.params, self.cfg, req,
                                         self._solo_cap(len(req.prompt)),
                                         self.device)
            t_first = time.perf_counter()
            req.ttft_s = t_first - t_admit
            req._t_admit, req._t_first = t_admit, t_first
            req._tokens, req.token_times = [tok0], [t_first]
            if req.max_new_tokens <= 1 or tok0 == self.eos_id:
                req.output = np.asarray(req._tokens, np.int32)
                req.decode_s = 0.0
                self._done.append(req)
                self._abort_admit(slot)
                continue
            self._install_solo(slot, req, state1, tok0)
            self._slots[slot] = req

    def _admit_chunked(self, slot: int, req: Request) -> None:
        """Chunked-prefill admission: copy the prompt to the slot's device
        buffer and arm its fill; the decode chunks do the work."""
        req._t_admit = time.perf_counter()
        req._tokens, req.token_times = [], []
        prow = np.zeros((self.n_max + self.prefill_budget,), np.int32)
        prow[:len(req.prompt)] = req.prompt
        self._state = SV.admit_fill(self._state, slot, prow, len(req.prompt),
                                    req.max_new_tokens)
        self._enc[slot] = CC.fill_enc_end(len(req.prompt), self.cfg.pariskv)
        self._slots[slot] = req
        self._filling = slot

    def _collect(self, tokens: np.ndarray, rem_after: np.ndarray) -> None:
        t_now = time.perf_counter()
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            had = len(req._tokens)
            n_emit = _collect_chunk_row(req, tokens[slot], t_now)
            if had == 0 and n_emit > 0:          # a chunked fill completed
                req.ttft_s = t_now - req._t_admit
                req._t_first = t_now
                if self._filling == slot:
                    self._filling = None
                    self._fill_complete(slot, req)
            self._after_collect(slot, req)
            if rem_after[slot] <= 0:
                self._finish_request(req, t_now)
                self._slots[slot] = None
                self._release_slot(slot)
                if self._filling == slot:        # eos on the first token
                    self._filling = None

    def step_serve(self) -> None:
        """One serving round: cancellations → admission → one decode chunk
        → collection/eviction."""
        self._process_cancellations()
        self._admit()
        self.peak_concurrency = max(
            self.peak_concurrency, sum(r is not None for r in self._slots))
        if all(r is None for r in self._slots):
            return      # everything finished at prefill; maybe more queued
        for slot, req in enumerate(self._slots):
            if req is not None:
                self._pre_chunk_slot(slot, req)
        tokens, rem_after = self._run_chunk()
        self.decode_steps += self.chunk_size
        self._collect(tokens, rem_after)

    def run(self) -> List[Request]:
        """Serve everything in the queue; returns completed requests."""
        self.start()
        while self.pending():
            self.step_serve()
        return self._done

    def close(self) -> None:
        """Release engine-owned resources (none are held on this path)."""

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class PagedServingEngine(ServingEngine):
    """Continuous batching over a paged KV pool (see module docstring).

    ``block_size`` tokens per block (``n_max`` must be a multiple);
    ``num_blocks`` defaults to ``max_batch * n_max // block_size``, the
    contiguous engine's footprint. Runs on the first CUDA card unless
    ``device="cpu"``; ``params`` must live there. ``offload=True``
    constructs an ``OffloadedPagedServingEngine``."""

    def __new__(cls, *args, **kwargs):
        if cls is PagedServingEngine and kwargs.get("offload"):
            return super().__new__(OffloadedPagedServingEngine)
        return super().__new__(cls)

    def __init__(self, cfg: ModelConfig, params, n_max: int = 4096,
                 max_batch: int = 8, block_size: int = CC.PAGED_DEFAULT_BLOCK,
                 num_blocks: Optional[int] = None, greedy: bool = True,
                 use_pariskv: bool = True, chunk_size: int = 8,
                 eos_id: Optional[int] = None, fused: bool = True,
                 prefill_budget: int = 0, offload: bool = False,
                 share_prefixes: bool = False, mesh_shards: int = 1,
                 faults=None, device=None):
        _not_ported("PagedServingEngine", (
            ("share_prefixes", share_prefixes, False, "A8 (prefix sharing)"),
            ("faults", faults, None, "A10 (fault handling)"),
            ("mesh_shards", mesh_shards, 1,
             "A11 (head-sharded multi-GPU serving)")))
        if not use_pariskv:
            raise ValueError("the paged engine serves the ParisKV path only")
        if n_max % block_size != 0:
            raise ValueError(f"n_max={n_max} must be a multiple of "
                             f"block_size={block_size}")
        super().__init__(cfg, params, n_max=n_max, max_batch=max_batch,
                         greedy=greedy, chunk_size=chunk_size,
                         eos_id=eos_id, prefill_budget=prefill_budget,
                         device=device)
        self.fused = fused
        self.block_size = block_size
        self.nblk = n_max // block_size
        self.num_blocks = (max_batch * self.nblk if num_blocks is None
                           else num_blocks)
        self._free: Deque[int] = collections.deque(range(self.num_blocks))
        self._alloc: Dict[int, List[int]] = {}   # slot → physical blocks
        self._resv: Dict[int, int] = {}          # slot → unallocated reserve
        self._pos: Dict[int, int] = {}           # slot → host view of pos
        self._need: Dict[int, int] = {}          # slot → total token budget
        self._bt = np.full((max_batch, self.nblk), -1, np.int32)

    # ------------------------------------------------------------ helpers --
    def blocks_needed(self, req: Request) -> int:
        return -(-(len(req.prompt) + req.max_new_tokens) // self.block_size)

    @property
    def free_blocks(self) -> int:
        """Blocks neither allocated nor reserved — admission headroom."""
        return len(self._free) - sum(self._resv.values())

    def submit(self, req: Request) -> None:
        super().submit(req)
        if self.blocks_needed(req) > self.num_blocks:
            self.queue.pop()
            raise ValueError(
                f"request {req.uid}: needs {self.blocks_needed(req)} blocks, "
                f"pool holds {self.num_blocks} — request can never run")

    def _take_block(self, slot: int) -> None:
        blk = self._free.popleft()
        self._bt[slot, len(self._alloc[slot])] = blk
        self._alloc[slot].append(blk)
        self._resv[slot] -= 1

    def _ensure_blocks(self, slot: int) -> None:
        """Lazy allocation: before a chunk, give ``slot`` every block its
        appends can reach (positions ≤ pos + chunk_size), capped by its
        admission-time reservation."""
        upto = min(self._pos[slot] + 1 + self.chunk_size, self._need[slot])
        nb = min(-(-upto // self.block_size),
                 len(self._alloc[slot]) + self._resv[slot])
        while len(self._alloc[slot]) < nb:
            self._take_block(slot)

    def _phys_row(self, blocks) -> torch.Tensor:
        """(nblk,) physical ids padded with out-of-range sentinels
        (num_blocks), which the pool writes skip."""
        phys = np.full((self.nblk,), self.num_blocks, np.int32)
        phys[:len(blocks)] = blocks
        return torch.from_numpy(phys)

    def _reserve_blocks(self, slot: int, req: Request) -> None:
        """Worst-case reservation plus the prompt's blocks up front (the
        solo prefill writes the whole prompt in one scatter, a chunked
        fill writes through the table from its first step). While a slot
        fills, its host ``_pos`` stays at the prompt's end."""
        self._alloc[slot] = []
        self._resv[slot] = self.blocks_needed(req)
        self._pos[slot] = len(req.prompt) - 1
        self._need[slot] = len(req.prompt) + req.max_new_tokens
        for _ in range(-(-len(req.prompt) // self.block_size)):
            self._take_block(slot)

    def _release_host(self, slot: int) -> None:
        self._free.extend(self._alloc.pop(slot, ()))
        for d in (self._resv, self._pos, self._need, self._enc):
            d.pop(slot, None)
        self._bt[slot] = -1

    def _clear_device(self, slot: int) -> None:
        """Zero the slot's pool blocks and histogram row (reclaimed blocks
        must not leak a tenant's K/V; a free slot's histogram is zero
        until the next admission computes it)."""
        phys = self._phys_row(self._alloc.get(slot, ())).to(self.device)
        for lc in self._state.caches:
            CC.paged_clear_blocks(lc["kv"], phys)
            lc["hist"][slot] = 0

    # ------------------------------------------- loop phases (overrides) ----
    def _init_state(self) -> SV.SlotState:
        return SV.init_paged_slot_state(self.cfg, self.max_batch,
                                        self.num_blocks, self.block_size,
                                        device=self.device, n_max=self.n_max,
                                        prefill_budget=self.prefill_budget)

    def _evict_device(self, slot: int) -> None:
        self._state = SV.cancel_slot(self._state, slot)
        self._clear_device(slot)
        self._release_host(slot)

    def _can_admit(self) -> bool:
        return self.blocks_needed(self.queue[0]) <= self.free_blocks

    def _pre_admit(self, slot: int, req: Request) -> None:
        self._reserve_blocks(slot, req)

    def _abort_admit(self, slot: int) -> None:
        self._release_host(slot)       # pool untouched: host-only

    def _install_solo(self, slot: int, req: Request, state1, tok0) -> None:
        self._state = SV.admit_paged(
            self._state, slot, self._phys_row(self._alloc[slot]),
            state1.caches, state1.regions, tok0, req.max_new_tokens - 1,
            self.cfg.pariskv)
        self._enc[slot] = int(state1.regions.enc_end[0])

    def _pre_chunk_slot(self, slot: int, req: Request) -> None:
        self._ensure_blocks(slot)

    def _run_chunk(self):
        return self._decode_chunk(torch.from_numpy(self._bt),
                                  paged_fused=self.fused)

    def _after_collect(self, slot: int, req: Request) -> None:
        # host view of the device pos: last prompt token + decoded tokens
        self._pos[slot] = len(req.prompt) - 1 + max(0, len(req._tokens) - 1)
        super()._after_collect(slot, req)

    def _release_slot(self, slot: int) -> None:
        self._clear_device(slot)
        self._release_host(slot)

    # -------------------------------------------------------------- audit --
    def verify_hist(self) -> None:
        """Raise AssertionError unless every active slot's incremental
        histogram equals a recompute from the pool's centroid ids over
        [sink, enc_end), in every layer."""
        pcfg = self.cfg.pariskv
        slots = [s for s, r in enumerate(self._slots) if r is not None]
        if not slots:
            return
        bt = torch.from_numpy(self._bt[slots]).to(self.device)
        sel = torch.tensor(slots, device=self.device)
        regions = CC.CacheRegions(pos=self._state.regions.pos[sel],
                                  enc_end=self._state.regions.enc_end[sel])
        for li, lc in enumerate(self._state.caches):
            ids = CC.paged_ids_view(lc["kv"], bt)
            want = CC.bucket_hist_from_meta(ids, regions, pcfg)
            if not torch.equal(lc["hist"][sel], want):
                raise AssertionError(
                    f"layer {li}: incremental histogram != recompute for "
                    f"slots {slots}")


class OffloadedPagedServingEngine(PagedServingEngine):
    """Paged serving over the tiered host-offloaded pool (what
    ``PagedServingEngine(offload=True)`` returns).

    The device keeps all retrieval metadata (ids, codes, weights and the
    per-slot bucket histograms) and a staging pool of
    ``num_device_blocks`` K/V blocks (default ``num_blocks // 4``); the
    full K/V pool lives in host memory (``serving.offload.HostKVPool``),
    pinned on a card. Each decode step runs Stage I/II exactly as the
    resident engine; one kernel launch per layer then reads the staged
    winners from HBM and the missed ones from pinned host memory over
    PCIe (``kernels/gather_kv:gather_heads_tiered``). A winner's bytes are
    the same on either tier, so the tokens are the resident engine's.

    Residency changes only at chunk boundaries:

    * every block a chunk writes or reads densely (sink, local window,
      append or fill frontier) is pinned staged; a required block not
      staged is copied in before the chunk;
    * ``prefetch=True`` also stages the previous chunks' most-touched
      winner blocks (exponential decay 0.5); ``prefetch_hook(touched, k)``
      overrides the predictor (a wrong hook costs bytes, not tokens);
    * staging slots recycle by a second-chance clock over unpinned
      blocks; an evicted block is written back to the host pool first.

    Admission prefills solo at the prompt's bucketed capacity
    (``_solo_cap``, not ``n_max``), writes the prompt's K/V to the host
    pool and scatters only metadata and the histogram to the device. A
    chunked fill (``prefill_budget``) writes K/V into the pinned staging
    blocks of its frontier and metadata into the pool, and reads its
    prefix through the tiered gather: staged blocks from staging, the
    others from host memory (written back there when they left staging).
    Eviction and ``cancel(uid)`` reclaim both tiers: host blocks zeroed,
    staging slots freed without write-back.

    ``overlap=True`` (on a card) runs each layer's winner gather on a side
    stream while the main stream gathers and scores the sink and window;
    ``overlap=False`` runs all of it on one stream. Tokens are identical.

    Per-request statistics on ``Request``:

    * ``staging_hits`` / ``staging_misses``: winner head rows (inside the
      retrieval region) served from staging / from host memory;
      ``fetched_bytes``: the misses' K+V bytes plus the K+V bytes of the
      fill prefix rows read from host memory; ``prefetched_blocks`` /
      ``prefetch_hits``: blocks staged by the predictor for the request,
      and those a winner then touched. These equal the reference's.
    * ``fetched_unique_bytes``: the host bytes the tiered gathers read: a
      gather reads each distinct missed (row, kv head) once, so repeated
      winners count once (distinct head rows times their K+V bytes, and
      distinct fill rows times a full row's). Counted per chunk and shared
      among the requests in proportion to their host fetches, as the
      reference shares its deduplicated bytes; equal to the reference's.
    * ``fetch_callbacks``: the tiered gathers (kernel launches on a card)
      of the chunks the request decoded in, shared among the requests in
      proportion to their host fetches (evenly when none fetched), as the
      reference shares its host callbacks.
    * ``fetch_stall_s``: host seconds spent waiting for a fetch: always 0,
      since the misses are read by the device inside the decode step and
      the host never waits for one (their time is the kernel's).
    """

    def __init__(self, cfg: ModelConfig, params, n_max: int = 4096,
                 max_batch: int = 8, block_size: int = CC.PAGED_DEFAULT_BLOCK,
                 num_blocks: Optional[int] = None, greedy: bool = True,
                 use_pariskv: bool = True, chunk_size: int = 8,
                 eos_id: Optional[int] = None, fused: bool = True,
                 prefill_budget: int = 0, offload: bool = True,
                 num_device_blocks: Optional[int] = None,
                 prefetch: bool = True, prefetch_hook=None,
                 overlap: bool = True, share_prefixes: bool = False,
                 mesh_shards: int = 1,
                 fetch_timeout_s: Optional[float] = None, faults=None,
                 device=None):
        if mesh_shards > 1:
            raise NotImplementedError(
                f"config {cfg.name!r}: offload=True with mesh_shards="
                f"{mesh_shards} cannot run on several devices — the tiered "
                f"host pool is read by single-device kernels; shard the "
                f"resident engine (offload=False) instead")
        _not_ported("PagedServingEngine", (
            ("fetch_timeout_s", fetch_timeout_s, None,
             "A10 (fault handling)"),))
        reason = SV.offload_support_reason(cfg)
        if reason is not None:
            raise ValueError(f"offloaded paged serving unavailable — "
                             f"{reason}")
        super().__init__(cfg, params, n_max=n_max, max_batch=max_batch,
                         block_size=block_size, num_blocks=num_blocks,
                         greedy=greedy, use_pariskv=use_pariskv,
                         chunk_size=chunk_size, eos_id=eos_id, fused=fused,
                         prefill_budget=prefill_budget,
                         share_prefixes=share_prefixes, faults=faults,
                         device=device)
        self.num_device_blocks = (max(1, self.num_blocks // 4)
                                  if num_device_blocks is None
                                  else num_device_blocks)
        self.prefetch = prefetch
        self.prefetch_hook = prefetch_hook
        self.overlap = bool(overlap)
        self._names = [f"l{i}" for i in range(cfg.num_layers)]
        self.host = offload_lib.HostKVPool(
            {n: (cfg.num_kv_heads, cfg.head_dim) for n in self._names},
            self.num_blocks, block_size, torch_dtype(cfg),
            pinned=self.device.type == "cuda")
        self._host_kv = [self.host.flat(n) for n in self._names]
        self._side = (SideStream.create(self.device)
                      if self.overlap and self.device.type == "cuda"
                      else None)
        self.staging = offload_lib.StagingMap(self.num_blocks,
                                              self.num_device_blocks)
        self._touched_last = np.zeros((self.num_blocks,), np.float64)
        self._touch_decay = 0.5
        self._last_prefetch: List[int] = []
        self.fetch_callbacks = 0          # tiered gathers, all chunks

    # ------------------------------------------------------------ admission --
    def _solo_cap(self, plen: int) -> int:
        """Bucketed prefill capacity: power-of-two prompt bucket rounded
        up to whole blocks, never above n_max."""
        b = _bucket(plen, cap=self.n_max)
        return min(self.n_max, -(-b // self.block_size) * self.block_size)

    def _install_solo(self, slot: int, req: Request, state1, tok0) -> None:
        cap = state1.caches[0]["kv"].k.shape[1]
        phys = self._phys_row(self._alloc[slot])[:cap // self.block_size]
        for name, lc1 in zip(self._names, state1.caches):
            self.host.write_prefill(name, phys.numpy(), lc1["kv"].k[0],
                                    lc1["kv"].v[0])
        self._state = SV.admit_tiered(
            self._state, slot, phys, state1.caches, state1.regions, tok0,
            req.max_new_tokens - 1, self.cfg.pariskv)
        self._enc[slot] = int(state1.regions.enc_end[0])

    # ------------------------------------------------------------- staging --
    def _update_staging(self) -> None:
        """Chunk-boundary residency update: pin the chunk's write/dense-
        read set (staging absent blocks), then prefetch predicted winner
        blocks into the remaining capacity, writing evicted blocks back to
        the host pool before any install reads it."""
        sm = self.staging
        sm.unpin_all()
        pos = self._state.regions.pos.cpu().numpy()
        enc = self._state.regions.enc_end.cpu().numpy()
        bs = self.block_size
        W = CC.window_size(self.cfg.pariskv)
        sink = self.cfg.pariskv.sink_size
        required: List[tuple] = []        # (host_block, slot), pin order
        seen: set = set()

        def want(slot, lo_blk, hi_blk):
            row = self._bt[slot]
            for lb in range(max(0, lo_blk), min(self.nblk, hi_blk)):
                hb = int(row[lb])
                if hb >= 0 and hb not in seen:
                    seen.add(hb)
                    required.append((hb, slot))

        st = self._state
        P = self.prefill_budget
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            if P and st.fill_pos[slot] < st.fill_len[slot]:
                # the fill writes [start, start + chunk·P); the window of
                # wherever its frontier lands (and the decode appends after
                # it completes) stays in [start - W, start + chunk·(P+1))
                start = int(st.fill_pos[slot])
                lo = max(0, start - W)
                hi = start + self.chunk_size * (P + 1)
            else:
                # decode appends [pos+1, pos+1+chunk); window + promotion
                # reads reach down to min(enc_end, pos+1-W)
                p1 = int(pos[slot]) + 1
                lo = max(0, min(int(enc[slot]), p1 - W))
                hi = p1 + self.chunk_size
            if sink > 0:
                want(slot, 0, -(-sink // bs))
            want(slot, lo // bs, -(-(hi + 1) // bs))

        writebacks: List[tuple] = []      # (evicted host block, staging slot)
        installs: List[tuple] = []        # (host block, staging slot)
        for hb, _ in required:
            if sm.resident(hb):
                sm.pin(hb)
                continue
            got = sm.acquire()
            if got is None:
                raise RuntimeError(
                    f"staging pool exhausted while pinning the chunk's "
                    f"write/dense-read set (num_device_blocks="
                    f"{self.num_device_blocks}); grow the staging pool or "
                    f"shrink max_batch/chunk_size")
            s, ev = got
            if ev >= 0:
                writebacks.append((ev, s))
            sm.install(hb, s)
            installs.append((hb, s))
            sm.pinned[s] = True

        self._last_prefetch = []
        if self.prefetch:
            owner = {b: sl for sl, blks in self._alloc.items() for b in blks}
            k = max(1, self.num_device_blocks // 4)
            if self.prefetch_hook is not None:
                cand = list(self.prefetch_hook(self._touched_last.copy(), k))
            else:
                order = np.argsort(-self._touched_last, kind="stable")
                cand = [int(hb) for hb in order[:k]
                        if self._touched_last[hb] > 0]
            wanted = [int(hb) for hb in cand
                      if 0 <= int(hb) < self.num_blocks and int(hb) not in
                      seen and not sm.resident(int(hb)) and int(hb) in owner]
            for hb, (s, ev) in zip(wanted, sm.acquire_batch(len(wanted))):
                if ev >= 0:
                    writebacks.append((ev, s))
                sm.install(hb, s)
                installs.append((hb, s))
                self._last_prefetch.append(hb)
                owner_req = self._slots[owner[hb]]
                if owner_req is not None:
                    owner_req.prefetched_blocks += 1

        if writebacks:
            evs = np.asarray([e for e, _ in writebacks], np.int64)
            ss = torch.tensor([s for _, s in writebacks], device=self.device)
            for name, lc in zip(self._names, self._state.caches):
                self.host.writeback(name, evs, lc["kv"].k[ss],
                                    lc["kv"].v[ss])
        if installs:
            hbs = np.asarray([h for h, _ in installs], np.int64)
            ss = torch.tensor([s for _, s in installs], device=self.device)
            for name, lc in zip(self._names, self._state.caches):
                CC.tiered_stage_blocks(lc["kv"], ss,
                                       *self.host.read_blocks(name, hbs))

    def _harvest_fetch_stats(self) -> None:
        """Read the chunk's fetch statistics back (one copy each for the
        summed touch counts and rows): per-request staging hit/miss/byte
        counters, gather attribution, prefetch-hit accounting, and the
        exponential-decay touch scores that seed the next chunk's
        prefetch."""
        caches = self._state.caches
        touched = torch.stack([lc["fetch"]["touched"] for lc in caches]
                              ).sum(0).cpu().numpy()
        rows = torch.stack([lc["fetch"]["rows"] for lc in caches]
                           ).sum(0).cpu().numpy().astype(np.int64)
        uniq = torch.stack([lc["fetch"]["uniq"] for lc in caches]
                           ).sum(0).cpu().numpy()
        calls = sum(lc["fetch"]["calls"] for lc in caches)
        # every entry shares (G, hd, dtype): one price per head row and
        # per row; a fill gather reads every kv head of each prefix row
        head_b = self.host.bytes_per_head_row(self._names[0])
        row_b = self.host.bytes_per_row(self._names[0])
        miss_b = rows[:, 2] * head_b + rows[:, 3] * row_b
        uniq_head = int(uniq[0])
        uniq_fill = int(uniq[1]) // self.cfg.num_kv_heads
        uniq_b = uniq_head * head_b + uniq_fill * row_b
        self.fetch_callbacks += calls
        self.host.fetch_callbacks += calls
        self.host.fetched_head_rows += int(rows[:, 2].sum())
        self.host.fetched_fill_rows += int(rows[:, 3].sum())
        self.host.fetched_unique_head_rows += uniq_head
        self.host.fetched_unique_fill_rows += uniq_fill
        # gathers and distinct bytes are chunk-global: shared per request
        # in proportion to its host fetches, evenly when none fetched
        active = [s for s, rq in enumerate(self._slots) if rq is not None]
        fetch_rows = rows[:, 2] + rows[:, 3]
        tot = int(fetch_rows.sum())
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            req.staging_hits += int(rows[slot, 1])
            req.staging_misses += int(rows[slot, 2])
            req.fetched_bytes += int(miss_b[slot])
            share = (fetch_rows[slot] / tot if tot
                     else 1.0 / max(len(active), 1))
            req.fetched_unique_bytes += int(round(uniq_b * share))
            req.fetch_callbacks += int(round(calls * share))
        owner = {b: sl for sl, blks in self._alloc.items() for b in blks}
        for hb in self._last_prefetch:
            if touched[hb] > 0:
                sl = owner.get(hb)
                if sl is not None and self._slots[sl] is not None:
                    self._slots[sl].prefetch_hits += 1
        self.staging.touch(np.flatnonzero(touched > 0))
        self._touched_last = self._touch_decay * self._touched_last + touched

    # ------------------------------------------- loop phases (overrides) ----
    def _init_state(self) -> SV.SlotState:
        return SV.init_paged_slot_state(
            self.cfg, self.max_batch, self.num_blocks, self.block_size,
            device=self.device, num_device_blocks=self.num_device_blocks,
            n_max=self.n_max, prefill_budget=self.prefill_budget)

    def start(self) -> None:
        super().start()
        self.staging = offload_lib.StagingMap(self.num_blocks,
                                              self.num_device_blocks)
        self.host.zero_all()
        self.host.reset_counters()
        self._touched_last = np.zeros((self.num_blocks,), np.float64)
        self._last_prefetch = []
        self.fetch_callbacks = 0

    def _run_chunk(self):
        self._update_staging()
        out = self._decode_chunk(
            torch.from_numpy(self._bt), paged_fused=self.fused,
            dev_map=torch.from_numpy(self.staging.dev_map.copy()),
            host_kv=self._host_kv, side=self._side)
        self._harvest_fetch_stats()
        return out

    def _clear_device(self, slot: int) -> None:
        """Reclaim both tiers of the slot's blocks: free their staging
        slots (no write-back: the data is dead), zero the slot's metadata
        blocks, freed staging blocks and histogram row on the device, and
        its host blocks."""
        blocks = np.asarray(self._alloc.get(slot, ()), np.int64)
        freed = self.staging.release_host_blocks(blocks)
        meta = torch.from_numpy(blocks).to(self.device)
        stag = torch.tensor(freed, dtype=torch.int64, device=self.device)
        for lc in self._state.caches:
            CC.tiered_clear_blocks(lc["kv"], meta, stag)
            lc["hist"][slot] = 0
        if blocks.size:
            self.host.zero_blocks(blocks)

    # -------------------------------------------------------------- audit --
    def verify_invariants(self, check_hist: bool = True) -> None:
        """Raise AssertionError unless the staging map mirrors ownership
        (``dev_map[hb] == s`` ⟺ ``owner[s] == hb``), free staging slots are
        unique and unowned, free + resident == num_device_blocks, and every
        staged host block is allocated to some slot; with ``check_hist``
        also ``verify_hist``."""
        if check_hist:
            self.verify_hist()
        sm = self.staging
        allocated = {b for blks in self._alloc.values() for b in blks}

        def check(cond, msg):
            if not cond:
                raise AssertionError(msg)
        for hb in np.flatnonzero(sm.dev_map >= 0):
            s = int(sm.dev_map[hb])
            check(int(sm.owner[s]) == int(hb),
                  f"staging slot {s}: owner {int(sm.owner[s])} != dev_map "
                  f"inverse {int(hb)}")
            check(int(hb) in allocated, f"host block {int(hb)} staged but "
                  f"not allocated to any slot")
        for s in np.flatnonzero(sm.owner >= 0):
            hb = int(sm.owner[s])
            check(int(sm.dev_map[hb]) == int(s),
                  f"host block {hb}: dev_map {int(sm.dev_map[hb])} != "
                  f"owning staging slot {int(s)}")
        free = list(sm.free)
        check(len(set(free)) == len(free),
              "staging free list holds duplicate slots")
        for s in free:
            check(int(sm.owner[s]) < 0,
                  f"staging slot {s} free but owned by block "
                  f"{int(sm.owner[s])}")
        check(len(free) + sm.resident_count() == self.num_device_blocks,
              f"staging accounting leak: free + resident != "
              f"{self.num_device_blocks}")

    def run(self) -> List[Request]:
        done = super().run()
        if self.staging.resident_count() != 0:
            raise RuntimeError("staging leak: the residency map retained "
                               "blocks after the run")
        return done


class WaveServingEngine:
    """Legacy lockstep wave scheduler (the reference's benchmark baseline).

    All requests of a wave are prefilled as one right-aligned padded batch
    with no ``lengths`` (the pad zeros are real tokens to attention) and
    decoded together, every row active, to the wave's longest generation;
    new requests join only at wave boundaries. Timing is wave-level: every
    request of a wave reports the shared prefill time as ``ttft_s`` and the
    shared decode time as ``decode_s``. Runs on the first CUDA card unless
    ``device="cpu"``; ``params`` must live there."""

    def __init__(self, cfg: ModelConfig, params, n_max: int = 4096,
                 max_batch: int = 8, greedy: bool = True,
                 use_pariskv: bool = True, device=None):
        if not greedy:
            raise ValueError("sampling is on-device argmax; greedy only")
        self.device = resolve_device(device)
        if param_device(params).type != self.device.type:
            raise ValueError(f"params live on {param_device(params)}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.n_max = n_max
        self.max_batch = max_batch
        self.use_pariskv = use_pariskv
        self.queue: List[Request] = []
        self.peak_concurrency = 0   # max requests decoding in one wave
        self.decode_steps = 0
        self.nonfinite_logits = torch.zeros((), dtype=torch.int64,
                                            device=self.device)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _pad_prompts(self, reqs: List[Request]) -> np.ndarray:
        s = max(max(len(r.prompt) for r in reqs), 8)
        toks = np.zeros((len(reqs), s), np.int32)
        for i, r in enumerate(reqs):
            toks[i, s - len(r.prompt):] = r.prompt   # right-align
        return toks

    def run(self) -> List[Request]:
        done: List[Request] = []
        while self.queue:
            wave = self.queue[:self.max_batch]
            self.queue = self.queue[self.max_batch:]
            done.extend(self._run_wave(wave))
        return done

    def _run_wave(self, wave: List[Request]) -> List[Request]:
        b = len(wave)
        self.peak_concurrency = max(self.peak_concurrency, b)
        toks = self._pad_prompts(wave)
        t0 = time.perf_counter()
        logits, state = SV.prefill(self.params, self.cfg, toks, self.n_max,
                                   device=self.device)
        _sync(self.device)
        t1 = time.perf_counter()
        for r in wave:
            r.ttft_s = t1 - t0
        max_new = max(r.max_new_tokens for r in wave)
        outs = np.zeros((b, max_new), np.int32)
        tok = logits.argmax(-1).to(torch.int32)
        for step in range(max_new):
            outs[:, step] = tok.cpu().numpy()
            logits, state = SV.decode_step(self.params, self.cfg, tok, state,
                                           use_pariskv=self.use_pariskv)
            self.nonfinite_logits += (~torch.isfinite(logits)).sum()
            tok = logits.argmax(-1).to(torch.int32)
        _sync(self.device)
        t2 = time.perf_counter()
        self.decode_steps += max_new
        for i, r in enumerate(wave):
            r.output = outs[i, :r.max_new_tokens]
            r.decode_s = t2 - t1
            r.token_times = [t1 + (j + 1) * (t2 - t1) / max_new
                             for j in range(len(r.output))]
        return wave
