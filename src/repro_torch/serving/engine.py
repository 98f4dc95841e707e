"""Serving engines (port of ``repro/serving/engine.py`` without chunked
prefill, prefix sharing, offload, fault handling and mesh sharding).

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

``PagedServingEngine`` runs the same loop over one global pool of
``num_blocks × block_size`` token blocks shared by all ``max_batch``
slots:

* admission needs ``⌈(prompt + gen) / block_size⌉`` unreserved blocks
  (worst-case reservation, FIFO backpressure: the head of the queue waits);
* a queued request is prefilled solo (batch 1, LEFT-aligned, padded to a
  power-of-two bucket capped at ``n_max``) and its cache scattered into
  the pool; the prompt's blocks are taken at admission, later blocks
  lazily before the chunk whose appends reach them;
* a finished or cancelled slot's blocks and histogram row are zeroed and
  its blocks return to the free list.

Its decode runs the fused retrieval path, or with ``fused=False`` the
meta-view fallback (token-identical).

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
from repro_torch.models.model import param_device


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


def _solo_prefill(params, cfg: ModelConfig, req: Request, n_max: int,
                  device):
    """Solo (batch=1) prefill of a request's prompt, LEFT-aligned and
    padded to a power-of-two bucket capped at n_max. → (state1, tok0)."""
    s = _bucket(len(req.prompt), cap=n_max)
    toks = np.zeros((1, s), np.int32)
    toks[0, :len(req.prompt)] = req.prompt
    logits, state1 = SV.prefill(params, cfg, toks, n_max,
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
            ("prefill_budget", prefill_budget, 0, "A7 (chunked prefill)"),
            ("faults", faults, None, "A10 (fault handling)")))
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
        self.queue: List[Request] = []
        self.peak_concurrency = 0   # max slots simultaneously decoding
        self.decode_steps = 0       # decode steps run (chunks × chunk_size)
        self.nonfinite_logits = None  # device count of NaN/inf logits
        self._state = None
        self._slots: List[Optional[Request]] = []
        self._done: List[Request] = []
        self._cancelled: set = set()
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
        # uids are per run: keep only cancels aimed at the current queue
        self._cancelled &= {r.uid for r in self.queue}

    def pending(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self._slots)

    # -- device state and hooks (the paged engine overrides) ----------------
    def _init_state(self) -> SV.SlotState:
        return SV.init_slot_state(self.cfg, self.max_batch, self.n_max,
                                  device=self.device)

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

    def _decode_chunk(self, block_tables=None, paged_fused: bool = True):
        tokens, self._state = SV.decode_chunk(
            self.params, self.cfg, self._state, self.chunk_size,
            block_tables, eos_id=self.eos_id, device=self.device,
            nonfinite=self.nonfinite_logits, use_pariskv=self.use_pariskv,
            paged_fused=paged_fused)
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

    def _after_collect(self, slot: int, req: Request) -> None:
        """Count the slot's sliding-window promotions from its enc_end."""
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
        self._cancelled.clear()

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self._slots[slot] is not None or not self.queue:
                continue
            if not self._can_admit():
                break                        # backpressure: head waits
            req = self.queue.pop(0)
            t_admit = time.perf_counter()
            self._pre_admit(slot, req)
            state1, tok0 = _solo_prefill(self.params, self.cfg, req,
                                         self.n_max, self.device)
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

    def _collect(self, tokens: np.ndarray, rem_after: np.ndarray) -> None:
        t_now = time.perf_counter()
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            _collect_chunk_row(req, tokens[slot], t_now)
            self._after_collect(slot, req)
            if rem_after[slot] <= 0:
                self._finish_request(req, t_now)
                self._slots[slot] = None
                self._release_slot(slot)

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
    ``device="cpu"``; ``params`` must live there."""

    def __init__(self, cfg: ModelConfig, params, n_max: int = 4096,
                 max_batch: int = 8, block_size: int = CC.PAGED_DEFAULT_BLOCK,
                 num_blocks: Optional[int] = None, greedy: bool = True,
                 use_pariskv: bool = True, chunk_size: int = 8,
                 eos_id: Optional[int] = None, fused: bool = True,
                 prefill_budget: int = 0, offload: bool = False,
                 share_prefixes: bool = False, mesh_shards: int = 1,
                 faults=None, device=None):
        _not_ported("PagedServingEngine", (
            ("prefill_budget", prefill_budget, 0, "A7 (chunked prefill)"),
            ("share_prefixes", share_prefixes, False, "A8 (prefix sharing)"),
            ("offload", offload, False, "A9 (host-offloaded tier)"),
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
                         eos_id=eos_id, device=device)
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
        solo prefill writes the whole prompt in one scatter)."""
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
                                        device=self.device)

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
