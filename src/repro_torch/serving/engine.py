"""Serving engines (port of ``repro/serving/engine.py``).

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

``share_prefixes=True`` (paged engines, with ``prefill_budget > 0``) adds
block-granular prefix sharing with copy-on-write: every full prompt block
but the one holding the last prompt token gets a chained SHA-256 content
hash and, once its fill completes, an entry in a pool-level
``prefix_index``. A later admission maps the longest indexed prefix into
its table (one more reference per block, no pool draw), rebuilds its
histogram from those blocks' metadata and fills only the suffix; every
write it makes lands in private blocks. Reclamation is refcounted: a
block is zeroed, freed and dropped from the index only when its last
holder leaves.

Its decode runs the fused retrieval path, or with ``fused=False`` the
meta-view fallback (token-identical). ``offload=True`` returns an
``OffloadedPagedServingEngine``: the K/V pool lives in (pinned) host
memory and the device keeps the metadata and a bounded staging pool.

``mesh_shards=N`` splits the paged engine over the N ranks of a
``torch.distributed`` process group on the KV-head axis (the reference's
device mesh): every rank gets the same ``submit``s and runs the same host
scheduler and allocator (block numbering stays global), holds its G / N
heads of the pool, its metadata and the histograms, and runs retrieval and
sparse attention on them; the attention output heads are gathered once
per layer (``distributed.ShardDist.all_gather_heads``), so every rank
emits one device's tokens. The rest of the model runs replicated.

``WaveServingEngine`` is the legacy lockstep baseline: each wave of up to
``max_batch`` requests is prefilled as one right-aligned batch (the pad
zeros are real tokens to attention, as in the reference) and decoded
together to the wave's longest generation.

Fault handling (``faults=`` a ``serving.faults.FaultPlan``; the
reference's contract): an exception attributable to one request — in its
solo prefill or install, its pre-chunk host work (the ``engine.slot``
fault site) or its collection — **quarantines** it: its slot, blocks,
staging residency and histogram row are reclaimed as a cancel would, it
finishes with ``failed=True`` and ``error`` set, and lands in
``quarantined``; the batch carries on. A ``KernelError`` (a CUDA kernel
that did not build or launch) or ``torch.AcceleratorError`` is a device
fault, never one request's: the boundaries re-raise them. The offloaded
engine adds the fetch policy and degraded attention
(``OffloadedPagedServingEngine``).

Every stage that was a Pallas kernel on the TPU runs a Hopper kernel on
the card. Options that are not ported yet raise ``NotImplementedError``
naming the ROADMAP item that will port them.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, trace
from repro_torch.core import cache as CC
from repro_torch.core.config import ModelConfig
from repro_torch.distributed import ShardDist
from repro_torch.kernels.build import KernelError
from repro_torch.models import serve as SV
from repro_torch.models.layers import SideStream
from repro_torch.models.model import param_device, torch_dtype
from repro_torch.serving import offload as offload_lib
from repro_torch.serving.faults import FaultPlan

# device faults: never attributable to one request, so no quarantine
# boundary may turn them into a failed request
_DEVICE_FAULTS = tuple(t for t in (KernelError,
                                   getattr(torch, "AcceleratorError", None))
                       if t is not None)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (s,) int32
    max_new_tokens: int = 32
    # (T, d) float32 patch / frame embeddings: llama-vision's and whisper's
    # requests carry them (``data.media_stub``); None for the rest
    media: Optional[np.ndarray] = None
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
    fetch_retries: int = 0
    fetch_timeouts: int = 0
    degraded_steps: int = 0
    # prefix sharing only: cached blocks mapped into its table, not filled
    shared_prefix_blocks: int = 0
    # fault handling: quarantined by an engine fault, and why
    failed: bool = False
    error: Optional[str] = None
    # engine-internal:
    _tokens: Optional[list] = None
    _t_submit: float = 0.0
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
    ``cap`` positions, with its media (if any) as a batch of one.
    → (state1, tok0)."""
    s = _bucket(len(req.prompt), cap=cap)
    toks = np.zeros((1, s), np.int32)
    toks[0, :len(req.prompt)] = req.prompt
    media = None if req.media is None else np.asarray(req.media)[None]
    logits, state1 = SV.prefill(params, cfg, toks, cap,
                                lengths=[len(req.prompt)], device=device,
                                media=media)
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


class InvariantViolation(AssertionError):
    """``verify_invariants()`` found engine state that breaks a structural
    invariant (allocator accounting, block-table and refcount agreement,
    staging residency, or the incremental histogram)."""


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
                 faults: Optional[FaultPlan] = None, device=None):
        if not greedy:
            raise ValueError("sampling is on-device argmax; greedy only")
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
        self.faults = faults
        self.quarantined: List[Request] = []
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
        req._t_submit = time.perf_counter()
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
        self.quarantined = []
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

    def _undo_failed_admit(self, slot: int) -> None:
        """Undo an admission that raised part-way (paged: its blocks and
        histogram row may be partly written, so they are reclaimed and
        zeroed as a finished slot's)."""
        self._abort_admit(slot)

    def _install_solo(self, slot: int, req: Request, state1, tok0) -> None:
        self._state = SV.admit_slot(
            self._state, slot, state1.caches, state1.regions, tok0,
            req.max_new_tokens - 1)
        self._enc[slot] = int(state1.regions.enc_end[0])

    def _pre_chunk_slot(self, slot: int, req: Request) -> None:
        """Per-slot host work before a chunk (paged: lazy allocation). The
        ``engine.slot`` fault fires here; whatever this raises belongs to
        exactly one request and quarantines it."""
        if self.faults is not None:
            self.faults.apply("engine.slot", slot=slot, uid=req.uid)

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
        with trace.span("sync.chunk_out"):
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
        written (a sharing engine registers its blocks)."""

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
        trace.record("request.decode", req._t_first, t_now, uid=req.uid)
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

    # -- quarantine -----------------------------------------------------------
    def _quarantine(self, slot: int, req: Request, exc: Exception) -> None:
        """Evict and fail exactly one request after an exception that
        belongs to its slot: its device state reclaimed by the path
        ``cancel()`` takes (blocks, staging residency, histogram row), its
        output finalized from the tokens it already emitted, and the
        request recorded in ``quarantined`` and the done list."""
        t_now = time.perf_counter()
        req.failed = True
        req.error = f"{type(exc).__name__}: {exc}"
        self._evict_device(slot)
        if req._tokens is None:
            req._tokens, req.token_times = [], []
        if not req._t_first:
            req._t_first = t_now
        self._finish_request(req, t_now)
        self._slots[slot] = None
        if self._filling == slot:
            self._filling = None
        self.quarantined.append(req)

    def _quarantine_admission(self, slot: int, req: Request,
                              exc: Exception) -> None:
        """Admission-path quarantine: the request never went live in its
        slot, so only what its admission took is undone
        (``_undo_failed_admit``), and it finishes failed with an empty
        output."""
        t_now = time.perf_counter()
        req.failed = True
        req.error = f"{type(exc).__name__}: {exc}"
        if req._tokens is None:
            req._tokens, req.token_times = [], []
        req._t_first = t_now
        self._finish_request(req, t_now)
        self._undo_failed_admit(slot)
        self.quarantined.append(req)

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self._slots[slot] is not None or not self.queue:
                continue
            if not self._can_admit():
                break                        # backpressure: head waits
            if self.prefill_budget and self._filling is not None:
                break                        # at most one filling slot
            req = self.queue.pop(0)
            with trace.span("engine.admit", uid=req.uid) as sp:
                if self.prefill_budget:
                    self._pre_admit(slot, req)
                    self._admit_chunked(slot, req)
                else:
                    self._admit_solo(slot, req)
                sp.set(shared=req.shared_prefix_blocks)

    def _admit_solo(self, slot: int, req: Request) -> None:
        """Solo-prefill admission: the request's first token now, its
        cache installed in ``slot`` (or it finishes at prefill, or is
        quarantined)."""
        t_admit = time.perf_counter()
        trace.record("request.queued", req._t_submit, t_admit, uid=req.uid)
        try:
            self._pre_admit(slot, req)
            state1, tok0 = _solo_prefill(self.params, self.cfg, req,
                                         self._solo_cap(len(req.prompt)),
                                         self.device)
        except _DEVICE_FAULTS:
            raise
        except Exception as exc:  # noqa: BLE001 — quarantine boundary
            self._quarantine_admission(slot, req, exc)
            return
        t_first = time.perf_counter()
        trace.record("request.prefill", t_admit, t_first, uid=req.uid)
        req.ttft_s = t_first - t_admit
        req._t_admit, req._t_first = t_admit, t_first
        req._tokens, req.token_times = [tok0], [t_first]
        if req.max_new_tokens <= 1 or tok0 == self.eos_id:
            req.output = np.asarray(req._tokens, np.int32)
            req.decode_s = 0.0
            self._done.append(req)
            self._abort_admit(slot)
            return
        try:
            self._install_solo(slot, req, state1, tok0)
        except _DEVICE_FAULTS:
            raise
        except Exception as exc:  # noqa: BLE001 — quarantine boundary
            self._quarantine_admission(slot, req, exc)
            return
        self._slots[slot] = req

    def _admit_chunked(self, slot: int, req: Request) -> None:
        """Chunked-prefill admission: copy the prompt to the slot's device
        buffer and arm its fill; the decode chunks do the work."""
        req._t_admit = time.perf_counter()
        trace.record("request.queued", req._t_submit, req._t_admit,
                     uid=req.uid)
        req._tokens, req.token_times = [], []
        prow = np.zeros((self.n_max + self.prefill_budget,), np.int32)
        prow[:len(req.prompt)] = req.prompt
        self._state = SV.admit_fill(self._state, slot, prow, len(req.prompt),
                                    req.max_new_tokens,
                                    **self._fill_args(slot))
        self._enc[slot] = CC.fill_enc_end(len(req.prompt), self.cfg.pariskv)
        self._slots[slot] = req
        self._filling = slot

    def _fill_args(self, slot: int) -> dict:
        """admit_fill's shared-prefix arguments (paged sharing engines)."""
        return {}

    def _collect_slot(self, slot: int, req: Request, tokens: np.ndarray,
                      rem_after: np.ndarray, t_now: float) -> None:
        had = len(req._tokens)
        n_emit = _collect_chunk_row(req, tokens[slot], t_now)
        if had == 0 and n_emit > 0:          # a chunked fill completed
            req.ttft_s = t_now - req._t_admit
            req._t_first = t_now
            trace.record("request.prefill", req._t_admit, t_now, uid=req.uid)
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

    def _collect(self, tokens: np.ndarray, rem_after: np.ndarray) -> None:
        t_now = time.perf_counter()
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            try:
                self._collect_slot(slot, req, tokens, rem_after, t_now)
            except _DEVICE_FAULTS:
                raise
            except Exception as exc:  # noqa: BLE001 — quarantine boundary
                if self._slots[slot] is None:
                    # released already (a failure mid-reclamation): no
                    # longer one request's fault
                    raise
                self._quarantine(slot, req, exc)

    def _pre_chunk(self) -> None:
        """Per-slot host work before a chunk, one slot at a time behind a
        quarantine boundary: a failure of one slot fails that request
        while the rest of the batch goes on."""
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            try:
                self._pre_chunk_slot(slot, req)
            except _DEVICE_FAULTS:
                raise
            except Exception as exc:  # noqa: BLE001 — quarantine boundary
                self._quarantine(slot, req, exc)

    def step_serve(self) -> None:
        """One serving round: cancellations → admission → one decode chunk
        → collection/eviction."""
        with trace.span("engine.step") as sp:
            self._process_cancellations()
            self._admit()
            rows = sum(r is not None for r in self._slots)
            sp.set(rows=rows, filling=self._filling)
            self.peak_concurrency = max(self.peak_concurrency, rows)
            if not rows:
                return  # everything finished at prefill; maybe more queued
            with trace.span("engine.pre_chunk"):
                self._pre_chunk()
            tokens, rem_after = self._run_chunk()
            self.decode_steps += self.chunk_size
            with trace.span("engine.collect"):
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
    constructs an ``OffloadedPagedServingEngine``.

    ``share_prefixes=True`` (needs ``prefill_budget > 0`` and an
    architecture ``models.serve.share_supported`` accepts) maps indexed
    prompt blocks into later admissions' tables (module docstring).
    Admission backpressure then counts only the blocks a request will
    draw from the pool. ``blocks_consumed`` counts the blocks ever drawn
    from the pool, ``shared_block_hits`` the blocks ever mapped, and
    ``Request.shared_prefix_blocks`` each request's mapped blocks.

    A config the pool cannot page (``models.serve.check_pageable``: one
    with no ParisKV attention layer, mamba2, or with MLA layers,
    deepseek-v2, whose latent caches stay contiguous) raises
    ``UnsupportedPagedConfig`` at construction, with every option but
    ``share_prefixes=True``, whose refusal (the reference's ``ValueError``
    and message) comes first, and but ``mesh_shards`` > 1 on an MLA
    config, which raises the reference's ``UnsupportedShardedConfig``
    naming 'mla'; the slot and wave engines serve both.

    ``mesh_shards=N`` > 1 (module docstring) runs in each rank of a process
    group of N ranks (``torchrun``, or ``distributed.launch_local``) on
    that rank's device: on a card, the rank's current CUDA device. It
    refuses an N that does not divide ``num_kv_heads`` (``ValueError``)
    with the configuration checks of ``models.serve.check_paged_engine``
    (which the capacity planner shares), then a missing group or one of
    another size (``ValueError``); ``offload=True`` with it raises
    ``UnsupportedShardedConfig``. ``verify_invariants()`` and the end of
    ``run()`` also check that every rank holds the same host state."""

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
                 faults: Optional[FaultPlan] = None, device=None):
        if share_prefixes:
            if prefill_budget <= 0:
                raise ValueError(
                    "share_prefixes=True requires prefill_budget > 0: the "
                    "chunked fill skips the shared prefix, and a solo "
                    "prefill cannot resume past it")
            reason = SV.share_support_reason(cfg)
            if reason is not None:
                raise ValueError(f"prefix sharing unavailable — {reason}")
        SV.check_paged_engine(cfg, mesh_shards, use_pariskv, n_max,
                              block_size)
        self.dist = (None if mesh_shards == 1
                     else ShardDist.from_process_group(mesh_shards))
        super().__init__(cfg, params, n_max=n_max, max_batch=max_batch,
                         greedy=greedy, chunk_size=chunk_size,
                         eos_id=eos_id, prefill_budget=prefill_budget,
                         faults=faults, device=device)
        if self.dist is not None:
            _check_shard_device(self.dist, self.device)
        self.fused = fused
        self.share_prefixes = share_prefixes
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
        # refcounts are kept with sharing off too (one holder per block),
        # so there is one reclamation path
        self._refcnt: Dict[int, int] = {}        # block → live holders
        self._prefix_index: Dict[bytes, int] = {}  # chained hash → block
        self._block_hash: Dict[int, bytes] = {}  # block → its index key
        self._fill_start: Dict[int, int] = {}    # slot → shared-prefix end
        self.blocks_consumed = 0    # blocks drawn from the pool (ever)
        self.shared_block_hits = 0  # blocks mapped from the index (ever)

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
        self._refcnt[blk] = 1
        self.blocks_consumed += 1

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

    # ------------------------------------------------------ prefix sharing --
    def _chain_hashes(self, prompt) -> List[bytes]:
        """One chained SHA-256 digest per shareable full prompt block:
        block i hashes its token ids with block i-1's digest, so equal
        digests mean equal tokens and equal context before them. The block
        holding the last prompt token is left out: it stays private (the
        fill needs at least one token for the first-token logits, and the
        decode appends land there)."""
        toks = np.ascontiguousarray(np.asarray(prompt, np.int32))
        bs = self.block_size
        out: List[bytes] = []
        h = b""
        for i in range((len(toks) - 1) // bs):
            h = hashlib.sha256(h + toks[i * bs:(i + 1) * bs].tobytes()
                               ).digest()
            out.append(h)
        return out

    def _lookup_shared(self, req: Request) -> List[int]:
        """The longest indexed prefix of the request's shareable blocks,
        as physical block ids (possibly none)."""
        blocks: List[int] = []
        for hh in self._chain_hashes(req.prompt):
            blk = self._prefix_index.get(hh)
            if blk is None:
                break
            blocks.append(blk)
        return blocks

    def _map_shared(self, slot: int, blk: int) -> None:
        """Map an indexed block into the slot's table: one more reference,
        no pool draw (its reservation is released)."""
        self._bt[slot, len(self._alloc[slot])] = blk
        self._alloc[slot].append(blk)
        self._resv[slot] -= 1
        self._refcnt[blk] += 1
        self.shared_block_hits += 1

    def _decref_blocks(self, slot: int) -> List[int]:
        """Drop the slot's references; → the blocks whose last holder left
        (only these may be zeroed, freed and dropped from the index)."""
        dead: List[int] = []
        for blk in self._alloc.get(slot, ()):
            self._refcnt[blk] -= 1
            if self._refcnt[blk] == 0:
                del self._refcnt[blk]
                hh = self._block_hash.pop(blk, None)
                if hh is not None:
                    self._prefix_index.pop(hh, None)
                dead.append(blk)
        return dead

    def _fill_complete(self, slot: int, req: Request) -> None:
        """Index the finished fill's shareable blocks (the first writer of
        a digest wins; a sharer's mapped prefix is already there). Only now
        are they fully written, so a concurrent identical prompt never
        maps a half-filled block."""
        if not self.share_prefixes:
            return
        for i, hh in enumerate(self._chain_hashes(req.prompt)):
            blk = int(self._bt[slot, i])
            if hh not in self._prefix_index:
                self._prefix_index[hh] = blk
                self._block_hash[blk] = hh

    def _fill_args(self, slot: int) -> dict:
        if not self.share_prefixes:
            return {}
        return dict(fill_start=self._fill_start.get(slot, 0),
                    bt_row=torch.from_numpy(self._bt[slot].copy()),
                    pcfg=self.cfg.pariskv)

    # ----------------------------------------------------------- allocator --
    def _reserve_blocks(self, slot: int, req: Request) -> None:
        """Worst-case reservation plus the prompt's blocks up front (the
        solo prefill writes the whole prompt in one scatter, a chunked
        fill writes through the table from its first step). While a slot
        fills, its host ``_pos`` stays at the prompt's end. With sharing,
        the indexed prefix is mapped first and only the rest of the
        prompt's blocks are drawn; ``_fill_start`` records where the fill
        resumes."""
        self._alloc[slot] = []
        self._resv[slot] = self.blocks_needed(req)
        self._pos[slot] = len(req.prompt) - 1
        self._need[slot] = len(req.prompt) + req.max_new_tokens
        shared = self._lookup_shared(req) if self.share_prefixes else []
        for blk in shared:
            self._map_shared(slot, blk)
        self._fill_start[slot] = len(shared) * self.block_size
        req.shared_prefix_blocks = len(shared)
        for _ in range(-(-len(req.prompt) // self.block_size) - len(shared)):
            self._take_block(slot)

    def _release_host(self, slot: int,
                      dead: Optional[List[int]] = None) -> None:
        """Drop the slot's references (unless ``dead``, the blocks that
        died, is given) and free the dead blocks; a block another slot
        still maps stays in place, index entry and all."""
        if dead is None:
            dead = self._decref_blocks(slot)
        self._alloc.pop(slot, None)
        self._free.extend(dead)
        for d in (self._resv, self._pos, self._need, self._enc,
                  self._fill_start):
            d.pop(slot, None)
        self._bt[slot] = -1

    def _clear_device(self, slot: int, dead: List[int]) -> None:
        """Zero the dead blocks and the slot's histogram row (reclaimed
        blocks must not leak a tenant's K/V; a free slot's histogram is
        zero until the next admission computes it). Blocks another slot
        still maps are left as they are."""
        with trace.span("sync.clear_blocks"):  # upload, selection, scalar
            phys = self._phys_row(dead).to(self.device)
            for lc in SV.pool_entries(self._state.caches):
                CC.paged_clear_blocks(lc["kv"], phys)
                lc["hist"][slot] = 0

    def _reclaim(self, slot: int) -> None:
        dead = self._decref_blocks(slot)
        self._clear_device(slot, dead)
        self._release_host(slot, dead)

    # ------------------------------------------- loop phases (overrides) ----
    def _init_state(self) -> SV.SlotState:
        return SV.init_paged_slot_state(self.cfg, self.max_batch,
                                        self.num_blocks, self.block_size,
                                        device=self.device, n_max=self.n_max,
                                        prefill_budget=self.prefill_budget,
                                        dist=self.dist)

    def _evict_device(self, slot: int) -> None:
        self._state = SV.cancel_slot(self._state, slot)
        self._reclaim(slot)

    def _can_admit(self) -> bool:
        need = self.blocks_needed(self.queue[0])
        if self.share_prefixes:
            # mapped prefix blocks are never drawn from the pool
            need -= len(self._lookup_shared(self.queue[0]))
        return need <= self.free_blocks

    def _pre_admit(self, slot: int, req: Request) -> None:
        self._reserve_blocks(slot, req)

    def _abort_admit(self, slot: int) -> None:
        self._release_host(slot)       # pool untouched: host-only

    def _undo_failed_admit(self, slot: int) -> None:
        self._reclaim(slot)

    def _install_solo(self, slot: int, req: Request, state1, tok0) -> None:
        self._state = SV.admit_paged(
            self._state, slot, self._phys_row(self._alloc[slot]),
            state1.caches, state1.regions, tok0, req.max_new_tokens - 1,
            self.cfg.pariskv, dist=self.dist)
        self._enc[slot] = int(state1.regions.enc_end[0])

    def _pre_chunk_slot(self, slot: int, req: Request) -> None:
        super()._pre_chunk_slot(slot, req)     # engine.slot fault hook
        self._ensure_blocks(slot)

    def _run_chunk(self):
        return self._decode_chunk(torch.from_numpy(self._bt),
                                  paged_fused=self.fused, dist=self.dist)

    def _after_collect(self, slot: int, req: Request) -> None:
        # host view of the device pos: last prompt token + decoded tokens
        self._pos[slot] = len(req.prompt) - 1 + max(0, len(req._tokens) - 1)
        super()._after_collect(slot, req)

    def _release_slot(self, slot: int) -> None:
        self._reclaim(slot)

    def run(self) -> List[Request]:
        done = super().run()
        self._audit_ranks(repr([(r.uid, r.failed, r.output.tolist())
                                for r in done]).encode())
        if len(self._free) != self.num_blocks:
            raise RuntimeError("block leak: the allocator did not reclaim "
                               "every block")
        if self._refcnt or self._prefix_index or self._block_hash:
            raise RuntimeError("refcount leak: blocks still referenced or "
                               "indexed after the run")
        return done

    # -------------------------------------------------------------- audit --
    @staticmethod
    def _check(cond: bool, msg: str) -> None:
        if not cond:
            raise InvariantViolation(msg)

    def _audit_ranks(self, extra: bytes = b"") -> None:
        """Raise ``InvariantViolation`` unless every rank of a head-sharded
        engine holds the same host state (block tables, refcounts, free
        list, slot owners, counters, and ``extra``). A rank that drifted
        would deadlock at its next collective or serve other tokens.
        Every rank must call it at the same point (one all-gather)."""
        if self.dist is None:
            return
        state = repr((sorted(self._refcnt.items()), list(self._free),
                      [None if r is None else r.uid for r in self._slots],
                      self.blocks_consumed, self.shared_block_hits,
                      sorted(self._prefix_index.values()))).encode()
        bad = self.dist.ranks_differing(self._bt.tobytes() + state + extra)
        self._check(not bad, f"host state of ranks {bad} differs from rank "
                             f"0's: the head-sharded ranks drifted apart")

    def verify_invariants(self, check_hist: bool = True) -> None:
        """Raise ``InvariantViolation`` on the first inconsistency of the
        engine's redundant state, at a chunk boundary:

        * the free list: no duplicates, disjoint from the allocated
          blocks, and free + allocated == num_blocks;
        * refcounts: each allocated block's count equals its holders, and
          no other block has one; reservations are not negative;
        * block tables: each row's allocated entries are the allocator's
          list for the slot, in order;
        * the prefix index and its reverse map are a bijection over
          allocated blocks;
        * fault handling: no quarantined request holds a slot, and a free
          slot holds no block or reservation (nor, with ``check_hist``, a
          nonzero histogram row), so a quarantined request holds nothing;
        * with ``check_hist``, ``verify_hist``;
        * head-sharded: every rank holds the same host state (checked
          first, so that every rank reaches the all-gather)."""
        self._audit_ranks()
        allocated: Dict[int, int] = {}
        for s, blks in self._alloc.items():
            self._check(len(set(blks)) == len(blks),
                        f"slot {s} holds a duplicate block: {blks}")
            for b in blks:
                allocated[b] = allocated.get(b, 0) + 1
        free = list(self._free)
        self._check(len(set(free)) == len(free),
                    "free list holds duplicate blocks")
        both = sorted(set(free) & set(allocated))
        self._check(not both, f"free list intersects allocated blocks: "
                              f"{both}")
        self._check(len(free) + len(allocated) == self.num_blocks,
                    f"block accounting leak: {len(free)} free + "
                    f"{len(allocated)} allocated != {self.num_blocks}")
        self._check(set(self._refcnt) == set(allocated),
                    "refcount keys drifted from the allocated blocks")
        for b, n in allocated.items():
            self._check(self._refcnt[b] == n, f"block {b}: refcount "
                        f"{self._refcnt[b]} != {n} live holders")
        for s, n in self._resv.items():
            self._check(n >= 0, f"slot {s}: negative reservation {n}")
        for slot in range(self.max_batch):
            row = self._bt[slot]
            got = row[row >= 0].tolist()
            want = self._alloc.get(slot, [])
            self._check(got == want, f"slot {slot}: block-table row {got} "
                        f"!= allocator view {want}")
        self._check(set(self._prefix_index.values()) == set(self._block_hash)
                    and len(self._prefix_index) == len(self._block_hash),
                    "prefix index and block-hash map are not a bijection")
        for hh, b in self._prefix_index.items():
            self._check(self._block_hash.get(b) == hh,
                        f"block {b}: hash map disagrees with the index")
            self._check(b in self._refcnt,
                        f"prefix index retains unallocated block {b}")
        live = {id(r) for r in self._slots if r is not None}
        for req in self.quarantined:
            self._check(id(req) not in live,
                        f"quarantined request {req.uid} still holds a slot")
        idle = [s for s, r in enumerate(self._slots) if r is None]
        for s in idle:
            self._check(s not in self._alloc and s not in self._resv,
                        f"free slot {s} still holds blocks "
                        f"{self._alloc.get(s)} or a reservation")
        if check_hist and self._state is not None:
            if idle:
                sel = torch.tensor(idle, device=self.device)
                for li, lc in enumerate(self._state.caches):
                    if not SV.is_pool(lc):
                        continue
                    self._check(not bool(lc["hist"][sel].any()),
                                f"layer {li}: a free slot of {idle} holds "
                                f"a histogram row")
            self.verify_hist()

    def verify_hist(self) -> None:
        """Raise ``InvariantViolation`` unless every active slot's
        incremental histogram equals a recompute from the pool's centroid
        ids over [sink, enc_end), in every layer."""
        pcfg = self.cfg.pariskv
        slots = [s for s, r in enumerate(self._slots) if r is not None]
        if not slots:
            return
        bt = torch.from_numpy(self._bt[slots]).to(self.device)
        sel = torch.tensor(slots, device=self.device)
        regions = CC.CacheRegions(pos=self._state.regions.pos[sel],
                                  enc_end=self._state.regions.enc_end[sel])
        for li, lc in enumerate(self._state.caches):
            if not SV.is_pool(lc):
                continue
            ids = CC.paged_ids_view(lc["kv"], bt)
            want = CC.bucket_hist_from_meta(ids, regions, pcfg)
            self._check(torch.equal(lc["hist"][sel], want),
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
    Eviction and ``cancel(uid)`` reclaim both tiers of the blocks whose
    last holder left: host blocks zeroed, staging slots freed without
    write-back. With ``share_prefixes`` a sharer's first chunk reads the
    mapped prefix through the tiered gather like any other prefix.

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
    * ``fetch_stall_s``: host seconds the fetch policy spent before its
      gathers were launched (injected delays and hangs, backoff), shared
      in proportion to host fetches; 0 without a fault plan, since the
      misses are read by the device inside the decode step and the host
      never waits for one (their time is the kernel's).
    * ``fetch_retries`` / ``fetch_timeouts``: the policy's re-issues and
      fired deadlines, shared the same way; ``degraded_steps``: the
      request's (layer, step) fetches that gave up. These, and the engine
      totals of the same names (with ``storm_evictions``), equal the
      reference's under the same ``FaultPlan``.

    Fault handling (the reference's policy, ``HostKVPool.fetch_attempt``):
    ``fetch_timeout_s`` (None: no deadline), ``fetch_max_retries`` (2) and
    ``fetch_backoff_s`` (0.005, doubling per retry) govern every host
    fetch, the winner rows of each layer and step (``kind="heads"``) and a
    fill's prefix rows (``"rows"``). A launched kernel cannot be
    abandoned, so an attempt is the host work before the launch (the
    ``fetch.gather`` fault hook) and the deadline bounds that; no worker
    thread exists (``host.abandoned_attempts`` counts the attempts a
    deadline ended). A fetch that gives up **degrades** its layer-step:
    the same gather is launched with its host rows at -1 (it reads none)
    and attention drops them, attending to sink, window and the staged
    winners. A ``staging.storm`` fault flushes every staged block at a
    chunk boundary (written back first: bytes move, tokens do not).
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
                 fetch_timeout_s: Optional[float] = None,
                 fetch_max_retries: int = 2, fetch_backoff_s: float = 0.005,
                 faults: Optional[FaultPlan] = None, device=None):
        SV.check_pageable(cfg)
        if mesh_shards > 1:
            raise SV.UnsupportedShardedConfig(
                cfg, f"offload=True with mesh_shards={mesh_shards}",
                "the tiered host pool is read by single-device kernels; "
                "shard the resident engine (offload=False) instead")
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
        # the host pool pages the global layers' K/V; local layers' rings
        # and media K/V stay slot-local on the device
        glob = SV.pool_layers(cfg)
        self._names = [f"l{i}" for i, g in enumerate(glob) if g]
        self.host = offload_lib.HostKVPool(
            {n: (cfg.num_kv_heads, cfg.head_dim) for n in self._names},
            self.num_blocks, block_size, torch_dtype(cfg),
            pinned=self.device.type == "cuda")
        self.host.fetch_timeout_s = fetch_timeout_s
        self.host.fetch_max_retries = fetch_max_retries
        self.host.fetch_backoff_s = fetch_backoff_s
        self.host.faults = faults
        self._host_kv = [self.host.flat(f"l{i}") if g else None
                         for i, g in enumerate(glob)]
        self._side = (SideStream.create(self.device)
                      if self.overlap and self.device.type == "cuda"
                      else None)
        self.staging = offload_lib.StagingMap(self.num_blocks,
                                              self.num_device_blocks)
        self._touched_last = np.zeros((self.num_blocks,), np.float64)
        self._touch_decay = 0.5
        self._last_prefetch: List[int] = []
        self._zero_fetch_totals()

    def _zero_fetch_totals(self) -> None:
        self.fetch_callbacks = 0          # tiered gathers, all chunks
        self.fetch_retries = 0
        self.fetch_timeouts = 0
        self.fetch_stall_s = 0.0
        self.degraded_steps = 0           # degraded (layer, step) fetches
        self.storm_evictions = 0          # staging blocks flushed by storms

    # ------------------------------------------------------------ admission --
    def _solo_cap(self, plen: int) -> int:
        """Bucketed prefill capacity: power-of-two prompt bucket rounded
        up to whole blocks, never above n_max."""
        b = _bucket(plen, cap=self.n_max)
        return min(self.n_max, -(-b // self.block_size) * self.block_size)

    def _install_solo(self, slot: int, req: Request, state1, tok0) -> None:
        pool1 = SV.pool_entries(state1.caches)
        cap = pool1[0]["kv"].k.shape[1]
        phys = self._phys_row(self._alloc[slot])[:cap // self.block_size]
        for name, lc1 in zip(self._names, pool1):
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
        if self.faults is not None and self.faults.should("staging.storm"):
            # injected eviction storm: flush every staged block (the worst
            # cold start). The evicted blocks ride the write-back list,
            # written before any install reads the host pool, so tokens
            # hold; the required set below stages what the chunk needs.
            for s in range(self.num_device_blocks):
                hb = int(sm.owner[s])
                if hb < 0:
                    continue
                writebacks.append((hb, s))
                sm.dev_map[hb] = -1
                sm.owner[s] = -1
                sm.pinned[s] = False
                sm.ref[s] = False
                sm.free.append(s)
                self.storm_evictions += 1
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
            for name, lc in zip(self._names,
                                SV.pool_entries(self._state.caches)):
                self.host.writeback(name, evs, lc["kv"].k[ss],
                                    lc["kv"].v[ss])
        if installs:
            hbs = np.asarray([h for h, _ in installs], np.int64)
            ss = torch.tensor([s for _, s in installs], device=self.device)
            for name, lc in zip(self._names,
                                SV.pool_entries(self._state.caches)):
                CC.tiered_stage_blocks(lc["kv"], ss,
                                       *self.host.read_blocks(name, hbs))

    def _harvest_fetch_stats(self) -> None:
        """Read the chunk's fetch statistics back (one copy each for the
        summed touch counts and rows): per-request staging hit/miss/byte
        and degraded counters, gather, stall, retry and timeout
        attribution, prefetch-hit accounting, and the exponential-decay
        touch scores that seed the next chunk's prefetch."""
        caches = SV.pool_entries(self._state.caches)
        touched = torch.stack([lc["fetch"]["touched"] for lc in caches]
                              ).sum(0).cpu().numpy()
        rows = torch.stack([lc["fetch"]["rows"] for lc in caches]
                           ).sum(0).cpu().numpy().astype(np.int64)
        uniq = torch.stack([lc["fetch"]["uniq"] for lc in caches]
                           ).sum(0).cpu().numpy()
        calls, retries, timeouts, stall = (
            sum(lc["fetch"][k] for lc in caches)
            for k in ("calls", "retries", "timeouts", "stall"))
        degraded = rows[:, 4]
        dropped = torch.stack([lc["fetch"]["dropped"] for lc in caches]
                              ).sum(0).cpu().numpy()
        # every entry shares (G, hd, dtype): one price per head row and
        # per row; a fill gather reads every kv head of each prefix row
        head_b = self.host.bytes_per_head_row(self._names[0])
        row_b = self.host.bytes_per_row(self._names[0])
        miss_b = rows[:, 2] * head_b + rows[:, 3] * row_b
        uniq_head = int(uniq[0])
        uniq_fill = int(uniq[1]) // self.cfg.num_kv_heads
        uniq_b = uniq_head * head_b + uniq_fill * row_b
        self.fetch_callbacks += calls
        self.fetch_retries += retries
        self.fetch_timeouts += timeouts
        self.fetch_stall_s += stall
        self.degraded_steps += int(degraded.sum())
        self.host.fetch_callbacks += calls
        # a degraded fetch read no host row: the pool counts none for it
        # (the requests' fetched_bytes still count them, as the reference's)
        self.host.fetched_head_rows += int(rows[:, 2].sum() - dropped[0])
        self.host.fetched_fill_rows += int(rows[:, 3].sum() - dropped[1])
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
            req.fetch_stall_s += stall * share
            req.fetch_callbacks += int(round(calls * share))
            req.fetch_retries += int(round(retries * share))
            req.fetch_timeouts += int(round(timeouts * share))
            req.degraded_steps += int(degraded[slot])
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
        self._zero_fetch_totals()

    def _run_chunk(self):
        self._update_staging()
        out = self._decode_chunk(
            torch.from_numpy(self._bt), paged_fused=self.fused,
            dev_map=torch.from_numpy(self.staging.dev_map.copy()),
            host_kv=self._host_kv, side=self._side,
            fetch=None if self.host.faults is None
            else self.host.fetch_attempt)
        self._harvest_fetch_stats()
        return out

    def _clear_device(self, slot: int, dead: List[int]) -> None:
        """Reclaim both tiers of the dead blocks (their last holder left):
        free their staging slots (no write-back: the data is dead), zero
        their metadata, the freed staging blocks and the slot's histogram
        row on the device, and their host copies. A block another slot
        still maps keeps all three: its staging residency, its host bytes
        and the metadata its holders' retrieval reads."""
        blocks = np.asarray(dead, np.int64)
        freed = self.staging.release_host_blocks(blocks)
        meta = torch.from_numpy(blocks).to(self.device)
        stag = torch.tensor(freed, dtype=torch.int64, device=self.device)
        for lc in SV.pool_entries(self._state.caches):
            CC.tiered_clear_blocks(lc["kv"], meta, stag)
            lc["hist"][slot] = 0
        if blocks.size:
            self.host.zero_blocks(blocks)

    def _abort_admit(self, slot: int) -> None:
        """Only a solo admission aborts, before it writes anything; its
        dead blocks still leave staging and get zeroed host copies, so
        neither tier can hand a stale block to its next tenant."""
        dead = self._decref_blocks(slot)
        if dead:
            blocks = np.asarray(dead, np.int64)
            self.staging.release_host_blocks(blocks)
            self.host.zero_blocks(blocks)
        self._release_host(slot, dead)

    # -------------------------------------------------------------- audit --
    def verify_invariants(self, check_hist: bool = True) -> None:
        """The resident engine's audit, then the staging map: it mirrors
        ownership (``dev_map[hb] == s`` ⟺ ``owner[s] == hb``), free staging
        slots are unique and unowned, free + resident ==
        num_device_blocks, and every staged host block is held by some
        slot (has a refcount)."""
        super().verify_invariants(check_hist=check_hist)
        sm = self.staging
        check = self._check
        for hb in np.flatnonzero(sm.dev_map >= 0):
            s = int(sm.dev_map[hb])
            check(int(sm.owner[s]) == int(hb),
                  f"staging slot {s}: owner {int(sm.owner[s])} != dev_map "
                  f"inverse {int(hb)}")
            check(int(hb) in self._refcnt, f"host block {int(hb)} staged "
                  f"but not allocated to any slot")
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

    def close(self) -> None:
        """Release what the fetch policy holds (``HostKVPool.close``: wake
        a fault hook asleep in an attempt). No fetch thread exists, so none
        can outlive the engine. Idempotent."""
        self.host.close()

    def run(self) -> List[Request]:
        done = super().run()
        if self.staging.resident_count() != 0:
            raise RuntimeError("staging leak: the residency map retained "
                               "blocks after the run")
        return done


def _check_shard_device(dist: ShardDist, device: torch.device) -> None:
    """A rank serves on its current CUDA device (the kernels launch on the
    current device's stream), and an NCCL group on cards only."""
    if device.type == "cuda":
        cur = torch.cuda.current_device()
        if device.index is not None and device.index != cur:
            raise ValueError(
                f"rank {dist.rank} serves on {device} but its current CUDA "
                f"device is cuda:{cur}: call torch.cuda.set_device"
                f"({device.index}) first")
    elif dist.backend == "nccl":
        raise ValueError(f"an NCCL process group gathers CUDA tensors only; "
                         f"rank {dist.rank} serves on {device}: use gloo")


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
        media = (None if wave[0].media is None
                 else np.stack([r.media for r in wave]))
        t0 = time.perf_counter()
        logits, state = SV.prefill(self.params, self.cfg, toks, self.n_max,
                                   device=self.device, media=media)
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
