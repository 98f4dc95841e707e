"""Host tier of the offloaded paged pool (port of ``repro/serving/offload.py``
without its fetch front ends).

The tiered pool (``core.cache.init_tiered_cache``) keeps the retrieval
metadata on the device but bounds the device K/V to ``num_device_blocks``
staging blocks. This module owns the host side:

* :class:`HostKVPool` — the full K/V block pool, one (k, v) pair of
  ``(num_blocks, block_size, G, hd)`` tensors per ParisKV layer. On a card
  they are **pinned** host memory (``pin_memory=True``): under unified
  virtual addressing the tiered winner gather
  (``kernels/gather_kv:gather_heads_tiered``) reads a missed winner's row
  straight from it over PCIe, in the same launch that reads the staged
  winners from HBM. On the CPU they are plain tensors.
* :class:`StagingMap` — the device-residency policy, a copy of the
  reference's: ``dev_map`` (num_blocks,) int32 maps host block → staging
  block (-1 = not staged); slots come from a free list, then from a
  second-chance clock over unpinned slots.

The reference's ``EntryFetch``, ``PipelinedEntryFetch`` and
``FetchPipeline`` are not ported: they exist because XLA reaches host
memory only through host callbacks. Here the kernel reads it, and the
overlap of that read with the dense attention work is a CUDA side stream
(``models/layers.py:attn_decode_pariskv_tiered``).

The pool also owns the reference's **fetch policy**
(:meth:`HostKVPool.fetch_attempt`). A launched kernel cannot be abandoned,
so on the port a fetch *attempt* is the host work before the launch — the
``fetch.gather`` fault hook — and the deadline bounds that work; there is
no fetch worker thread.

The pool is mutated only between decode chunks (admission, write-back,
eviction). On a card every mutating method first synchronizes the device,
so no kernel of an earlier chunk can still be reading the rows it writes.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.faults import FetchTimeout, InjectedFault


class HostIndexError(IndexError):
    """A host-pool mutation was handed an out-of-range block index.
    Raised instead of letting negative indexing silently wrap into some
    other request's blocks."""

    def __init__(self, entry: str, method: str, index: int,
                 num_blocks: int):
        self.entry = entry
        self.method = method
        self.index = int(index)
        self.num_blocks = num_blocks
        super().__init__(
            f"HostKVPool.{method}: block index {int(index)} out of range "
            f"[0, {num_blocks}) for entry {entry!r}")


def _check_host_blocks(entry: str, method: str, blocks: np.ndarray,
                       num_blocks: int) -> None:
    blocks = np.asarray(blocks)
    bad = blocks[(blocks < 0) | (blocks >= num_blocks)]
    if bad.size:
        raise HostIndexError(entry, method, int(bad.flat[0]), num_blocks)


def pinned_bytes_held(nbytes: int) -> int:
    """Bytes PyTorch's pinned caching allocator holds for a request of
    ``nbytes``: it rounds every allocation up to a power of two."""
    return 1 << max(int(nbytes) - 1, 0).bit_length()


class HostKVPool:
    """Full K/V block pool in host memory.

    ``shapes``: {entry_name: (G, hd)} for every ParisKV layer; all entries
    share ``num_blocks`` / ``block_size`` / ``dtype``. ``pinned`` allocates
    page-locked memory (a card must be present); otherwise the tensors are
    ordinary CPU tensors, which the CPU engine reads with the plain
    version of the tiered gather.

    Row counters, advanced by the engine from each chunk's fetch
    statistics: ``fetched_head_rows`` missed winner head rows,
    ``fetched_fill_rows`` fill prefix rows read from the pool, their
    distinct counts ``fetched_unique_head_rows`` /
    ``fetched_unique_fill_rows`` (what the deduplicating gather read),
    and ``fetch_callbacks`` the tiered gathers issued.

    Fetch policy (the reference's defaults): ``fetch_timeout_s`` (per
    attempt deadline; None or 0 disables it), ``fetch_max_retries`` and
    ``fetch_backoff_s`` (bounded exponential backoff), ``faults`` (a
    ``FaultPlan`` consulted once per attempt). Its counters:
    ``fetch_retries``, ``fetch_timeouts``, ``degraded_fetches`` (fetches
    that exhausted their retries), ``abandoned_attempts`` (attempts a
    deadline ended: the reference's worker respawns) and ``fetch_stall_s``
    (host seconds spent in the policy)."""

    def __init__(self, shapes: Dict[str, tuple], num_blocks: int,
                 block_size: int, dtype: torch.dtype, pinned: bool = False):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.dtype = dtype
        self.pinned = pinned
        self.k: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self._heads: Dict[str, tuple] = {}
        for name, (G, hd) in shapes.items():
            shape = (num_blocks, block_size, G, hd)
            self.k[name] = torch.zeros(shape, dtype=dtype, pin_memory=pinned)
            self.v[name] = torch.zeros(shape, dtype=dtype, pin_memory=pinned)
            self._heads[name] = (G, hd)
        self.fetch_timeout_s: Optional[float] = None
        self.fetch_max_retries = 2
        self.fetch_backoff_s = 0.005
        self.faults = None
        self.abandoned_attempts = 0
        # wakes a sleeping fault hook when the pool is closed
        self._abort = threading.Event()
        self.reset_counters()

    def reset_counters(self) -> None:
        self.fetched_head_rows = 0
        self.fetched_fill_rows = 0
        self.fetched_unique_head_rows = 0
        self.fetched_unique_fill_rows = 0
        self.fetch_callbacks = 0
        self.fetch_retries = 0
        self.fetch_timeouts = 0
        self.degraded_fetches = 0
        self.fetch_stall_s = 0.0

    @property
    def closed(self) -> bool:
        return self._abort.is_set()

    def close(self) -> None:
        """Release what the fetch policy holds: wake any fault hook asleep
        in an attempt (a hang then ends at once, and so does any later
        one). No thread is ever started, so nothing is joined.
        Idempotent."""
        self._abort.set()

    # -- fetch policy ---------------------------------------------------
    def fetch_attempt(self, name: str, kind: str
                      ) -> Tuple[bool, int, int, float]:
        """One host fetch under the policy, run before its gather is
        launched (``FetchPipeline._collect_np`` / ``gather_guarded`` of
        the reference). An attempt is the ``fetch.gather`` hook with
        ``name`` and ``kind``; ``fail`` is retried after
        ``fetch_backoff_s · 2^(attempt-1)``, a sleep that reaches the
        ``fetch_timeout_s`` deadline counts a timeout and is retried, and
        after ``fetch_max_retries`` re-issues the fetch gives up.
        → (ok, retries, timeouts, stall seconds); with no fault plan
        (nothing can fail before the launch) (True, 0, 0, 0.0)."""
        if self.faults is None:
            return True, 0, 0, 0.0
        t0 = time.perf_counter()
        retries = timeouts = attempt = 0
        ok = True
        while True:
            deadline = (time.monotonic() + self.fetch_timeout_s
                        if self.fetch_timeout_s else None)
            try:
                self.faults.apply("fetch.gather", abort=self._abort,
                                  deadline=deadline, name=name, kind=kind)
                break
            except FetchTimeout:
                timeouts += 1
                self.abandoned_attempts += 1
            except InjectedFault:
                pass                     # transient: retry below
            if attempt >= self.fetch_max_retries:
                ok = False
                self.degraded_fetches += 1
                break
            attempt += 1
            retries += 1
            if self.fetch_backoff_s:
                time.sleep(self.fetch_backoff_s * (2 ** (attempt - 1)))
        stall = time.perf_counter() - t0
        self.fetch_retries += retries
        self.fetch_timeouts += timeouts
        self.fetch_stall_s += stall
        return ok, retries, timeouts, stall

    @property
    def nbytes(self) -> int:
        """Bytes of K/V the pool stores."""
        return sum(t.numel() * t.element_size()
                   for d in (self.k, self.v) for t in d.values())

    @property
    def held_bytes(self) -> int:
        """Host bytes the pool holds: ``nbytes`` for plain tensors, each
        tensor rounded up to a power of two when pinned."""
        if not self.pinned:
            return self.nbytes
        return sum(pinned_bytes_held(t.numel() * t.element_size())
                   for d in (self.k, self.v) for t in d.values())

    def _quiesce(self) -> None:
        """Wait for every kernel that may still read the pinned pool."""
        if self.pinned:
            torch.cuda.synchronize()

    def zero_all(self) -> None:
        self._quiesce()
        for d in (self.k, self.v):
            for t in d.values():
                t.zero_()

    def flat(self, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(num_blocks·block_size, G, hd) row views of one entry."""
        n = self.num_blocks * self.block_size
        return (self.k[name].view((n,) + self.k[name].shape[2:]),
                self.v[name].view((n,) + self.v[name].shape[2:]))

    def bytes_per_head_row(self, name: str) -> int:
        """K+V bytes one fetched winner row moves (per kv head)."""
        _, hd = self._heads[name]
        return 2 * hd * self.k[name].element_size()

    def bytes_per_row(self, name: str) -> int:
        """K+V bytes one fetched full row (all kv heads) moves."""
        G, hd = self._heads[name]
        return 2 * G * hd * self.k[name].element_size()

    # -- engine-side mutation (only ever between chunks) ----------------
    def write_prefill(self, name: str, phys_blocks: np.ndarray,
                      k_rows: torch.Tensor, v_rows: torch.Tensor) -> None:
        """Install a solo prefill's prompt K/V: k/v_rows (n_logical, G, hd)
        on any device, phys_blocks (n_logical // bs,) host block per
        logical block (≥ num_blocks = pad sentinel, skipped; a negative
        index raises)."""
        bs = self.block_size
        pb = np.asarray(phys_blocks)
        if np.any(pb < 0):
            raise HostIndexError(name, "write_prefill",
                                 int(pb[pb < 0].flat[0]), self.num_blocks)
        sel = np.flatnonzero(pb < self.num_blocks)
        nblk = k_rows.shape[0] // bs
        self._quiesce()
        dst = torch.from_numpy(pb[sel].astype(np.int64))
        src = torch.from_numpy(sel.astype(np.int64))
        for pool, rows in ((self.k[name], k_rows), (self.v[name], v_rows)):
            view = rows.reshape((nblk, bs) + rows.shape[1:])
            pool[dst] = view[src.to(view.device)].to("cpu", self.dtype)

    def writeback(self, name: str, host_blocks: np.ndarray,
                  k_blocks: torch.Tensor, v_blocks: torch.Tensor) -> None:
        """Staging → host write-back before a staging slot is recycled:
        k/v_blocks (n, bs, G, hd) on any device, for host blocks (n,)."""
        _check_host_blocks(name, "writeback", host_blocks, self.num_blocks)
        self._quiesce()
        dst = torch.from_numpy(np.asarray(host_blocks, np.int64))
        self.k[name][dst] = k_blocks.to("cpu", self.dtype)
        self.v[name][dst] = v_blocks.to("cpu", self.dtype)

    def read_blocks(self, name: str, host_blocks: np.ndarray
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host → staging payloads (n, bs, G, hd) for installation."""
        _check_host_blocks(name, "read_blocks", host_blocks,
                           self.num_blocks)
        src = torch.from_numpy(np.asarray(host_blocks, np.int64))
        return self.k[name][src], self.v[name][src]

    def zero_blocks(self, host_blocks: np.ndarray) -> None:
        """Scrub dead blocks' host bytes (every entry)."""
        name0 = next(iter(self.k), "")
        _check_host_blocks(name0, "zero_blocks", host_blocks,
                           self.num_blocks)
        self._quiesce()
        dst = torch.from_numpy(np.asarray(host_blocks, np.int64))
        for d in (self.k, self.v):
            for t in d.values():
                t[dst] = 0


class StagingMap:
    """Device-residency map + second-chance/LRU staging allocator (a copy
    of the reference's: pure numpy, frozen for the length of a chunk).

    All state is host-side; ``dev_map`` is uploaded to the device once per
    decode chunk."""

    def __init__(self, num_blocks: int, num_device_blocks: int):
        self.num_blocks = num_blocks
        self.num_device_blocks = num_device_blocks
        self.dev_map = np.full((num_blocks,), -1, np.int32)
        self.owner = np.full((num_device_blocks,), -1, np.int32)
        self.pinned = np.zeros((num_device_blocks,), bool)
        self.ref = np.zeros((num_device_blocks,), bool)
        self.free = deque(range(num_device_blocks))
        self._clock = 0

    def resident(self, host_block: int) -> bool:
        return self.dev_map[host_block] >= 0

    def unpin_all(self) -> None:
        self.pinned[:] = False

    def pin(self, host_block: int) -> None:
        s = int(self.dev_map[host_block])
        assert s >= 0, f"pin of non-resident host block {host_block}"
        self.pinned[s] = True
        self.ref[s] = True

    def touch(self, host_blocks) -> None:
        """Second-chance reference bits for blocks the last chunk read."""
        hbs = np.atleast_1d(np.asarray(host_blocks, np.int64))
        if hbs.size == 0:
            return
        slots = self.dev_map[hbs]
        self.ref[slots[slots >= 0]] = True

    def acquire(self) -> Optional[Tuple[int, int]]:
        """One staging slot: free list first, else second-chance clock
        over unpinned slots (a set ref bit buys one more lap). Returns
        (slot, evicted_host_block or -1); None when every slot is
        pinned."""
        if self.free:
            return self.free.popleft(), -1
        n = self.num_device_blocks
        for _ in range(2 * n + 1):
            s = self._clock
            self._clock = (self._clock + 1) % n
            if self.pinned[s]:
                continue
            if self.ref[s]:
                self.ref[s] = False
                continue
            hb = int(self.owner[s])
            if hb >= 0:
                self.dev_map[hb] = -1
            self.owner[s] = -1
            return s, hb
        return None

    def acquire_batch(self, n: int) -> List[Tuple[int, int]]:
        """Up to ``n`` staging slots in one call; shorter when the clock
        runs out of unpinned victims. Acquired slots stay pinned until the
        batch completes, so one lap cannot hand the same slot out twice."""
        out = []
        for _ in range(n):
            got = self.acquire()
            if got is None:
                break
            self.pinned[got[0]] = True
            out.append(got)
        for s, _ in out:
            self.pinned[s] = False
            self.ref[s] = True
        return out

    def install(self, host_block: int, slot: int) -> None:
        self.dev_map[host_block] = slot
        self.owner[slot] = host_block
        self.ref[slot] = True

    def release_host_blocks(self, host_blocks) -> list:
        """Eviction/cancel path: free the staging slots owned by dead host
        blocks (their data is dead — no write-back). Returns the freed
        staging slot ids so the engine can zero them on the device."""
        slots = []
        for hb in np.atleast_1d(host_blocks):
            s = int(self.dev_map[int(hb)])
            if s >= 0:
                self.dev_map[int(hb)] = -1
                self.owner[s] = -1
                self.pinned[s] = False
                self.ref[s] = False
                self.free.append(s)
                slots.append(s)
        return slots

    def resident_count(self) -> int:
        return int((self.owner >= 0).sum())
