"""Deterministic, seeded fault injection for the serving stack (a copy of
``repro/serving/faults.py``; pure Python and numpy, so one seed gives the
reference's schedule).

The engines consult a :class:`FaultPlan` at named hook points ("sites"):

* ``"fetch.gather"`` — once per host fetch attempt of the offloaded
  engine: per ParisKV layer and decode step for the winner rows
  (``kind="heads"``), and per layer of a mixed step for the fill's prefix
  rows (``kind="rows"``), before the tiered gather is launched. ``delay``
  sleeps, ``fail`` raises :class:`InjectedFault` (a transient failure the
  retry loop recovers from), ``hang`` blocks until the fetch deadline
  fires (:class:`FetchTimeout`), or for ``hang_s`` without one. Context
  keys for ``match``: ``name`` (the cache entry as the reference names
  it, ``s<stage>.l<layer>``; a stage's repeats share it) and ``kind``.
* ``"staging.storm"`` — at the chunk-boundary staging update; a firing
  spec flushes every resident staging block (write-back and release).
  Moves bytes, never tokens.
* ``"engine.slot"`` — per active slot before its pre-chunk host work; a
  firing spec raises :class:`InjectedFault` attributable to exactly that
  request, which the engine quarantines. Context keys: ``slot``, ``uid``.

Every spec keeps its own visit counter (incremented on each matching
visit) and fires on visits ``after < visit <= after + count``; with
``p < 1`` a per-spec seeded RNG gates each eligible visit, still
reproducibly. The plan records every fired event (:meth:`FaultPlan.fired`).

Unlike the reference, ``apply`` takes an optional ``deadline`` (a
``time.monotonic()`` instant): the port has no fetch worker to abandon,
so the deadline bounds the hook's own sleeps and ends the attempt with
:class:`FetchTimeout` when it fires.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


class InjectedFault(RuntimeError):
    """An injected fault fired. On the fetch path this is a *transient*
    error (retried with backoff, then degraded); at engine sites it is
    attributable to one slot and triggers quarantine."""


class FetchTimeout(TimeoutError):
    """A fetch attempt's deadline fired inside an injected delay or hang:
    the attempt is abandoned (counted as a timeout) and retried."""


@dataclass
class FaultSpec:
    """One fault: where (``site`` + optional ``match`` on the hook's
    context), when (visits ``after < v <= after + count``, optionally
    thinned by probability ``p``), and what (``kind``).

    Kinds: ``"delay"`` (sleep ``delay_s`` then proceed), ``"fail"``
    (raise :class:`InjectedFault`), ``"hang"`` (block up to ``hang_s``
    or until the caller's abort event is set or its deadline fires — a
    dead fetch), and ``"storm"`` (only meaningful at boolean sites like
    ``"staging.storm"``)."""

    site: str
    kind: str = "fail"
    after: int = 0
    count: Optional[int] = 1       # None = every matching visit
    delay_s: float = 0.0
    hang_s: float = 60.0
    p: float = 1.0
    match: Optional[Dict[str, Any]] = None
    message: str = ""

    def __post_init__(self):
        if self.kind not in ("delay", "fail", "hang", "storm"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclass
class FiredEvent:
    site: str
    kind: str
    visit: int
    ctx: Dict[str, Any] = field(default_factory=dict)


class FaultPlan:
    """A seeded, thread-safe schedule of :class:`FaultSpec`\\ s.

    Hook points call :meth:`apply` (delay/fail/hang semantics) or
    :meth:`should` (boolean sites — storms); both count visits and log
    fired events identically. One plan may be shared by the host pool
    and the engine."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._lock = threading.Lock()
        self._visits = [0] * len(self.specs)
        self._rng = [np.random.RandomState(seed * 1009 + i)
                     for i in range(len(self.specs))]
        self._events: List[FiredEvent] = []

    # -- bookkeeping ----------------------------------------------------
    def reset(self) -> None:
        with self._lock:
            self._visits = [0] * len(self.specs)
            self._rng = [np.random.RandomState(self.seed * 1009 + i)
                         for i in range(len(self.specs))]
            self._events.clear()

    def fired(self, site: Optional[str] = None,
              kind: Optional[str] = None) -> List[FiredEvent]:
        with self._lock:
            return [e for e in self._events
                    if (site is None or e.site == site)
                    and (kind is None or e.kind == kind)]

    def _firing(self, site: str, ctx: Dict[str, Any]) -> List[FaultSpec]:
        """Count this visit against every matching spec and return the
        specs that fire on it (logged)."""
        out = []
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if spec.match and any(ctx.get(k) != v
                                      for k, v in spec.match.items()):
                    continue
                self._visits[i] += 1
                v = self._visits[i]
                if v <= spec.after:
                    continue
                if spec.count is not None and v > spec.after + spec.count:
                    continue
                if spec.p < 1.0 and self._rng[i].rand() >= spec.p:
                    continue
                self._events.append(
                    FiredEvent(site, spec.kind, v, dict(ctx)))
                out.append(spec)
        return out

    # -- hook-point API -------------------------------------------------
    def should(self, site: str, **ctx) -> bool:
        """Boolean hook (e.g. staging storms): True when any spec fires
        on this visit."""
        return bool(self._firing(site, ctx))

    def apply(self, site: str, abort: Optional[threading.Event] = None,
              deadline: Optional[float] = None, **ctx) -> None:
        """Imperative hook: sleeps for ``delay`` specs, blocks for
        ``hang`` specs (until ``abort`` is set or ``hang_s`` elapses,
        then raises — the abandoned attempt must not look successful),
        raises :class:`InjectedFault` for ``fail`` specs. A sleep that
        reaches ``deadline`` (``time.monotonic()`` seconds) stops there
        and raises :class:`FetchTimeout`."""
        for spec in self._firing(site, ctx):
            if spec.kind == "delay":
                _sleep_within(spec.delay_s, abort, deadline, site)
            elif spec.kind == "hang":
                _sleep_within(spec.delay_s or spec.hang_s, abort, deadline,
                              site)
                raise InjectedFault(
                    spec.message or f"injected worker hang at {site}")
            elif spec.kind == "fail":
                raise InjectedFault(
                    spec.message or f"injected fault at {site}")
            # "storm" specs are inert under apply(); they drive should()


def _interruptible_sleep(seconds: float,
                         abort: Optional[threading.Event]) -> None:
    if seconds <= 0:
        return
    if abort is None:
        time.sleep(seconds)
    else:
        abort.wait(seconds)


def _sleep_within(seconds: float, abort: Optional[threading.Event],
                  deadline: Optional[float], site: str) -> None:
    """Sleep ``seconds``, or up to ``deadline`` and raise
    :class:`FetchTimeout` when the deadline comes first."""
    if deadline is not None:
        left = deadline - time.monotonic()
        if seconds >= left:
            _interruptible_sleep(left, abort)
            raise FetchTimeout(f"fetch deadline fired at {site}")
    _interruptible_sleep(seconds, abort)
