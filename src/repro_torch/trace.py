"""Spans: named, timed regions of the serving path, kept in memory.

    from repro_torch import trace
    trace.start()
    ...serve...
    spans = trace.stop()        # [Span], in the order they opened

``span(name, **attrs)`` is a context manager around one region. With
tracing off (the default, and after ``stop()``) it returns one shared
object whose ``__enter__``, ``__exit__`` and ``set`` do nothing: no clock
read, no record, no string built. With tracing on it records ``Span(id,
parent, name, t0_ns, t1_ns, attrs, profiled)`` on ``time.perf_counter_ns``
(the clock of ``Request.token_times``) into a bounded buffer; past its
capacity spans are counted in ``dropped()`` and not kept. The parent is the
innermost span open on the same thread (0: none). While a torch profiler
runs, an open span also opens a ``torch.autograd.profiler.record_function``
range of the same name (``profiled`` True), so the profiler's trace holds
the spans too; ``profiler_offset_ns`` maps the in-memory spans onto the
profiler's time axis from those pairs.

``record(name, t0_s, t1_s, **attrs)`` records a span from two existing
``time.perf_counter()`` stamps (the request spans: ``request.queued``,
``request.prefill``, ``request.decode``, each with the request's ``uid``),
with no clock read of its own and no parent.

A span and its attributes read only values the host already holds: no
span adds a device synchronization or device work. Regions where the host
waits on the device are the spans named ``sync.<what>``.
"""
from __future__ import annotations

import itertools
import statistics
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

DEFAULT_CAPACITY = 1 << 21


class Span(NamedTuple):
    id: int
    parent: int           # the enclosing span's id; 0 for a root
    name: str
    t0_ns: int
    t1_ns: int
    attrs: Dict
    profiled: bool        # a profiler range of the same name was opened


class _Off:
    """The span of tracing off: shared, stateless."""
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Tracer:
    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.records: List[tuple] = []
        self.dropped = 0
        self.ids = itertools.count(1)
        self.local = threading.local()      # .stack: the open spans' ids

    def add(self, rec: tuple) -> None:
        if len(self.records) < self.capacity:
            self.records.append(rec)
        else:
            self.dropped += 1


_tracer: Optional[_Tracer] = None


_now = time.perf_counter_ns
_profiler_enabled = torch.autograd._profiler_enabled


class _Open:
    __slots__ = ("tracer", "name", "attrs", "id", "parent", "stack", "t0",
                 "rf")

    def __init__(self, tracer: _Tracer, name: str, attrs: Dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self) -> "_Open":
        tr = self.tracer
        self.id = next(tr.ids)
        try:
            stack = tr.local.stack
        except AttributeError:
            stack = tr.local.stack = []
        self.parent = stack[-1] if stack else 0
        stack.append(self.id)
        self.stack = stack
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _now()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.stack.pop()
        self.tracer.add((self.id, self.parent, self.name, self.t0, t1,
                         self.attrs, self.rf is not None))
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the region."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager around one region (module docstring)."""
    tr = _tracer
    if tr is None:
        return _OFF
    return _Open(tr, name, attrs)


def record(name: str, t0_s: float, t1_s: float, **attrs) -> None:
    """Record a root span between two ``time.perf_counter()`` stamps."""
    tr = _tracer
    if tr is None:
        return
    tr.add((next(tr.ids), 0, name, int(round(t0_s * 1e9)),
            int(round(t1_s * 1e9)), attrs, False))


def start(capacity: int = DEFAULT_CAPACITY) -> None:
    """Switch tracing on with an empty buffer of ``capacity`` spans."""
    global _tracer
    # the first range of a process takes ~1 ms to open: not inside a span
    with torch.autograd.profiler.record_function("trace.start"):
        pass
    _tracer = _Tracer(capacity)


def stop() -> List[Span]:
    """Switch tracing off → the spans recorded since ``start()``, in the
    order they opened (a span that never closed is not there)."""
    global _tracer
    tr, _tracer = _tracer, None
    if tr is None:
        return []
    return [Span(*r) for r in sorted(tr.records, key=lambda r: r[0])]


def dropped() -> int:
    """Spans not kept since ``start()`` because the buffer was full."""
    return _tracer.dropped if _tracer is not None else 0


def profiler_offset_ns(spans: List[Span], events) -> int:
    """The offset that maps ``perf_counter_ns`` times onto a profiler's
    time axis (``events``: ``torch.profiler.profile(...).events()``, whose
    times are µs from the trace's start): profiler ns = t_ns + offset.

    Each span opened while the profiler ran (``profiled``) is paired, in
    order of opening, with the profiler's range of the same name; the
    offset is the median difference of their midpoints. Raises
    ``ValueError`` when the two sequences disagree."""
    ours = [s for s in spans if s.profiled]
    names = {s.name for s in ours}
    theirs = sorted((e for e in events if e.name in names
                     and e.device_type == torch.autograd.DeviceType.CPU),
                    key=lambda e: e.time_range.start)
    if not ours or len(ours) != len(theirs):
        raise ValueError(f"{len(ours)} profiled spans against "
                         f"{len(theirs)} profiler ranges of their names")
    diffs = []
    for s, e in zip(ours, theirs):
        if s.name != e.name:
            raise ValueError(f"span {s.name!r} paired with range {e.name!r}")
        diffs.append(500.0 * (e.time_range.start + e.time_range.end)
                     - 0.5 * (s.t0_ns + s.t1_ns))
    return int(round(statistics.median(diffs)))

