"""The program's spans (``repro_torch.trace``) read beside a traced run.

A run with program tracing on records spans from process set-up to its
end (``portbench/traced.py``). Those that fell in the profiled part of the
window also opened ``record_function`` ranges, so
``trace.profiler_offset_ns`` puts every span on the profiler's time axis,
where the device's kernels are. Each device activity is put down to the
innermost span open when the host launched it: the profiler links the
activity to its launching runtime call (``cuda*`` / ``cu*``) by
correlation id, or else to the torch op that issued it.

Here: that reduction (``profiled``), the four per-layer readings that
need spans (``host_issue_ms_per_step``, ``sync_wait_ms_per_step``,
``tier_table_us_per_step``, ``admit_to_first_token_ms``), the ten longest
idle gaps named by span path, and the stderr table of every span name.
Spans are ``repro_torch.trace.Span``s; ``t_window`` and ``t_profiled``
are the window's start and the profiled part's end on
``time.perf_counter`` (seconds)."""
from __future__ import annotations

import bisect
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

from portbench.lib import profile
from repro_torch import trace

_RUNTIME = ("cuda", "cu")


class MissingSpan(RuntimeError):
    """A profiled decode step lacks a span the reading needs: the reading
    would be wrong."""


# ------------------------------------------------------------- the tree --
def calls(spans) -> list:
    """The spans on the host's call stack (every span but the request
    spans, which ``trace.record`` adds from stamps)."""
    return [s for s in spans if not s.name.startswith("request.")]


def ancestor(by_id: Dict, s, name: str):
    """The nearest enclosing span of ``name`` (or None)."""
    while s.parent:
        s = by_id[s.parent]
        if s.name == name:
            return s
    return None


def paths(spans) -> Dict[int, str]:
    """Span id → its path of names from the root, '/'-joined."""
    out: Dict[int, str] = {}
    for s in spans:                      # parents open before children
        out[s.id] = (out[s.parent] + "/" if s.parent in out else "") + s.name
    return out


def innermost(spans_us: List[Tuple[float, float, int]],
              times: List[float]) -> List[Optional[int]]:
    """For each time (µs, any order) the id of the innermost span open at
    it, from ``spans_us`` [(t0, t1, id)] that nest (one thread)."""
    order = sorted(range(len(times)), key=times.__getitem__)
    spans_us = sorted(spans_us, key=lambda x: (x[0], -x[1]))
    out: List[Optional[int]] = [None] * len(times)
    stack: List[Tuple[float, float, int]] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(spans_us) and spans_us[j][0] <= t:
            while stack and stack[-1][1] < spans_us[j][0]:
                stack.pop()
            stack.append(spans_us[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


# ---------------------------------------------------- the profiled part --
def device_activities(events, names=frozenset()
                      ) -> List[Tuple[str, float, float, Optional[float]]]:
    """Every device activity of a ``torch.profiler`` run as (name, start
    µs, end µs, the host time µs of its launch or None). The profiler
    also lays each ``record_function`` range that launched device work on
    the device's timeline (a user annotation): those, and any device
    event named as one of ``names``, are not device activities."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    runtime, ops = {}, {}
    dev = []
    for e in events:
        if e.device_type == cpu:
            if e.name.startswith(_RUNTIME):
                runtime[e.id] = e.time_range.start
            else:
                ops.setdefault(e.id, e.time_range.start)
        elif not (e.name in names or getattr(e, "is_user_annotation",
                                             False)):
            dev.append(e)
    out = []
    for e in dev:
        t = runtime.get(e.id)
        if t is None:
            t = ops.get(getattr(e, "linked_correlation_id", 0) or -1)
        out.append((e.name, e.time_range.start, e.time_range.end, t))
    return out


def busy_us(acts) -> float:
    """The union of the device activities' intervals (µs)."""
    busy, cur_s, cur_e = 0.0, None, None
    for _, s, e, _ in sorted(acts, key=lambda a: a[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def idle_gaps(acts) -> List[Tuple[float, float]]:
    """The intervals (µs) between device activities, as
    ``profile.Profiled.reduce`` takes them."""
    gaps, cur_e = [], None
    for _, s, e, _ in sorted(acts, key=lambda a: a[1]):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def profiled(spans, events) -> Dict:
    """The profiled part with the spans on its clock → {"offset_ns",
    "spans_us": {id: (t0, t1)} of the call spans the part holds,
    "acts": [(name, start, end, launching span id or None)], "gaps"}."""
    import torch
    off = trace.profiler_offset_ns(spans, events)
    ours = {s.name for s in spans}
    acts = device_activities(events, ours)
    lo = min((a[1] for a in acts), default=0.0)
    hi = max((a[2] for a in acts), default=0.0)
    sp = {s.id: ((s.t0_ns + off) / 1e3, (s.t1_ns + off) / 1e3)
          for s in calls(spans)}
    sp = {i: t for i, t in sp.items() if t[1] >= lo and t[0] <= hi}
    launched = [a[3] for a in acts]
    known = [i for i, t in enumerate(launched) if t is not None]
    who = innermost([(t0, t1, i) for i, (t0, t1) in sp.items()],
                    [launched[i] for i in known])
    owner: List[Optional[int]] = [None] * len(acts)
    for i, w in zip(known, who):
        owner[i] = w
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.name not in ours]
    return {"offset_ns": off, "spans_us": sp, "host": host,
            "acts": [(a[0], a[1], a[2], w) for a, w in zip(acts, owner)],
            "gaps": idle_gaps(acts)}


def named_gaps(spans, part: Dict, n: int = 10) -> List[list]:
    """The ``n`` longest idle gaps, each named '<span path> | <host op>':
    the innermost span and the innermost host op at its middle."""
    longest = sorted(part["gaps"], key=lambda g: g[0] - g[1])[:n]
    by_op = profile._name_gaps(longest, list(part["host"]))
    where = innermost([(t0, t1, i) for i, (t0, t1)
                       in part["spans_us"].items()],
                      [0.5 * (s + e) for s, e in longest])
    p = paths(spans)
    return [[f"{p.get(w, 'no span')} | {op}", sec]
            for w, (op, sec) in zip(where, by_op)]


def idle_in_spans_pct(spans, part: Dict) -> Optional[float]:
    """Share of the profiled part's idle time inside a root call span."""
    total = sum(e - s for s, e in part["gaps"])
    if not total:
        return None
    root = {s.id for s in spans if not s.parent}
    roots = sorted(t for i, t in part["spans_us"].items() if i in root)
    starts = [r[0] for r in roots]
    inside = 0.0
    for s, e in part["gaps"]:
        j = bisect.bisect_left(starts, e) - 1
        while j >= 0 and roots[j][1] > s:      # roots are disjoint, in order
            inside += min(e, roots[j][1]) - max(s, roots[j][0])
            j -= 1
    return 100.0 * inside / total


# -------------------------------------------------------------- windows --
def _ns(t_s: float) -> int:
    return int(round(t_s * 1e9))


def decode_steps(spans, lo_s: float, hi_s: float) -> list:
    """The ``decode.step`` spans of the engine steps that started in
    [lo_s, hi_s)."""
    by_id = {s.id: s for s in spans}
    lo, hi = _ns(lo_s), _ns(hi_s)
    return [s for s in spans if s.name == "decode.step"
            and lo <= ancestor(by_id, s, "engine.step").t0_ns < hi]


def _steps_after(spans, t_profiled: float):
    by_id = {s.id: s for s in spans}
    lo = _ns(t_profiled)
    eng = {s.id for s in spans if s.name == "engine.step" and s.t0_ns >= lo}
    return by_id, eng


def host_issue_ms_per_step(spans, t_profiled: float) -> Optional[float]:
    """Σ over the decode steps of the engine steps after the profiled
    part of (the step's time − its ``sync.*`` spans) ÷ those steps."""
    by_id, eng = _steps_after(spans, t_profiled)
    steps = [s for s in spans if s.name == "decode.step"
             and ancestor(by_id, s, "engine.step").id in eng]
    if not steps:
        return None
    ids = {s.id for s in steps}
    waits = sum(s.t1_ns - s.t0_ns for s in spans
                if s.name.startswith("sync.")
                and (a := ancestor(by_id, s, "decode.step")) is not None
                and a.id in ids)
    return (sum(s.t1_ns - s.t0_ns for s in steps) - waits) / len(steps) / 1e6


def sync_wait_ms_per_step(spans, t_profiled: float) -> Optional[float]:
    """Σ ``sync.*`` in the engine steps after the profiled part (their
    decode steps and their chunks' collection) ÷ their decode steps."""
    by_id, eng = _steps_after(spans, t_profiled)
    n = sum(1 for s in spans if s.name == "decode.step"
            and ancestor(by_id, s, "engine.step").id in eng)
    if not n:
        return None
    waits = sum(s.t1_ns - s.t0_ns for s in spans
                if s.name.startswith("sync.")
                and (a := ancestor(by_id, s, "engine.step")) is not None
                and a.id in eng)
    return waits / n / 1e6


def tier_table_us_per_step(spans, part: Dict, t_window: float,
                           t_profiled: float, layers: int) -> Optional[float]:
    """Device µs of the kernels launched in ``retrieve.tier_table`` ÷ the
    profiled decode steps. A profiled decode step without ``layers``
    tier-table spans raises ``MissingSpan``."""
    steps = decode_steps(spans, t_window, t_profiled)
    if not steps:
        return None
    by_id = {s.id: s for s in spans}
    ids = {s.id for s in steps}
    per = dict.fromkeys(ids, 0)
    tables = set()
    for s in spans:
        if s.name == "retrieve.tier_table":
            a = ancestor(by_id, s, "decode.step")
            if a is not None and a.id in ids:
                per[a.id] += 1
                tables.add(s.id)
    short = [i for i, k in per.items() if k != layers]
    if short:
        raise MissingSpan(f"{len(short)} profiled decode steps lack "
                          f"{layers} retrieve.tier_table spans")
    dev = sum(e - b for _, b, e, w in part["acts"] if w in tables)
    return dev / len(steps)


def admit_to_first_token_ms(spans, t_window: float) -> Optional[float]:
    """Median ``request.prefill`` of set-up's shared-prefix admissions."""
    shared = {s.attrs["uid"] for s in spans if s.name == "engine.admit"
              and s.attrs.get("shared", 0) > 0}
    end = _ns(t_window)
    ms = [(s.t1_ns - s.t0_ns) / 1e6 for s in spans
          if s.name == "request.prefill" and s.attrs["uid"] in shared
          and s.t1_ns <= end]
    return statistics.median(ms) if ms else None


def summary(spans, t_window: float) -> Dict:
    """What the readings above leave unread, in set-up and in the window:
    engine steps with a filling slot and the median rows decoding
    (``engine.step``), mixed decode steps (``decode.step``), and the
    median of each request span by its end; layers a decode step
    (``layer`` index) and the candidates and winners a retrieval
    (``retrieve`` C, k)."""
    w = _ns(t_window)
    out: Dict = {}
    for part, keep in (("setup", lambda s: s.t0_ns < w),
                       ("window", lambda s: s.t0_ns >= w)):
        eng = [s for s in spans if s.name == "engine.step" and keep(s)]
        out[part] = dict(
            engine_steps=len(eng),
            filling_steps=sum(s.attrs.get("filling") is not None
                              for s in eng),
            median_rows=statistics.median(s.attrs["rows"] for s in eng
                                          if "rows" in s.attrs)
            if any("rows" in s.attrs for s in eng) else None,
            mixed_steps=sum(1 for s in spans if s.name == "decode.step"
                            and keep(s) and s.attrs.get("mixed")))
        for name in ("request.queued", "request.prefill", "request.decode"):
            ms = [(s.t1_ns - s.t0_ns) / 1e6 for s in spans
                  if s.name == name and (s.t1_ns < w) == (part == "setup")]
            out[part][name + "_ms"] = statistics.median(ms) if ms else None
    out["layers"] = 1 + max((s.attrs["index"] for s in spans
                             if s.name == "layer"), default=-1)
    out["retrieve"] = sorted({(s.attrs["C"], s.attrs["k"]) for s in spans
                              if s.name == "retrieve"})
    return out


# ---------------------------------------------------------------- table --
def table(spans, part: Optional[Dict], t_window: float,
          t_profiled: Optional[float]) -> List[Dict]:
    """One row per span name, a decode step: host ms in set-up, host ms
    (inclusive and self) and spans in the window after the profiled part,
    and device ms and launches in the profiled part (inclusive: a device
    activity counts for its launching span and every enclosing one)."""
    by_id = {s.id: s for s in spans}
    cs = calls(spans)
    w = _ns(t_window)
    n_set = sum(1 for s in cs if s.name == "decode.step" and s.t0_ns < w)
    _, eng = _steps_after(spans, t_window if t_profiled is None
                          else t_profiled)
    top = {}

    def in_window(s):
        if s.id not in top:
            r = s if s.name == "engine.step" else ancestor(by_id, s,
                                                           "engine.step")
            top[s.id] = r is not None and r.id in eng
        return top[s.id]
    n_win = sum(1 for s in cs if s.name == "decode.step" and in_window(s))
    kid = {}
    for s in cs:
        if s.parent:
            kid[s.parent] = kid.get(s.parent, 0) + s.t1_ns - s.t0_ns
    rows: Dict[str, Dict] = {}
    for s in cs:
        r = rows.setdefault(s.name, dict(name=s.name, setup_ms=0.0,
                                         window_ms=0.0, self_ms=0.0,
                                         calls=0, device_ms=0.0,
                                         launches=0))
        d = (s.t1_ns - s.t0_ns) / 1e6
        if s.t0_ns < w:
            r["setup_ms"] += d
        elif in_window(s):
            r["window_ms"] += d
            r["self_ms"] += d - kid.get(s.id, 0) / 1e6
            r["calls"] += 1
    n_prof = 0
    if part is not None and t_profiled is not None:
        n_prof = len(decode_steps(spans, t_window, t_profiled))
        for name, b, e, who in part["acts"]:
            s = by_id.get(who)
            while s is not None:
                r = rows[s.name]
                r["device_ms"] += (e - b) / 1e3
                r["launches"] += not name.startswith(("Memcpy", "Memset"))
                s = by_id.get(s.parent)
    for r in rows.values():
        r["setup_ms"] /= max(n_set, 1)
        for k in ("window_ms", "self_ms", "calls"):
            r[k] /= max(n_win, 1)
        for k in ("device_ms", "launches"):
            r[k] /= max(n_prof, 1)
    return sorted(rows.values(), key=lambda r: -r["window_ms"])


def format_table(rows: Iterable[Dict]) -> str:
    head = (f"{'span':<24}{'setup ms':>10}{'window ms':>11}{'self ms':>10}"
            f"{'calls':>9}{'device ms':>11}{'launches':>10}   (a decode "
            f"step; window: after the profiled part)")
    lines = [head]
    for r in rows:
        lines.append(f"{r['name']:<24}{r['setup_ms']:>10.3f}"
                     f"{r['window_ms']:>11.3f}{r['self_ms']:>10.3f}"
                     f"{r['calls']:>9.2f}{r['device_ms']:>11.3f}"
                     f"{r['launches']:>10.1f}")
    return "\n".join(lines)
