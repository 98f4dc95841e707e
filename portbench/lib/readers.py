"""Helpers the per-layer metric readers share (``metrics/<name>.py``).

A reader takes the run's record and returns a number, or None when the
run holds nothing for it to read (the harness then leaves the metric
out). The record: ``requests`` and ``steps`` of the window (the
driver's), ``t0``/``t1`` the window, ``trace`` (``lib/profile.py``'s
reduction of the profiled part, or None), ``shapes`` (``counts``) and
``setup_s``."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from portbench.counts import work


class MissingKernel(RuntimeError):
    """The profiler's names hold no launch of a kernel the run must have
    launched, or not as many: the metric would read wrong."""


def profiled_steps(rec: Dict) -> List[Dict]:
    return [s for s in rec["steps"] if s.get("profiled")]


def step_rows(step_rec: Dict) -> List[List[Tuple[int, int]]]:
    """The (L, d) rows of each decode step of one ``step_serve``: a row
    that started decoding in it (d0 = 0) decodes its last steps, any
    other its first."""
    n = step_rec["steps"]
    per = [[] for _ in range(n)]
    for L, d0, k in step_rec["rows"]:
        first = n - k if d0 == 0 else 0
        for j in range(k):
            per[first + j].append((L, d0 + j))
    return per


def roofline(rec: Dict, match: str,
             launches: Callable[[work.Shapes, List[Tuple[int, int]]],
                                List[int]]) -> Optional[float]:
    """100 × Σ (each launch's bytes at the chip's bandwidth) ÷ Σ the
    launches' device time, over the profiled steps. ``launches(shapes,
    rows)`` gives one step's launches' bytes for one layer."""
    tr = rec.get("trace")
    if tr is None or not tr["cuda"]:
        return None
    s: work.Shapes = rec["shapes"]
    want: List[int] = []
    for st in profiled_steps(rec):
        for rows in step_rows(st):
            want += launches(s, rows) * s.layers
    if not want:
        return None
    found = [(e - b) for name, b, e in tr["kernels"] if match in name]
    if len(found) != len(want):
        raise MissingKernel(f"{match}: the profiler shows {len(found)} "
                            f"launches, the steps need {len(want)}")
    return 100.0 * (sum(want) / work.PEAK_BYTES) / (sum(found) * 1e-6)


def regions(s: work.Shapes, rows: List[Tuple[int, int]]) -> List[int]:
    """Each batch row's region size at this step (free rows: 0)."""
    regs = [max(work.region(L, d, s.pk)[0] - s.sink, 0) for L, d in rows]
    return regs + [0] * (s.b - len(regs))


def promotes(s: work.Shapes, rows: List[Tuple[int, int]]) -> bool:
    return any(work.region(L, d, s.pk)[1] for L, d in rows)

