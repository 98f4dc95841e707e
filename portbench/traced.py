"""One traced run of a cell with the program's spans on: ``run.py --trace
1``'s run and result line, plus what the spans read.

    python3 portbench/traced.py --workload <cell> --seed <n> \
        --seconds <s> [--spans 0|1]

With ``--spans 1`` (the default) ``repro_torch.trace`` records from
before set-up to the end of the window; ``--spans 0`` leaves it off, for
the comparison of the same run without spans. The run is ``run.py``'s
``run_cell`` with ``trace`` on; its profiler is kept, so that the
profiled part's device activities can be put down to the spans that
launched them (``lib/spans.py``). The result line adds ``spans``: the
four span readings (``host_issue_ms_per_step``, ``sync_wait_ms_per_step``,
``tier_table_us_per_step``, ``admit_to_first_token_ms``), the ten
longest idle gaps named by span path, the share of idle time inside a
span and of device time put down to a span, the device's idle share with
the spans' own device annotations left out, device-to-host copies and
launches a profiled decode step, what no reading uses
(``spans.summary``), the median engine step of the window after the
profiled part, each set-up engine step's ms, and the spans dropped.
Standard error ends with the table of every span name
(``spans.format_table``). Without a CUDA card it exits with an error,
as ``run.py`` does."""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
for p in (REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from portbench import run  # noqa: E402
from portbench.lib import guard, profile, spec  # noqa: E402
from portbench.lib import spans as S  # noqa: E402
from repro_torch import trace  # noqa: E402


def traced_cell(cell, seed: int, seconds: float, with_spans: bool, device,
                t_process: float, manifest=None):
    """``run.run_cell(..., trace=True)`` with the program's spans on (or
    off) → (its result, the span readings)."""
    kept = []

    class Kept(profile.Profiled):
        def __init__(self, dev):
            super().__init__(dev)
            kept.append(self)

    made, profile.Profiled = profile.Profiled, Kept
    if with_spans:
        trace.start()
    try:
        result = run.run_cell(cell, seed, seconds, True, device, t_process,
                              manifest)
    finally:
        dropped = trace.dropped()
        spans = trace.stop()
        profile.Profiled = made
    prof = kept[0]
    events = prof.prof.events()
    acts = S.device_activities(events, {s.name for s in spans})
    n_kern = sum(1 for a in acts if not a[0].startswith(("Memcpy",
                                                          "Memset")))
    d2h = sum(1 for a in acts if "DtoH" in a[0])
    t_w, t_p = prof.t_start, prof.t_stop
    if spans:
        steps = len(S.decode_steps(spans, t_w, t_p))
    else:           # the harness's reading: its kernels are these
        lps = result["metrics"].get("launches_per_step", {}).get("value")
        steps = n_kern / lps if lps else 0
    out = {"dropped": dropped,
           "launches_per_step": n_kern / steps if steps else None,
           "d2h_per_step": d2h / steps if steps else None}
    if not spans:
        return result, out, []
    part = S.profiled(spans, events)
    layers = cell["config"]["num_hidden_layers"]
    after = [s for s in spans if s.name == "engine.step"
             and s.t0_ns >= round(t_p * 1e9)]
    dev = sum(a[2] - a[1] for a in part["acts"])
    out.update(
        host_issue_ms_per_step=S.host_issue_ms_per_step(spans, t_p),
        sync_wait_ms_per_step=S.sync_wait_ms_per_step(spans, t_p),
        tier_table_us_per_step=S.tier_table_us_per_step(spans, part, t_w,
                                                        t_p, layers),
        admit_to_first_token_ms=S.admit_to_first_token_ms(spans, t_w),
        offset_ns=part["offset_ns"],
        idle_gaps=S.named_gaps(spans, part),
        idle_in_spans_pct=S.idle_in_spans_pct(spans, part),
        device_in_spans_pct=100.0 * sum(
            a[2] - a[1] for a in part["acts"] if a[3] is not None) / dev
        if dev else None,
        idle_pct=100.0 * (1.0 - S.busy_us(part["acts"]) * 1e-6
                          / (t_p - t_w)),
        summary=S.summary(spans, t_w),
        engine_step_ms_after_profiled=statistics.median(
            (s.t1_ns - s.t0_ns) / 1e6 for s in after) if after else None,
        setup_engine_steps_ms=[round((s.t1_ns - s.t0_ns) / 1e6, 3)
                               for s in spans if s.name == "engine.step"
                               and s.t0_ns < round(t_w * 1e9)])
    return result, out, S.table(spans, part, t_w, t_p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    a = ap.parse_args(argv)
    man = spec.manifest()
    if not any(w["name"] == a.workload for w in man["workloads"]):
        print(f"unknown workload {a.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    result, out, rows = traced_cell(spec.cell(a.workload), a.seed,
                                    a.seconds, bool(a.spans), "cuda",
                                    T_PROCESS, man)
    bad = guard.loaded()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}",
              file=sys.stderr)
        return 4
    if rows:
        print(S.format_table(rows), file=sys.stderr)
    result["spans"] = out
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
