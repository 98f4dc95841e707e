"""The whole model step's share of the chip's peak: the least time the
window's counted work needs (each decode step's FLOPs at 989 TFLOP/s or
its bytes at 3.35 TB/s, whichever binds; each prefill the same way) ÷
the time those steps took. In a traced run only the steps after the
profiled part count, so the profiler's cost is not in it."""
from portbench.counts import work


def read(rec):
    s = rec["shapes"]
    steps = [st for st in rec["steps"]
             if not st.get("profiled") and st["t1"] <= rec["t1"]]
    if not steps:
        return None
    t = 0.0
    for st in steps:
        if st["steps"]:
            t += work.step_time_bound(*work.decode_chunk(s, st))[0]
        for L in st["prefills"]:
            t += work.step_time_bound(*work.prefill(s.cfg, L))[0]
    return 100.0 * t / (steps[-1]["t1"] - steps[0]["t0"]) if t else None
