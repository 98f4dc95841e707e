"""Device kernels the profiler saw per decode step, over the profiled
steps."""
from portbench.lib import readers as R


def read(rec):
    tr = rec.get("trace")
    steps = sum(s["steps"] for s in R.profiled_steps(rec))
    if tr is None or not tr["cuda"] or not steps:
        return None
    return len(tr["kernels"]) / steps
