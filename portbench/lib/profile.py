"""The traced part of a window: ``torch.profiler`` over host and device,
reduced to the device's kernels, its busy time, the idle gaps and what
the host was doing in each.

Times are the profiler's (microseconds on one clock for host and
device). ``busy_s`` is the union of every device activity's interval
(kernels, copies, sets); ``window_s`` the host clock from the
profiler's start to its stop, both at step boundaries, where the device
has finished."""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

import torch


class Profiled:
    def __init__(self, device):
        self.dev = torch.device(device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.running = False

    def start(self) -> None:
        self.prof.__enter__()
        self.running = True
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.running = False

    def reduce(self) -> Dict:
        """→ {"kernels": [(name, start_us, end_us)], "device": [...] every
        device activity, "window_s", "busy_s", "device_ops", "idle_gaps"}."""
        dev_evs: List[Tuple[str, float, float]] = []
        host: List[Tuple[float, float, str]] = []
        kernels = []
        for e in self.prof.events():
            tr = e.time_range
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev_evs.append((e.name, tr.start, tr.end))
                if not e.name.startswith(("Memcpy", "Memset")):
                    kernels.append((e.name, tr.start, tr.end))
            else:
                host.append((tr.start, tr.end, e.name))
        window_s = self.t_stop - self.t_start
        dev_evs.sort(key=lambda x: x[1])
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        for _, s, e in dev_evs:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        per_op: Dict[str, float] = {}
        for name, s, e in dev_evs:
            per_op[name] = per_op.get(name, 0.0) + (e - s)
        top_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
        return {"cuda": self.dev.type == "cuda", "kernels": kernels,
                "window_s": window_s,
                "busy_s": busy * 1e-6,
                "device_ops": [[n, v * 1e-6] for n, v in top_ops],
                "idle_gaps": _name_gaps(gaps, host)}


def _name_gaps(gaps, host) -> List[list]:
    """The ten longest idle gaps, each named by the innermost host
    activity running at its middle."""
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host.sort()
    starts = [h[0] for h in host]
    out = []
    for s, e in longest:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        name, width = "host: no activity recorded", None
        for j in range(i - 1, max(i - 4000, -1), -1):
            hs, he, hn = host[j]
            if he >= mid and (width is None or he - hs < width):
                name, width = hn, he - hs
        out.append([name, (e - s) * 1e-6])
    return out
