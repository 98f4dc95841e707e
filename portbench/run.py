"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``portbench/workloads/<cell>.json``) names its configuration
(``configs/``), traffic (``traffic/``) and engine. The run builds or
loads the port's kernel libraries (in the checkout's ``build/``), makes
the weights on the card from the seed, sets up the cell's sessions,
serves for ``--seconds``, then checks the served tokens against the
plain reference. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics (the first part of the window under
``torch.profiler``). Each metric is read by ``metrics/<name>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with a trace
``breakdown``), then ``checks``: every number compared, beside its limit.
The same numbers end standard error. Without a CUDA card with the chips
the cell needs, or if JAX or the JAX package was loaded, it exits with
an error and prints no result."""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
for p in (REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from portbench.counts import work  # noqa: E402
from portbench.lib import check, driver, guard, spec  # noqa: E402


def metric_reader(name: str):
    path = spec.ROOT / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries, rec):
    out = {}
    for m in entries:
        v = metric_reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, manifest=None):
    """One run of ``cell`` (``spec.cell``'s dict) → the result object."""
    run = driver.Run(cell, seed, device, t_process)
    run.setup()
    setup_s = time.perf_counter() - t_process
    print("setup " + json.dumps({k: round(v, 4) for k, v in
                                 run.breakdown.items()}), file=sys.stderr)
    _, _, prof = run.window(seconds, trace)
    run.drain()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    nonfinite = int(run.eng.nonfinite_logits)
    rec = run.record()
    rec["setup_s"] = setup_s
    args = cell["engine"]["args"]
    rec["shapes"] = work.Shapes(cell["config"], args["n_max"],
                                args["max_batch"])
    rec["trace"] = prof.reduce() if prof is not None else None
    man = manifest or spec.manifest()
    kind = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(spec.metrics_of(man, cell["name"], kind), rec)
    # requests the window served: submitted in it, or in flight through it
    window = [t for t in run.tracked
              if run.t0 <= t.t_submit <= run.t1
              or any(run.t0 < x <= run.t1 for x in t.times)]
    failed = sum(1 for t in run.tracked if t.req.failed)
    launched = {}
    if cuda:
        from repro_torch.kernels import LAUNCHES
        launched = {k: LAUNCHES[k] for k in cell["main_path_kernels"]}
    run.close()
    picked = check.sample(run, cell["check"]["sample"])
    t_ref = time.perf_counter()
    gaps = check.served_gaps(run, picked) if picked else []
    n_cmp = sum(len(g) for g in gaps)
    got = (check.numbers(gaps) if gaps
           else dict.fromkeys(cell["check"]["limits"], float("inf")))
    if gaps:
        every = torch.cat(gaps)
        print(f"reference {time.perf_counter() - t_ref:.2f} s over {n_cmp} "
              f"tokens of {len(picked)} requests; median gap "
              f"{float(every.median())}, widest {float(every.max())}; "
              f"not compared", file=sys.stderr)
    checks = {k: {"value": got[k], "limit": float(lim)}
              for k, lim in cell["check"]["limits"].items()}
    checks.update({
        "tokens_compared": {"value": n_cmp, "limit": 1},
        "failed_requests": {"value": failed, "limit": 0},
        "nonfinite_logits": {"value": nonfinite, "limit": 0},
    })
    for k, v in launched.items():
        checks["launches_" + k] = {"value": v, "limit": 1}
    correct = (all(got[k] <= float(lim)
                   for k, lim in cell["check"]["limits"].items())
               and n_cmp >= 1 and failed == 0 and nonfinite == 0
               and all(v >= 1 for v in launched.values()))
    device_rec = {"platform": "gpu" if cuda else dev.type,
                  "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(window),
              "failed": sum(1 for t in window if t.req.failed),
              "metrics": metrics, "device": device_rec}
    if rec["trace"] is not None:
        device_rec["busy_s"] = rec["trace"]["busy_s"]
        device_rec["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    man = spec.manifest()
    entry = [w for w in man["workloads"] if w["name"] == a.workload]
    if not entry:
        print(f"unknown workload {a.workload!r}", file=sys.stderr)
        return 2
    chips = int(entry[0]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    cell = spec.cell(a.workload)
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda",
                      T_PROCESS, man)
    bad = guard.loaded()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}",
              file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
