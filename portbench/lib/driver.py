"""One run of one cell: set-up, the measured window, the drain, and the
records the metrics read.

The program is driven only through its public entry points: the engine
class the cell names (``repro_torch.serving``), its ``submit``,
``start`` and ``step_serve``, the ``Request`` it fills in, and the
kernel build (``repro_torch.kernels.build.build_all``). What it reads
back are the request's tokens, ``token_times``, ``output`` and
``failed``, and the engine's ``decode_steps`` and ``nonfinite_logits``.

Every decode step of every in-flight request is recorded by the
benchmark itself (prompt length and how many tokens the request had
before the step), so counts of work and bytes follow from lengths alone.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.lib import spec, traffic, weights

TRACE_SECONDS = 3.0     # the profiled part at the start of a traced window
DRAIN_SECONDS = 60.0    # the longest wait for a window request's first token


class Tracked:
    """A request of the benchmark's: the program's ``Request`` and what the
    client saw."""

    def __init__(self, req, client: int, t_submit: float, index: int):
        self.req, self.client, self.t_submit = req, client, t_submit
        self.index = index                  # order of submission
        self.L = len(req.prompt)
        self.t_done: Optional[float] = None

    @property
    def tokens(self) -> List[int]:
        return list(self.req._tokens or [])

    @property
    def times(self) -> List[float]:
        return list(self.req.token_times or [])


class Run:
    def __init__(self, cell: Dict, seed: int, device, t_process: float):
        self.cell, self.seed = cell, int(seed)
        self.cfg = cell["config"]
        self.dev = torch.device(device)
        self.t_process = t_process
        self.breakdown: Dict[str, float] = {}
        self.tracked: List[Tracked] = []
        self.steps: List[Dict] = []
        self.decode_steps = 0
        self.eng = None

    # ------------------------------------------------------------ set-up --
    def _phase(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.breakdown[name] = now - t
        return now

    def setup(self) -> None:
        t = time.perf_counter()
        import repro_torch.serving as S
        from repro_torch.kernels import build
        t = self._phase("imports", t)
        if self.dev.type == "cuda":
            build.build_all()
        t = self._phase("kernel_libraries", t)
        self.params = weights.make(self.cfg, self.seed, self.dev)
        self._sync()
        t = self._phase("weights", t)
        mcfg = spec.model_config(self.cfg)
        e = self.cell["engine"]
        self.eng = getattr(S, e["class"])(mcfg, self.params,
                                          device=self.dev, **e["args"])
        self.Request = S.Request
        self.gen = traffic.Traffic(self.cell["traffic"], self.seed,
                                   self.cfg["vocab_size"])
        self.eng.start()
        t = self._phase("engine", t)
        for c in range(self.gen.clients):
            self.submit(c)
        while not self._all_decoding():
            self.step()
        self._sync()
        # what set-up allocated stays: the collector need not walk it
        # again inside the window
        gc.collect()
        gc.freeze()
        self._phase("fills_and_warmup", t)

    def _all_decoding(self) -> bool:
        """Set-up ends once every client's request has its first token."""
        live = [t for t in self.tracked if t.t_done is None]
        return (len(live) == self.gen.clients
                and all(len(t.tokens) > 0 for t in live))

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # ------------------------------------------------------------ serving --
    def submit(self, client: int) -> None:
        prompt, out = self.gen.next()
        uid = len(self.tracked)
        req = self.Request(uid=uid, prompt=prompt, max_new_tokens=out)
        self.tracked.append(Tracked(req, client, time.perf_counter(), uid))
        self.eng.submit(req)

    def step(self) -> Dict:
        """One ``step_serve``; finished requests are replaced by their
        clients' next ones. → the step's record."""
        live = [t for t in self.tracked if t.t_done is None]
        before = {t.index: len(t.tokens) for t in live}
        t0 = time.perf_counter()
        self.eng.step_serve()
        t1 = time.perf_counter()
        rows = []
        for t in live:
            n_after = len(t.tokens)
            n_before = before[t.index]
            decoded = n_after - max(n_before, 1) if n_after else 0
            if decoded > 0:
                rows.append((t.L, max(n_before, 1) - 1, decoded))
        rec = {"t0": t0, "t1": t1, "rows": rows,
               "steps": self.eng.decode_steps - self.decode_steps,
               "prefills": [t.L for t in live
                            if len(t.tokens) and not before[t.index]]}
        self.decode_steps = self.eng.decode_steps
        self.steps.append(rec)
        for t in live:
            if t.req.output is not None and t.t_done is None:
                t.t_done = t1
                self.submit(t.client)
        return rec

    def window(self, seconds: float, trace: bool):
        """Serve for ``seconds``; with ``trace`` the first part runs under
        the profiler. → (t_start, t_end, the profiler's record or None)."""
        prof = None
        self.first_window_step = len(self.steps)
        t0 = time.perf_counter()
        if trace:
            from portbench.lib import profile
            prof = profile.Profiled(self.dev)
            prof.start()
        while True:
            rec = self.step()
            now = time.perf_counter()
            if prof is not None and prof.running:
                rec["profiled"] = True
                if now - t0 >= TRACE_SECONDS:
                    prof.stop()
            if now - t0 >= seconds:
                break
        t1 = time.perf_counter()
        if prof is not None and prof.running:
            prof.stop()
        self.t0, self.t1 = t0, t1
        return t0, t1, prof

    def drain(self) -> None:
        """Serve on, outside the window, until every request submitted in
        it has its first token (or the drain's limit passes)."""
        t_end = time.perf_counter() + DRAIN_SECONDS
        while time.perf_counter() < t_end:
            waiting = [t for t in self.tracked
                       if self.t0 <= t.t_submit <= self.t1
                       and not t.tokens and not t.req.failed]
            if not waiting:
                return
            self.step()

    def close(self) -> None:
        """Free the program's state (the parameters stay: the reference
        reads them)."""
        self.eng = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ records --
    def record(self) -> Dict:
        """What the metric readers read."""
        return {"t0": self.t0, "t1": self.t1,
                "requests": [{"times": t.times} for t in self.tracked],
                "steps": self.steps[self.first_window_step:]}


def window_tokens(rec: Dict) -> int:
    """Output tokens that became visible inside the window."""
    t0, t1 = rec["t0"], rec["t1"]
    return int(sum(np.count_nonzero((np.asarray(r["times"]) > t0)
                                    & (np.asarray(r["times"]) <= t1))
                   for r in rec["requests"] if r["times"]))
