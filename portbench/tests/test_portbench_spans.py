"""The span readings of ``lib/spans.py`` on constructed spans and device
activities, whose answers are known: the four per-layer readings, the
innermost span of a time, the idle gaps named by span path, the share
of idle time inside a span. On the card (``-m cuda``): every Stage II
launch of a profiled smoke-size run is put down to ``retrieve.stage2``."""
import time

import pytest
import torch

from portbench.lib import driver
from portbench.lib import spans as S
from portbench.tests.smoke import smoke_cell
from repro_torch import trace
from repro_torch.trace import Span

MS = 1_000_000          # ns


class Tree:
    """Spans with the ids, parents and times (ms) a program gives them."""

    def __init__(self):
        self.spans = []

    def add(self, name, t0, t1, parent=0, **attrs):
        s = Span(len(self.spans) + 1, parent, name, int(t0 * MS),
                 int(t1 * MS), attrs, False)
        self.spans.append(s)
        return s.id

    def step(self, t, layers=2, tables=True, sync_ms=1.0, collect_ms=0.5):
        """One engine step of one decode step of 10 ms at ``t``: 8 ms of
        layers, a sync of ``sync_ms`` inside the step and a chunk read
        of ``collect_ms`` after it."""
        e = self.add("engine.step", t, t + 12)
        c = self.add("decode.chunk", t, t + 11, parent=e)
        d = self.add("decode.step", t, t + 10, parent=c)
        self.add("sync.promote", t, t + sync_ms, parent=d)
        for i in range(layers):
            ly = self.add("layer", t + 1 + 4 * i, t + 5 + 4 * i, parent=d,
                          index=i)
            r = self.add("retrieve", t + 1 + 4 * i, t + 4 + 4 * i, parent=ly)
            s1 = self.add("retrieve.stage1", t + 1 + 4 * i, t + 3 + 4 * i,
                          parent=r)
            if tables:
                self.add("retrieve.tier_table", t + 1 + 4 * i,
                         t + 2 + 4 * i, parent=s1)
        self.add("sync.chunk_out", t + 11, t + 11 + collect_ms, parent=e)
        return e


def _records():
    """Set-up: two admissions, uid 0 unshared (5 s to its first token)
    and uids 1, 2, 3 sharing (1.0, 1.2, 2.0 s). Window from 10 s: two
    profiled steps, the profiled part ending at 10.03 s, then two more."""
    t = Tree()
    for uid, shared, ms in ((0, 0, 5000), (1, 3, 1000), (2, 3, 1200),
                            (3, 3, 2000)):
        e = t.add("engine.step", 100 * uid, 100 * uid + 50)
        t.add("engine.admit", 100 * uid, 100 * uid + 1, parent=e, uid=uid,
              shared=shared)
        t.add("request.prefill", 0, ms, uid=uid)
    for k in range(4):
        t.step(10_000 + 15 * k, sync_ms=0.2 + 0.1 * k, collect_ms=0.5)
    return t.spans


def test_the_four_readings_on_known_spans():
    spans = _records()
    t_window, t_profiled = 10.0, 10.029
    # after the profiled part: steps 2 and 3, syncs of 0.4 and 0.5 ms and
    # two chunk reads of 0.5 ms, over two decode steps of 10 ms
    assert S.host_issue_ms_per_step(spans, t_profiled) == pytest.approx(
        (10 - 0.4 + 10 - 0.5) / 2)
    assert S.sync_wait_ms_per_step(spans, t_profiled) == pytest.approx(
        (0.4 + 0.5 + 0.5 + 0.5) / 2)
    assert S.admit_to_first_token_ms(spans, t_window) == pytest.approx(1200)
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    tables = by_name["retrieve.tier_table"]
    # device activities on the profiler's clock (µs, offset 0): one kernel
    # under each of the profiled steps' tier tables (3 µs each), one under
    # a layer, one launched by no span
    acts = [("sort", 1.0, 4.0, tables[0].id),
            ("sort", 5.0, 8.0, tables[1].id),
            ("sort", 9.0, 12.0, tables[2].id),
            ("sort", 13.0, 16.0, tables[3].id),
            ("gemm", 20.0, 30.0, by_name["layer"][0].id),
            ("copy", 31.0, 32.0, None)]
    part = {"acts": acts}
    assert S.tier_table_us_per_step(spans, part, t_window, t_profiled,
                                    2) == pytest.approx(12.0 / 2)
    with pytest.raises(S.MissingSpan):
        S.tier_table_us_per_step(spans, part, t_window, t_profiled, 3)
    lean = Tree()
    lean.step(10_000, tables=False)
    with pytest.raises(S.MissingSpan):
        S.tier_table_us_per_step(lean.spans, {"acts": []}, t_window, 10.02,
                                 2)


def test_readings_without_spans_are_none():
    assert S.host_issue_ms_per_step([], 1.0) is None
    assert S.sync_wait_ms_per_step([], 1.0) is None
    assert S.admit_to_first_token_ms([], 1.0) is None
    assert S.tier_table_us_per_step([], {"acts": []}, 0.0, 1.0, 28) is None


def test_innermost_span_of_each_time():
    spans = [(0.0, 100.0, 1), (10.0, 50.0, 2), (20.0, 30.0, 3),
             (60.0, 90.0, 4), (200.0, 300.0, 5)]
    times = [25.0, 5.0, 40.0, 55.0, 70.0, 150.0, 250.0, 10.0, 30.0]
    assert S.innermost(spans, times) == [3, 1, 2, 1, 4, None, 5, 2, 3]


def test_idle_gaps_named_by_span_path_and_share_inside_spans():
    t = Tree()
    t.step(0)
    spans = t.spans
    paths = S.paths(spans)
    sp = {s.id: (s.t0_ns / 1e3, s.t1_ns / 1e3) for s in S.calls(spans)}
    # device busy 0–3 ms, 10–12.5 ms and 14–14.1 ms: a gap of 7 ms whose
    # middle lies in the second layer's stage I, under an aten::sort, and
    # one of 1.5 ms after the engine step
    acts = [("k", 0.0, 3000.0, None), ("k", 10000.0, 12500.0, None),
            ("k", 14000.0, 14100.0, None)]
    part = {"spans_us": sp, "gaps": S.idle_gaps(acts),
            "host": [(6000.0, 7000.0, "aten::sort")]}
    named = S.named_gaps(spans, part)
    stage1 = [s for s in spans if s.name == "retrieve.stage1"][1]
    assert named[0] == [paths[stage1.id] + " | aten::sort",
                        pytest.approx(7e-3)]
    assert named[0][0].startswith("engine.step/decode.chunk/decode.step/"
                                  "layer/retrieve/retrieve.stage1")
    assert named[1][0] == "no span | host: no activity recorded"
    assert S.idle_in_spans_pct(spans, part) == pytest.approx(
        100.0 * 7000 / (7000 + 1500))
    assert S.busy_us(acts) == pytest.approx(3000 + 2500 + 100)


@pytest.mark.cuda
def test_every_stage2_launch_is_put_down_to_its_span(card):
    c = smoke_cell("qwen2-1.5b.longdoc-32k")
    run = driver.Run(c, 2 ** 31 + 91, card, time.perf_counter())
    trace.start()
    try:
        run.setup()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(2):
                run.step()
            torch.cuda.synchronize(card)
    finally:
        spans = trace.stop()
    part = S.profiled(spans, prof.events())
    by_id = {s.id: s for s in spans}
    stage2 = [a for a in part["acts"] if "rerank_topk_paged_kernel" in a[0]]
    steps = [s for s in spans if s.name == "decode.step" and s.profiled]
    assert stage2 and len(stage2) == len(steps) * c["config"][
        "num_hidden_layers"]
    assert all(a[3] is not None and by_id[a[3]].name == "retrieve.stage2"
               for a in stage2)
