"""The port's spans (``repro_torch.trace``) on the qwen2 smoke config in
float32, served by ``PagedServingEngine`` with prefix sharing and chunked
prefill: tracing changes no token; off, it records and reads nothing; on,
every decode step holds one span per layer, in order, each with its
retrieval stages, and the request spans are the requests' own stamps;
under ``torch.profiler`` every span's ``record_function`` range holds the
in-memory span once the offset is applied, their ends a median of under
100 µs apart."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores, and torch's
# spinning OpenMP pool would otherwise slow each of them many times over
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import statistics  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving import PagedServingEngine, Request  # noqa: E402

CFG = dataclasses.replace(TC.smoke("qwen2-1.5b"), dtype="float32")
ENGINE = dict(n_max=256, max_batch=4, block_size=16, chunk_size=4,
              prefill_budget=16, share_prefixes=True, device="cpu")
GEN = 40          # past the first promotion of every request
LAYER_KIDS = ["attn.qkv", "cache.append", "retrieve", "attn.rows",
              "attn.segment", "attn.out"]
RETRIEVE_KIDS = ["retrieve.encode_query", "retrieve.stage1",
                 "retrieve.topc", "retrieve.stage2"]


def _prompts(seed=3, n_shared=64, n_suffix=17, n_req=4):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, CFG.vocab_size, size=(n_shared,))
    return [np.concatenate(
        [shared, rng.randint(0, CFG.vocab_size, size=(n_suffix,))]
    ).astype(np.int32) for _ in range(n_req)]


def _serve(params, steps=None):
    """Serve the prompts (all, or ``steps`` step_serve calls) → (engine,
    requests by uid, step_serve calls made)."""
    eng = PagedServingEngine(CFG, params, **ENGINE)
    reqs = {u: Request(uid=u, prompt=p, max_new_tokens=GEN)
            for u, p in enumerate(_prompts())}
    for r in reqs.values():
        eng.submit(r)
    eng.start()
    calls = 0
    while eng.pending() and (steps is None or calls < steps):
        eng.step_serve()
        calls += 1
    return eng, reqs, calls


@pytest.fixture(scope="module")
def runs():
    params = init_params(CFG, seed=0, device="cpu")
    for leaf in params["layers"]:
        for k, v in leaf["attn"].items():
            leaf["attn"][k] = v * 4.0        # scores with a clear top set
    reads = []
    now, prof = trace._now, trace._profiler_enabled
    trace._now = lambda: reads.append("clock") or now()
    trace._profiler_enabled = lambda: reads.append("profiler") or prof()
    try:
        off = _serve(params)
    finally:
        trace._now, trace._profiler_enabled = now, prof
    trace.start()
    try:
        on = _serve(params)
    finally:
        spans = trace.stop()
    return dict(params=params, off=off, on=on, spans=spans, reads=reads)


def _kids(spans):
    out = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out


def test_tokens_equal_with_tracing_on_and_off(runs):
    (_, off, _), (_, on, _) = runs["off"], runs["on"]
    assert {u: r.output.tolist() for u, r in off.items()} == \
        {u: r.output.tolist() for u, r in on.items()}
    assert all(len(r.output) == GEN for r in on.values())


def test_tracing_off_records_and_reads_nothing(runs):
    assert runs["reads"] == []
    assert trace.span("engine.step") is trace.span("layer", index=0)
    assert trace.stop() == [] and trace.dropped() == 0
    trace.start(capacity=3)
    for i in range(5):
        with trace.span("x", i=i):
            pass
    assert trace.dropped() == 2
    assert [s.attrs["i"] for s in trace.stop()] == [0, 1, 2]


def test_each_decode_step_holds_its_layers_and_retrieval_stages(runs):
    spans, kids = runs["spans"], _kids(runs["spans"])
    steps = [s for s in spans if s.name == "decode.step"]
    assert steps and any(s.attrs["mixed"] for s in steps)
    promoted = 0
    for st in steps:
        layers = [k for k in kids[st.id] if k.name == "layer"]
        assert [k.attrs["index"] for k in layers] == list(
            range(CFG.num_layers))
        for ly in layers:
            names = [k.name for k in kids[ly.id]]
            assert [n for n in names if n in LAYER_KIDS] == LAYER_KIDS
            assert names[-1] == ("fill.layer" if st.attrs["mixed"]
                                 else "mlp")
            assert "mlp" in names
            promoted += "cache.promote" in names
            ret = next(k for k in kids[ly.id] if k.name == "retrieve")
            assert ret.attrs == dict(C=CFG.pariskv.candidate_count(
                ENGINE["n_max"]), k=CFG.pariskv.top_k)
            assert [k.name for k in kids[ret.id]] == RETRIEVE_KIDS
            s1 = next(k for k in kids[ret.id] if k.name == "retrieve.stage1")
            assert [k.name for k in kids[s1.id]] == ["retrieve.tier_table"]
    assert promoted > 0
    for name in ("sync.append_index", "sync.promote", "sync.promote_rows",
                 "sync.chunk_out", "sync.block_tables", "sync.bt_row",
                 "sync.prompt_row", "decode.unembed", "decode.emit",
                 "engine.admit", "engine.pre_chunk", "engine.collect"):
        assert any(s.name == name for s in spans), name


def test_span_tree_is_consistent_and_counts_the_engine(runs):
    spans = runs["spans"]
    eng, _, calls = runs["on"]
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    roots = [s for s in spans if not s.parent
             and not s.name.startswith("request.")]
    assert {s.name for s in roots} == {"engine.step"}
    assert len(roots) == calls
    assert all(0 < s.attrs["rows"] <= ENGINE["max_batch"] for s in roots)
    assert sum(s.name == "decode.step" for s in spans) == eng.decode_steps
    for s in spans:
        if s.name == "decode.step":
            assert by_id[by_id[s.parent].parent].name == "engine.step"


def test_request_spans_are_the_request_stamps(runs):
    spans = runs["spans"]
    _, reqs, _ = runs["on"]

    def ns(t):
        return int(round(t * 1e9))
    req = {(s.name, s.attrs["uid"]): s for s in spans
           if s.name.startswith("request.")}
    assert len(req) == 3 * len(reqs)
    for u, r in reqs.items():
        q, p, d = (req[(n, u)] for n in ("request.queued", "request.prefill",
                                          "request.decode"))
        assert (q.t0_ns, q.t1_ns) == (ns(r._t_submit), ns(r._t_admit))
        assert (p.t0_ns, p.t1_ns) == (ns(r._t_admit), ns(r._t_first))
        assert d.t0_ns == ns(r._t_first)
        assert abs((d.t1_ns - d.t0_ns) * 1e-9 - r.decode_s) < 1e-6
        assert (d.t1_ns - d.t0_ns) * 1e-9 >= 0
    admits = {s.attrs["uid"]: s.attrs["shared"] for s in spans
              if s.name == "engine.admit"}
    assert admits == {u: r.shared_prefix_blocks for u, r in reqs.items()}
    assert sorted(admits.values())[-1] > 0


def test_profiler_ranges_lie_on_the_spans(runs):
    trace.start()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _serve(runs["params"], steps=3)
    finally:
        spans = trace.stop()
    events = prof.events()
    off = trace.profiler_offset_ns(spans, events)
    ours = [s for s in spans if s.profiled]
    assert ours and len(ours) == sum(1 for s in spans
                                     if not s.name.startswith("request."))
    names = {s.name for s in ours}
    theirs = sorted((e for e in events if e.name in names),
                    key=lambda e: e.time_range.start)
    assert len(theirs) == len(ours)
    ends = []
    for s, e in zip(ours, theirs):
        assert s.name == e.name
        lo, hi = e.time_range.start * 1e3 - off, e.time_range.end * 1e3 - off
        # the range opens before the span reads the clock and closes after
        # it (50 µs for the offset's error)
        assert lo - 50e3 <= s.t0_ns and s.t1_ns <= hi + 50e3
        ends += [s.t0_ns - lo, hi - s.t1_ns]
    # the ends lie within 100 µs, but where the scheduler parks the thread
    # between a clock read and the profiler's (a loaded host)
    assert statistics.median(ends) < 100e3
