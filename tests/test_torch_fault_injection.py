"""Fault handling in the port (``faults=``, the fetch policy, degraded
attention, quarantine) on the qwen2 smoke config in float32, at the
geometry of ``tests/test_fault_injection.py``: ``n_max=512``, two slots,
blocks of 16, 64 host blocks with 16 staged, chunks of 4, requests of
300/16 and 140/8. Weights are scaled ×8 so that greedy outputs vary.

* The reference's fault matrix on the port, each test's assertions kept.
  The card forces two adaptations: the port has no fetch worker (a
  launched kernel cannot be abandoned), so where the reference reads its
  worker respawns the port reads ``host.abandoned_attempts``, and the
  thread-leak checks find no ``kv-fetch*`` thread at all. The
  ``engine.slot`` quarantine also runs on the slot ``ServingEngine`` and
  the resident paged engine.
* The port against the reference under the same ``FaultPlan``: the same
  ``fired()`` log (site, kind, visit, context) for a solo and a chunked
  run, and equal tokens and per-uid fault counters for the degraded run,
  a chunked run whose fill reads exhaust their retries, and quarantine;
  ``_segment_attention(ret_keep=…)`` against the reference's.
* A ``KernelError`` inside a step propagates and quarantines nobody.

Each reference engine runs once per module."""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores, and torch's
# spinning OpenMP pool would otherwise slow each of them many times over
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving.faults import FaultPlan as JPlan  # noqa: E402
from repro.serving.faults import FaultSpec as JSpec  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import attention as TA  # noqa: E402
from repro_torch.kernels import build as KB  # noqa: E402
from repro_torch.kernels.gather_kv import ops as gather_ops  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import (FaultPlan, FaultSpec,  # noqa: E402
                                 HostIndexError, InjectedFault,
                                 InvariantViolation, PagedServingEngine,
                                 Request, ServingEngine)
from repro_torch.serving.offload import HostKVPool  # noqa: E402

CFG_J = dataclasses.replace(JC.smoke("qwen2-1.5b"), dtype="float32")
CFG_T = dataclasses.replace(TC.smoke("qwen2-1.5b"), dtype="float32")
NUM_BLOCKS = 64
NUM_DEVICE = 16
GEOM = dict(n_max=512, max_batch=2, block_size=16, num_blocks=NUM_BLOCKS,
            chunk_size=4)
SPECS = [(300, 16), (140, 8)]        # (prompt len, max_new) per request
OFF = dict(offload=True, num_device_blocks=NUM_DEVICE)
# per-uid counters equal to the reference's: the staging statistics of
# tests/test_torch_offload_engine.py and the fault counters
COUNTERS = ("staging_hits", "staging_misses", "fetched_bytes",
            "prefetched_blocks", "prefetch_hits", "fetched_unique_bytes",
            "fetch_retries", "fetch_timeouts", "degraded_steps")


@pytest.fixture(scope="module")
def setup():
    pj = jax.tree.map(lambda a: a * 8.0,
                      JM.init_params(CFG_J, jax.random.PRNGKey(2)))
    pt = convert.params_from_jax(jax.device_get(pj), CFG_T, device="cpu")
    rng = np.random.RandomState(11)
    prompts = {n: rng.randint(0, CFG_J.vocab_size, size=(n,)).astype(np.int32)
               for n in (300, 140)}
    return pj, pt, prompts


def _engine(setup, specs=SPECS, engine=PagedServingEngine, **kw):
    _, pt, prompts = setup
    if engine is PagedServingEngine:
        kw = {**GEOM, **kw}
    else:
        kw = {"n_max": GEOM["n_max"], "max_batch": GEOM["max_batch"],
              "chunk_size": GEOM["chunk_size"], **kw}
    eng = engine(CFG_T, pt, device="cpu", **kw)
    for i, (plen, gen) in enumerate(specs):
        eng.submit(Request(uid=i, prompt=prompts[plen], max_new_tokens=gen))
    return eng


def _run(setup, specs=SPECS, **kw):
    eng = _engine(setup, specs, **kw)
    return {r.uid: r for r in eng.run()}, eng


def _run_stepwise_audited(eng):
    """Drive the serve loop a chunk at a time, auditing invariants at
    every boundary — the recovery-path claim, not just end-state."""
    eng.start()
    while eng.queue or any(s is not None for s in eng._slots):
        eng.step_serve()
        eng.verify_invariants()
    return {r.uid: r for r in eng._done}


@pytest.fixture(scope="module")
def clean(setup):
    """The no-fault offloaded run every parity test compares against."""
    done, eng = _run(setup, **OFF)
    eng.close()
    return done


def _assert_parity(clean, done, uids, label):
    for uid in uids:
        np.testing.assert_array_equal(
            clean[uid].output, done[uid].output,
            err_msg=f"{label}: request {uid} lost token parity")


def _fetch_threads(before):
    return [t for t in set(threading.enumerate()) - before
            if t.name.startswith("kv-fetch") and t.is_alive()]


# ---------------------------------------------------------- fault matrix ----
def test_fetch_delay_parity(setup, clean):
    """Injected fetch delays move only time: tokens identical, no
    retries/timeouts/degraded steps, and the plan logs each firing."""
    plan = FaultPlan([FaultSpec("fetch.gather", "delay", delay_s=0.01,
                                count=4)])
    done, eng = _run(setup, faults=plan, **OFF)
    _assert_parity(clean, done, [0, 1], "delay")
    assert len(plan.fired("fetch.gather", "delay")) == 4
    assert eng.fetch_retries == 0 and eng.fetch_timeouts == 0
    assert eng.degraded_steps == 0
    assert eng.fetch_stall_s >= 0.04
    eng.close()


def test_transient_failure_retries_to_parity(setup, clean):
    """Transient gather failures are retried with backoff and recover
    within the budget: exact parity, retries > 0, zero degraded steps,
    clean invariants at every chunk boundary through the recovery."""
    plan = FaultPlan([FaultSpec("fetch.gather", "fail", after=2, count=2)])
    eng = _engine(setup, faults=plan, fetch_max_retries=2,
                  fetch_backoff_s=0.001, **OFF)
    done = _run_stepwise_audited(eng)
    _assert_parity(clean, done, [0, 1], "transient")
    assert len(plan.fired("fetch.gather", "fail")) == 2
    assert eng.fetch_retries >= 2           # each firing costs one retry
    assert eng.host.fetch_retries == eng.fetch_retries
    assert eng.degraded_steps == 0 and eng.host.degraded_fetches == 0
    assert eng.fetch_timeouts == 0
    eng.close()


@pytest.mark.parametrize("overlap", [True, False])
def test_worker_death_deadline_respawn(setup, clean, overlap):
    """A hung fetch (injected hang) trips the deadline: the attempt is
    abandoned (the reference respawns its worker; the port has none and
    counts the abandoned attempt), the retry succeeds, tokens stay
    identical, and the stall stays bounded by the (timeout + backoff)
    budget — not the 60 s the hang would have blocked."""
    before = set(threading.enumerate())
    plan = FaultPlan([FaultSpec("fetch.gather", "hang", after=4, count=1)])
    done, eng = _run(setup, faults=plan, overlap=overlap,
                     fetch_timeout_s=0.25, fetch_max_retries=2,
                     fetch_backoff_s=0.001, **OFF)
    _assert_parity(clean, done, [0, 1], f"worker-death overlap={overlap}")
    assert len(plan.fired("fetch.gather", "hang")) == 1
    assert eng.fetch_timeouts == 1 and eng.fetch_retries >= 1
    assert eng.degraded_steps == 0
    # bounded stall: one 0.25 s deadline + backoff, not a 60 s hang
    assert eng.fetch_stall_s < 10.0
    assert eng.host.abandoned_attempts >= 1
    eng.close()
    time.sleep(0.1)
    assert not _fetch_threads(before)


def test_degraded_mode_completes(setup):
    """When every retry is exhausted, the step runs degraded — attention
    over sink + window + resident-staged blocks only — instead of
    crashing: the run completes full-length outputs, degraded steps are
    counted, and invariants hold at every boundary."""
    plan = FaultPlan([FaultSpec("fetch.gather", "fail", after=10,
                                count=None)])
    eng = _engine(setup, faults=plan, fetch_max_retries=1,
                  fetch_backoff_s=0.0, **OFF)
    done = _run_stepwise_audited(eng)
    for uid, (_, gen) in enumerate(SPECS):
        assert not done[uid].failed
        assert len(done[uid].output) == gen, \
            f"request {uid} did not complete under degraded fetches"
    assert eng.degraded_steps > 0 and eng.host.degraded_fetches > 0
    per_req = sum(r.degraded_steps for r in done.values())
    assert 0 < per_req <= eng.degraded_steps
    eng.close()


@pytest.mark.parametrize("kind", ["offload", "paged", "slot"])
def test_quarantine_isolates_one_request(setup, clean, kind):
    """A fault attributable to one slot evicts and fails exactly that
    request — blocks, staging residency, and histogram rows reclaimed —
    while the other request finishes with exact token parity (on the
    offloaded engine as in the reference, and on the resident paged and
    slot engines through the same hook)."""
    kw = dict(OFF) if kind == "offload" else {}
    if kind == "slot":
        kw["engine"] = ServingEngine
    want = clean
    if kind != "offload":
        want, _ = _run(setup, **kw)
    plan = FaultPlan([FaultSpec("engine.slot", "fail", match={"uid": 0})])
    eng = _engine(setup, faults=plan, **kw)
    if kind == "slot":
        done = {r.uid: r for r in eng.run()}
    else:
        done = _run_stepwise_audited(eng)
    bad, ok = done[0], done[1]
    assert bad.failed and "InjectedFault" in bad.error
    assert not ok.failed and ok.error is None
    _assert_parity(want, done, [1], f"{kind} quarantine survivor")
    assert [r.uid for r in eng.quarantined] == [0]
    if kind != "slot":
        # full reclamation now that the batch drained
        eng.verify_invariants()
        assert len(eng._free) == eng.num_blocks
    if kind == "offload":
        assert eng.staging.resident_count() == 0
    eng.close()


def test_staging_storm_parity(setup, clean):
    """A staging-eviction storm (every resident block flushed at a chunk
    boundary) moves bytes and stall only — tokens stay identical."""
    plan = FaultPlan([FaultSpec("staging.storm", "storm", after=1,
                                count=2)])
    eng = _engine(setup, faults=plan, **OFF)
    done = _run_stepwise_audited(eng)
    _assert_parity(clean, done, [0, 1], "storm")
    assert eng.storm_evictions > 0
    assert len(plan.fired("staging.storm")) == 2
    eng.close()


# ------------------------------------------------------- fault harness ------
def test_fault_plan_determinism():
    """Same seed → same firing schedule, including p-thinned specs; the
    same schedule as the reference's plan."""
    def fire_pattern(plan, n=200):
        out = []
        for _ in range(n):
            try:
                plan.apply("fetch.gather", name="e", kind="heads")
                out.append(0)
            except Exception:
                out.append(1)
        return out

    spec = FaultSpec("fetch.gather", "fail", after=3, count=None, p=0.25)
    a = fire_pattern(FaultPlan([spec], seed=7))
    b = fire_pattern(FaultPlan([spec], seed=7))
    c = fire_pattern(FaultPlan([spec], seed=8))
    assert a == b
    assert a != c
    assert sum(a[:3]) == 0 and 0 < sum(a) < 197
    jspec = JSpec("fetch.gather", "fail", after=3, count=None, p=0.25)
    assert a == fire_pattern(JPlan([jspec], seed=7))


def test_fault_spec_match_and_kinds():
    plan = FaultPlan([FaultSpec("fetch.gather", "fail",
                                match={"kind": "rows"})])
    plan.apply("fetch.gather", name="e", kind="heads")   # no match: clean
    with pytest.raises(InjectedFault):
        plan.apply("fetch.gather", name="e", kind="rows")
    with pytest.raises(ValueError):
        FaultSpec("fetch.gather", "explode")


# -------------------------------------------------- host bounds checking ----
def test_host_pool_bounds_checks():
    """Out-of-range host block/row indices raise a structured error
    naming the entry, the method, and the offending index — instead of
    negative indexing silently corrupting another request's blocks."""
    pool = HostKVPool({"s0.l0": (2, 8)}, num_blocks=4, block_size=4,
                      dtype=torch.float32)
    k = torch.zeros((8, 2, 8))
    with pytest.raises(HostIndexError) as ei:
        pool.write_prefill("s0.l0", np.asarray([0, -3]), k, k)
    err = ei.value
    assert err.entry == "s0.l0" and err.method == "write_prefill"
    assert err.index == -3 and "s0.l0" in str(err) and "-3" in str(err)

    kb = torch.zeros((1, 4, 2, 8))
    with pytest.raises(HostIndexError) as ei:
        pool.writeback("s0.l0", np.asarray([9]), kb, kb)
    assert ei.value.method == "writeback" and ei.value.index == 9

    with pytest.raises(HostIndexError) as ei:
        pool.read_blocks("s0.l0", np.asarray([-1]))
    assert ei.value.method == "read_blocks" and ei.value.index == -1
    pool.close()


def test_host_index_error_quarantines_admission(setup, clean):
    """A real (non-injected) per-request failure — a corrupted block
    table driving write_prefill out of range — quarantines only that
    admission; the other request still matches the clean run."""
    eng = _engine(setup, **OFF)
    orig = eng._phys_row

    def corrupted(blocks):
        row = orig(blocks).clone()
        if list(blocks) == eng._alloc.get(0):   # uid 0 admits into slot 0
            row[0] = -7
        return row

    eng._phys_row = corrupted
    done = {r.uid: r for r in eng.run()}
    assert done[0].failed and "HostIndexError" in done[0].error
    _assert_parity(clean, done, [1], "host-index quarantine")
    assert [r.uid for r in eng.quarantined] == [0]
    eng.close()


# ------------------------------------------------------ invariant auditor ---
def test_verify_invariants_detects_corruption(setup):
    """The auditor passes on live healthy state and raises on seeded
    corruption of each cross-checked structure."""
    eng = _engine(setup, **OFF)
    eng.start()
    eng.step_serve()                       # both requests live
    eng.verify_invariants()                # healthy mid-run state

    blk = next(iter(eng._refcnt))
    eng._refcnt[blk] += 1                  # refcount drift
    with pytest.raises(InvariantViolation):
        eng.verify_invariants(check_hist=False)
    eng._refcnt[blk] -= 1

    eng._free.append(eng._alloc[0][0])     # free list ∩ allocated
    with pytest.raises(InvariantViolation):
        eng.verify_invariants(check_hist=False)
    eng._free.pop()

    hb0 = eng._alloc[0][0]                 # broken residency inverse
    old = int(eng.staging.dev_map[hb0])
    eng.staging.dev_map[hb0] = (old + 1) % NUM_DEVICE if old >= 0 else 3
    with pytest.raises(InvariantViolation):
        eng.verify_invariants(check_hist=False)
    eng.staging.dev_map[hb0] = old

    eng.quarantined.append(eng._slots[1])  # a quarantined request live
    with pytest.raises(InvariantViolation, match="quarantined"):
        eng.verify_invariants(check_hist=False)
    eng.quarantined.pop()

    eng.verify_invariants()                # restored: healthy again
    while eng.queue or any(s is not None for s in eng._slots):
        eng.step_serve()
    eng.verify_invariants()
    eng.close()


# ----------------------------------------------------------- teardown -------
def test_close_and_context_manager(setup):
    """close() releases what the fetch policy holds (no worker exists to
    join: a hook asleep in an attempt is woken), is idempotent, and rides
    the context-manager protocol; no fetch thread survives it."""
    before = set(threading.enumerate())
    with _engine(setup, specs=[(140, 4)], overlap=False,
                 fetch_timeout_s=0.5, **OFF) as eng:
        done = {r.uid: r for r in eng.run()}
        assert len(done[0].output) == 4
        assert not eng.host.closed
    assert eng.host.closed
    eng.close()                            # second close: no-op
    assert eng.host.closed
    time.sleep(0.1)
    assert not _fetch_threads(before)


def test_closed_pool_wakes_a_hang():
    """After close() a hang ends at once (its sleep is woken) and counts
    as one failed attempt, not a 60 s block."""
    pool = HostKVPool({"s0.l0": (2, 8)}, num_blocks=4, block_size=4,
                      dtype=torch.float32)
    pool.faults = FaultPlan([FaultSpec("fetch.gather", "hang")])
    pool.close()
    t0 = time.perf_counter()
    ok, retries, timeouts, _ = pool.fetch_attempt("s0.l0", "heads")
    assert time.perf_counter() - t0 < 5.0
    assert ok and retries == 1 and timeouts == 0


# -------------------------------------------------- the fetch policy alone --
@pytest.mark.parametrize("spec,kw,want", [
    (FaultSpec("fetch.gather", "delay", delay_s=0.01), {}, (True, 0, 0)),
    (FaultSpec("fetch.gather", "fail", count=2), {}, (True, 2, 0)),
    (FaultSpec("fetch.gather", "fail", count=None), {}, (False, 2, 0)),
    (FaultSpec("fetch.gather", "delay", delay_s=0.3),
     dict(fetch_timeout_s=0.05), (True, 1, 1)),
    (FaultSpec("fetch.gather", "hang", count=None),
     dict(fetch_timeout_s=0.02, fetch_max_retries=1), (False, 1, 2)),
])
def test_fetch_attempt_policy(spec, kw, want):
    """``fetch_attempt`` follows the reference's policy: a delay inside the
    deadline succeeds, ``fail`` is retried up to ``fetch_max_retries``
    re-issues and then gives up, a delay or hang past the deadline counts
    a timeout and is retried; backoff doubles per retry."""
    pool = HostKVPool({"s0.l0": (2, 8)}, num_blocks=4, block_size=4,
                      dtype=torch.float32)
    pool.faults = FaultPlan([spec])
    pool.fetch_backoff_s = 0.001
    for key, value in kw.items():
        setattr(pool, key, value)
    ok, retries, timeouts, stall = pool.fetch_attempt("s0.l0", "rows")
    assert (ok, retries, timeouts) == want
    assert pool.fetch_retries == retries and pool.fetch_timeouts == timeouts
    assert pool.degraded_fetches == (0 if ok else 1)
    assert pool.abandoned_attempts == timeouts
    assert stall == pytest.approx(pool.fetch_stall_s)
    assert stall >= 0.001 * (2 ** retries - 1)        # the backoffs slept
    assert pool.faults.fired()[0].ctx == {"name": "s0.l0", "kind": "rows"}


# -------------------------------------------- the port against the reference --
@pytest.fixture(scope="module")
def reference(setup):
    """case → (the reference's requests by uid, its engine, its plan's
    fired log), each case served once."""
    pj, _, prompts = setup
    cache = {}

    def run(case, specs, **kw):
        if case not in cache:
            plan = JPlan([JSpec(**s) for s in specs])
            eng = JEngine(CFG_J, pj, **GEOM, **OFF, faults=plan, **kw)
            for i, (plen, gen) in enumerate(SPECS):
                eng.submit(JRequest(uid=i, prompt=prompts[plen],
                                    max_new_tokens=gen))
            done = {r.uid: r for r in eng.run()}
            eng.close()
            cache[case] = (done, eng, plan.fired())
        return cache[case]
    return run


def _port_run(setup, specs, **kw):
    plan = FaultPlan([FaultSpec(**s) for s in specs])
    eng = _engine(setup, faults=plan, **OFF, **kw)
    done = _run_stepwise_audited(eng)
    eng.close()
    return done, eng, plan.fired()


def _log(events, kind=None):
    return [(e.site, e.kind, e.visit, e.ctx) for e in events
            if kind is None or e.ctx.get("kind") == kind]


def _assert_matches_reference(got, want, label, counters=COUNTERS):
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].output, want[uid].output,
                                      err_msg=f"{label}: request {uid}")
        for name in counters:
            assert getattr(got[uid], name) == getattr(want[uid], name), \
                (label, uid, name)


def _assert_host_counters(eng, jeng):
    """The host pool's row counters equal the reference pool's (a degraded
    fetch adds nothing to them)."""
    for name in ("fetched_head_rows", "fetched_fill_rows",
                 "fetched_unique_head_rows", "fetched_unique_fill_rows"):
        assert getattr(eng.host, name) == getattr(jeng.host, name), name


CLEAN_PLAN = [dict(site="fetch.gather", kind="delay", delay_s=0.0,
                   count=None, match={"kind": k}) for k in ("heads", "rows")]


@pytest.mark.parametrize("budget", [0, 8])
def test_fired_log_matches_reference(setup, reference, budget):
    """A clean plan (delay 0 on every visit, one spec per kind) logs the
    same visits on both sides — one ``heads`` fetch per layer and step and,
    in a mixed step, one ``rows`` fetch per layer (the first chunk of a
    fill included) — with the reference's entry names; tokens are the
    reference's."""
    kw = dict(prefill_budget=budget) if budget else {}
    want, _, fired_j = reference(f"clean{budget}", CLEAN_PLAN, **kw)
    got, eng, fired_t = _port_run(setup, CLEAN_PLAN, **kw)
    _assert_matches_reference(got, want, f"clean budget={budget}")
    for kind in ("heads", "rows"):
        assert _log(fired_t, kind) == _log(fired_j, kind), kind
    heads = _log(fired_t, "heads")
    assert len(heads) == CFG_T.num_layers * eng.decode_steps
    assert heads[0][3] == {"name": "s0.l0", "kind": "heads"}
    assert bool(_log(fired_t, "rows")) == bool(budget)


def test_degraded_run_matches_reference(setup, reference):
    """Every fetch from the 11th on fails and one retry cannot save it:
    the same steps degrade on both sides, so tokens, ``degraded_steps``
    and ``fetch_retries`` per uid and in total equal the reference's."""
    specs = [dict(site="fetch.gather", kind="fail", after=10, count=None)]
    kw = dict(fetch_max_retries=1, fetch_backoff_s=0.0)
    want, jeng, fired_j = reference("degraded", specs, **kw)
    got, eng, fired_t = _port_run(setup, specs, **kw)
    _assert_matches_reference(got, want, "degraded")
    assert eng.degraded_steps == jeng.degraded_steps > 0
    assert eng.fetch_retries == jeng.fetch_retries > 0
    assert eng.host.degraded_fetches == jeng.host.degraded_fetches
    _assert_host_counters(eng, jeng)
    assert _log(fired_t) == _log(fired_j)


def test_rows_degraded_chunked_matches_reference(setup, reference):
    """A chunked run (budget 8) whose fill prefix reads all exhaust their
    retries: the fill chunks that needed host rows degrade (those rows
    leave the prefix), and tokens and fault counters per uid equal the
    reference's."""
    specs = [dict(site="fetch.gather", kind="fail", count=None,
                  match={"kind": "rows"})]
    kw = dict(prefill_budget=8, fetch_max_retries=1, fetch_backoff_s=0.0)
    want, jeng, fired_j = reference("rows_degraded", specs, **kw)
    got, eng, fired_t = _port_run(setup, specs, **kw)
    _assert_matches_reference(got, want, "rows degraded")
    assert eng.degraded_steps == jeng.degraded_steps > 0
    # the fills needed host rows (the requests' fetched_bytes count them),
    # but a degraded fetch reads none: the host pool counts none for it
    assert sum(r.fetched_bytes for r in got.values()) > 0
    _assert_host_counters(eng, jeng)
    assert _log(fired_t, "rows") == _log(fired_j, "rows")


def test_quarantine_matches_reference(setup, reference):
    """``engine.slot`` fails uid 0 on both sides: the same uids are
    quarantined with the same error type, and the survivor's tokens equal
    the reference's."""
    specs = [dict(site="engine.slot", kind="fail", match={"uid": 0})]
    want, jeng, _ = reference("quarantine", specs)
    got, eng, _ = _port_run(setup, specs)
    assert ([r.uid for r in eng.quarantined]
            == [r.uid for r in jeng.quarantined] == [0])
    assert (got[0].error.split(":")[0] == want[0].error.split(":")[0]
            == "InjectedFault")
    np.testing.assert_array_equal(got[1].output, want[1].output)
    np.testing.assert_array_equal(got[0].output, want[0].output)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_attention_ret_keep_matches_reference(seed):
    """``_segment_attention`` with a random ``ret_keep`` equals the
    reference's on seeded float32 inputs within 1e-6; an all-True mask
    changes nothing, to the bit."""
    rng = np.random.RandomState(seed)
    b, G, Hg, hd, sink, W, k = 2, 2, 3, 16, 4, 8, 6
    f = np.float32
    qg = rng.randn(b, G, Hg, hd).astype(f)
    ks, vs = (rng.randn(b, sink, G, hd).astype(f) for _ in range(2))
    kr, vr = (rng.randn(b, G, Hg, k, hd).astype(f) for _ in range(2))
    kl, vl = (rng.randn(b, W, G, hd).astype(f) for _ in range(2))
    top = rng.randint(0, 40, size=(b, G, Hg, k)).astype(np.int32)
    pos = np.array([45, 30], np.int32)
    ws = pos + 1 - W
    enc = np.array([38, 24], np.int32)
    keep = rng.rand(b, G, Hg, k) < 0.5
    kw = dict(sink_size=sink, window_size=W, sm_scale=hd ** -0.5,
              softcap=0.0)
    arrays = (qg, ks, vs, kr, vr, kl, vl, top, ws, pos, enc)
    want = JA._segment_attention(*map(jnp.asarray, arrays),
                                 ret_keep=jnp.asarray(keep), **kw)
    t = [torch.from_numpy(a) for a in arrays]
    got = TA._segment_attention(*t, ret_keep=torch.from_numpy(keep), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    plain = TA._segment_attention(*t, **kw)
    ones = TA._segment_attention(*t, ret_keep=torch.ones(keep.shape,
                                                         dtype=torch.bool),
                                 **kw)
    assert torch.equal(plain, ones)
    assert not torch.equal(plain, got)


# ------------------------------------------------------ device faults -------
@pytest.mark.parametrize("where", ["admission", "chunk"])
def test_kernel_error_propagates_and_quarantines_nobody(setup, monkeypatch,
                                                        where):
    """A ``KernelError`` (a kernel that did not build or launch) is a
    device fault, not one request's: raised by the tiered gather's plain
    version inside a chunk, or by the metadata scatter inside an admission
    (a quarantine boundary), it propagates out of ``step_serve()`` and
    quarantines nobody."""
    from repro_torch.core import cache as TCC

    def broken(*args, **kwargs):
        raise KB.KernelError("CUDA kernel failed to launch: cudaError 1")

    if where == "chunk":
        monkeypatch.setattr(gather_ops, "gather_heads_tiered_dedup_ref",
                            broken)
    else:
        monkeypatch.setattr(TCC, "tiered_scatter_prefill_meta", broken)
    eng = _engine(setup, **OFF)
    eng.start()
    with pytest.raises(KB.KernelError):
        eng.step_serve()
    assert eng.quarantined == [] and not any(r.failed for r in eng._done)


def test_fault_options_construct_and_serve(setup):
    """The fault options are accepted with the reference's defaults on
    every engine, and serve."""
    plan = FaultPlan([])
    eng = _engine(setup, **OFF)
    assert (eng.host.fetch_timeout_s, eng.host.fetch_max_retries,
            eng.host.fetch_backoff_s, eng.faults) == (None, 2, 0.005, None)
    for engine, kw in ((ServingEngine, {}), (PagedServingEngine, {}),
                       (PagedServingEngine, dict(OFF, fetch_timeout_s=1.0,
                                                 fetch_max_retries=3,
                                                 fetch_backoff_s=0.0))):
        eng = _engine(setup, specs=[(140, 3)], engine=engine, faults=plan,
                      **kw)
        done = eng.run()
        assert len(done[0].output) == 3 and eng.quarantined == []
        eng.close()
