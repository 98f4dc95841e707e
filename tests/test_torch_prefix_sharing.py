"""Block-granular prefix sharing (``share_prefixes=True``) in the port
against the JAX reference on the qwen2 smoke config in float32, at the
workload of ``tests/test_prefix_sharing.py`` (four prompts sharing a
144-token prefix with distinct 17-token suffixes, blocks of 16, budget
16, four slots on both sides). Weights are scaled ×8 so that greedy
outputs vary.

* Modules, exact: ``bucket_hist_from_paged_meta`` through a table row
  with an unallocated block, ``admit_fill(fill_start=…)``'s regions,
  frontier and histogram rows, and the chained prefix digests.
* Engines: per uid the tokens, ``blocks_consumed``, ``shared_block_hits``
  and ``shared_prefix_blocks`` of the fused engine and the meta view
  equal the reference's; the offloaded engine's tokens and exact staging
  statistics equal the reference offloaded engine's. Sharing tokens
  equal unshared and solo tokens, and ``verify_invariants()`` holds at
  every chunk boundary.
* The reference's own bars on the port: a backpressured pool, refcounts
  surviving the donor's exit and a cancel (resident and offloaded), a
  readmission hitting the index, the private tail block, the histogram
  at every mixed step, and the constructor gates.

Each reference engine runs once per module."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores, and torch's
# spinning OpenMP pool would otherwise slow each of them many times over
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core import cache as JCC  # noqa: E402
from repro.core.config import ParisKVConfig as JP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import serve as JSV  # noqa: E402
from repro.serving import PagedServingEngine as JPaged  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import cache as TCC  # noqa: E402
from repro_torch.core.config import ParisKVConfig as TP  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import serve as TSV  # noqa: E402
from repro_torch.serving import (OffloadedPagedServingEngine,  # noqa: E402
                                 PagedServingEngine, Request,
                                 ServingEngine)

CFG_J = dataclasses.replace(JC.smoke("qwen2-1.5b"), dtype="float32")
CFG_T = dataclasses.replace(TC.smoke("qwen2-1.5b"), dtype="float32")
BS, GEN = 16, 6
SHARE = dict(n_max=512, max_batch=4, block_size=BS, chunk_size=4,
             prefill_budget=16)
OFFLOAD = dict(SHARE, offload=True, num_blocks=64, num_device_blocks=12)
EXACT = ("staging_hits", "staging_misses", "fetched_bytes",
         "prefetched_blocks", "prefetch_hits", "fetched_unique_bytes")


def _workload(seed=7, n_shared=144, n_suffix=17, n_req=4):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, CFG_J.vocab_size, size=(n_shared,))
    return [np.concatenate(
        [shared, rng.randint(0, CFG_J.vocab_size, size=(n_suffix,))]
    ).astype(np.int32) for _ in range(n_req)]


@pytest.fixture(scope="module")
def setup():
    """Reference weights ×8, the port's copy, the prompts and the port's
    solo (prefill_budget=0, contiguous) tokens."""
    pj = jax.tree.map(lambda a: a * 8.0,
                      JM.init_params(CFG_J, jax.random.PRNGKey(0)))
    pt = convert.params_from_jax(jax.device_get(pj), CFG_T, device="cpu")
    prompts = _workload()
    solo = _serve(ServingEngine(CFG_T, pt, n_max=512, max_batch=4,
                                chunk_size=4, device="cpu"), Request, prompts)
    return pj, pt, prompts, {u: r.output for u, r in solo.items()}


@pytest.fixture(scope="module")
def reference(setup):
    """case → (the reference engine, its requests by uid), each once."""
    pj, _, prompts, _ = setup
    cache = {}

    def run(case, **kw):
        if case not in cache:
            eng = JPaged(CFG_J, pj, share_prefixes=True, **kw)
            cache[case] = (eng, _serve(eng, JRequest, prompts))
            if hasattr(eng, "close"):
                eng.close()
        return cache[case]
    return run


def _serve(eng, make_request, prompts, gen=GEN, audit=False):
    """Serve ``prompts`` (uid = index); ``audit``: ``verify_invariants()``
    at every chunk boundary."""
    for i, p in enumerate(prompts):
        eng.submit(make_request(uid=i, prompt=p, max_new_tokens=gen))
    if not audit:
        return {r.uid: r for r in eng.run()}
    eng.start()
    steps = 0
    while eng.pending():
        eng.step_serve()
        eng.verify_invariants()
        steps += 1
        assert steps < 500, "serving loop did not converge"
    return {r.uid: r for r in eng._done}


def _assert_drained(eng):
    assert len(eng._free) == eng.num_blocks
    assert not eng._refcnt and not eng._prefix_index and not eng._block_hash


# ------------------------------------------------------------ modules ------
PCFG_J = JP(sink_size=8, local_size=32, update_interval=16, top_k=16,
            min_candidates=32)
PCFG_T = TP(sink_size=8, local_size=32, update_interval=16, top_k=16,
            min_candidates=32)
NB, G, NSUB, NC = 12, 2, 8, 256
BT_ROW = np.array([5, -1, 9, 3, 0, 7], np.int32)   # block 1 unallocated


def _meta_pool(rng):
    return [np.zeros((NB, BS, G, 64), np.float32),
            np.zeros((NB, BS, G, 64), np.float32),
            rng.randint(0, NC, size=(NB, G, BS, NSUB)).astype(np.uint8),
            np.zeros((NB, G, BS, NSUB), np.uint32),
            np.zeros((NB, G, BS, NSUB), np.float32)]


@pytest.mark.parametrize("enc_end", [0, 8, 21, 37, 64, 96])
def test_bucket_hist_from_paged_meta_matches_reference(enc_end):
    """Empty, sink-only, inside a block, across the unallocated block, and
    the whole table: integers exact."""
    pool = _meta_pool(np.random.RandomState(enc_end))
    want = JCC.bucket_hist_from_paged_meta(
        JCC.PagedLayerKVCache(*map(jnp.asarray, pool)), jnp.asarray(BT_ROW),
        jnp.int32(enc_end), PCFG_J)
    got = TCC.bucket_hist_from_paged_meta(
        TCC.PagedLayerKVCache(*[torch.from_numpy(a.view(np.int32) if
                                                 a.dtype == np.uint32 else a)
                                for a in pool]),
        torch.from_numpy(BT_ROW), enc_end, PCFG_T)
    assert got.shape == (G, NSUB, NC) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (enc_end > 8) == bool(got.any())


@pytest.mark.parametrize("fill_start", [None, 0, 48, 64])
def test_admit_fill_matches_reference(fill_start):
    """The shared admission's regions, frontier, prompt buffer and every
    layer's histogram rows equal the reference's (the other slot's row
    untouched); ``fill_start`` None and 0 are the unshared admission."""
    rng = np.random.RandomState(3 if fill_start is None else fill_start)
    nl, b, n_max, P = CFG_J.num_layers, 2, 96, 16
    ids = rng.randint(0, CFG_J.pariskv.num_centroids(),
                      size=(nl, NB, CFG_J.num_kv_heads, BS,
                            CFG_J.pariskv.num_subspaces(CFG_J.head_dim))
                      ).astype(np.uint8)
    hist0 = rng.randint(0, 9, size=(nl, b) + ids.shape[2:3] + (
        ids.shape[4], CFG_J.pariskv.num_centroids())).astype(np.int32)
    prow = np.zeros((n_max + P,), np.int32)
    prow[:70] = rng.randint(0, CFG_J.vocab_size, size=(70,))
    js = JSV.init_paged_slot_state(CFG_J, b, NB, BS, n_max, prefill_budget=P)
    lc = js.caches[0]["l0"]
    js = js._replace(caches=[{"l0": {
        "kv": lc["kv"]._replace(meta_ids=jnp.asarray(ids)),
        "hist": jnp.asarray(hist0)}}])
    ts = TSV.init_paged_slot_state(CFG_T, b, NB, BS, device="cpu",
                                   n_max=n_max, prefill_budget=P)
    for li, tc in enumerate(ts.caches):
        tc["kv"].meta_ids.copy_(torch.from_numpy(ids[li]))
        tc["hist"].copy_(torch.from_numpy(hist0[li]))
    kw = {} if fill_start is None else dict(fill_start=fill_start)
    want = JSV.admit_fill(js, 1, jnp.asarray(prow), 70, 5,
                          bt_row=jnp.asarray(BT_ROW), pcfg=CFG_J.pariskv,
                          **({k: jnp.int32(v) for k, v in kw.items()}))
    got = TSV.admit_fill(ts, 1, prow, 70, 5, bt_row=torch.from_numpy(BT_ROW),
                         pcfg=CFG_T.pariskv, **kw)
    for name in ("pos", "enc_end"):
        np.testing.assert_array_equal(getattr(got.regions, name).numpy(),
                                      np.asarray(getattr(want.regions, name)))
    np.testing.assert_array_equal(got.fill_pos, np.asarray(want.fill_pos))
    np.testing.assert_array_equal(got.fill_len, np.asarray(want.fill_len))
    np.testing.assert_array_equal(got.prompt.numpy(), np.asarray(want.prompt))
    np.testing.assert_array_equal(got.remaining.numpy(),
                                  np.asarray(want.remaining))
    jh = np.asarray(want.caches[0]["l0"]["hist"])
    for li, tc in enumerate(got.caches):
        np.testing.assert_array_equal(tc["hist"].numpy(), jh[li],
                                      err_msg=f"layer {li}")
    np.testing.assert_array_equal(jh[:, 0], hist0[:, 0])
    assert bool(jh[:, 1].any()) == bool(fill_start)


def test_chain_hashes_match_reference(setup):
    """The same SHA-256 digests as the reference engine's, for prompts
    shorter than a block, of whole blocks and with a partial tail (the
    block holding the last token is never shareable)."""
    pj, pt, prompts, _ = setup
    jeng = JPaged(CFG_J, pj, share_prefixes=True, **SHARE)
    teng = PagedServingEngine(CFG_T, pt, share_prefixes=True, device="cpu",
                              **SHARE)
    rng = np.random.RandomState(11)
    cases = prompts + [rng.randint(0, 500, size=(n,)).astype(np.int32)
                       for n in (1, 15, 16, 17, 32, 33)]
    for p in cases:
        want = jeng._chain_hashes(p)
        assert teng._chain_hashes(p) == want
        assert len(want) == (len(p) - 1) // BS
    assert len(teng._chain_hashes(prompts[0])) == 10


# ------------------------------------------------------------ engines ------
@pytest.mark.parametrize("fused", [True, False])
def test_share_engine_matches_reference(setup, reference, fused):
    """Fused engine and meta view at the reference's batch shape: tokens
    and sharing counters per uid equal the reference's, and the tokens
    equal the unshared paged engine's and solo prefill's while fewer
    blocks are drawn from the pool."""
    _, pt, prompts, solo = setup
    jeng, want = reference(f"fused={fused}", fused=fused, **SHARE)
    eng = PagedServingEngine(CFG_T, pt, share_prefixes=True, fused=fused,
                             device="cpu", **SHARE)
    got = _serve(eng, Request, prompts, audit=True)
    base = PagedServingEngine(CFG_T, pt, fused=fused, device="cpu", **SHARE)
    unshared = _serve(base, Request, prompts)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for uid in want:
        np.testing.assert_array_equal(got[uid].output, want[uid].output,
                                      err_msg=f"uid {uid} vs the reference")
        np.testing.assert_array_equal(got[uid].output, solo[uid],
                                      err_msg=f"uid {uid} vs solo prefill")
        np.testing.assert_array_equal(unshared[uid].output, solo[uid],
                                      err_msg=f"uid {uid} unshared vs solo")
        assert (got[uid].shared_prefix_blocks
                == want[uid].shared_prefix_blocks)
    assert [got[u].shared_prefix_blocks for u in range(4)] == [0, 9, 9, 9]
    assert eng.blocks_consumed == jeng.blocks_consumed
    assert eng.shared_block_hits == jeng.shared_block_hits == 27
    assert eng.blocks_consumed < base.blocks_consumed
    assert base.shared_block_hits == 0
    _assert_drained(eng)


def test_share_backpressured_pool(setup):
    """A pool too small for every request at once (24 blocks, two slots)
    still admits, shares and reclaims; the reservation discounts mapped
    blocks, and the tokens are solo prefill's."""
    _, pt, prompts, solo = setup
    eng = PagedServingEngine(CFG_T, pt, share_prefixes=True, device="cpu",
                             **dict(SHARE, num_blocks=24, max_batch=2))
    got = _serve(eng, Request, prompts, audit=True)
    for uid in solo:
        np.testing.assert_array_equal(got[uid].output, solo[uid],
                                      err_msg=f"uid {uid}")
    assert eng.shared_block_hits > 0
    _assert_drained(eng)


def _two_slot(pt, **kw):
    return PagedServingEngine(CFG_T, pt, n_max=512, max_batch=2,
                              block_size=BS, chunk_size=4, prefill_budget=16,
                              share_prefixes=True, device="cpu", **kw)


def test_refcount_survives_donor_exit_and_readmission_hits(setup):
    """The donor finishes while the sharer decodes: the shared prefix
    survives (index and one holder per block), a request admitted then
    maps it again, and at the end the index and refcounts are empty."""
    _, pt, prompts, _ = setup
    eng = _two_slot(pt)
    eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=12))
    eng.submit(Request(uid=1, prompt=prompts[1], max_new_tokens=48))
    eng.start()
    saw_shared = readmitted = False
    hits0 = steps = 0
    while eng.pending():
        eng.step_serve()
        eng.verify_invariants()
        steps += 1
        assert steps < 500, "serving loop did not converge"
        live = {r.uid for r in eng._slots if r is not None}
        if {0, 1} <= live and any(v >= 2 for v in eng._refcnt.values()):
            saw_shared = True
        if not readmitted and saw_shared and live == {1} and not eng.queue:
            assert eng._prefix_index, "index dropped while a holder lives"
            assert all(v == 1 for v in eng._refcnt.values())
            hits0 = eng.shared_block_hits
            eng.submit(Request(uid=2, prompt=prompts[2], max_new_tokens=2))
            readmitted = True
    done = {r.uid: r for r in eng._done}
    assert saw_shared and readmitted
    assert sorted(done) == [0, 1, 2]
    assert eng.shared_block_hits > hits0 and done[2].shared_prefix_blocks == 9
    _assert_drained(eng)


def _cancel_donor(eng, prompts):
    """uid 0 (20 new) donates, uid 1 (8 new) shares; uid 0 is cancelled as
    soon as both are live with a block held twice."""
    eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=20))
    eng.submit(Request(uid=1, prompt=prompts[1], max_new_tokens=8))
    eng.start()
    cancelled = False
    steps = 0
    while eng.pending():
        eng.step_serve()
        eng.verify_invariants()
        steps += 1
        assert steps < 500
        live = {r.uid for r in eng._slots if r is not None}
        if not cancelled and {0, 1} <= live and \
                any(v >= 2 for v in eng._refcnt.values()):
            eng.cancel(0)
            cancelled = True
    assert cancelled
    return {r.uid: r for r in eng._done}


@pytest.mark.parametrize("offload", [False, True])
def test_refcount_survives_cancel(setup, offload):
    """Cancelling the donor mid-decode leaves the sharer's blocks intact
    on both tiers: its tokens are solo prefill's, and at the end both
    tiers are scrubbed and drained."""
    _, pt, prompts, _ = setup
    kw = dict(offload=True, num_blocks=64, num_device_blocks=12) \
        if offload else {}
    eng = _two_slot(pt, **kw)
    done = _cancel_donor(eng, prompts)
    assert done[0].cancelled and 0 < len(done[0].output) < 20
    solo = ServingEngine(CFG_T, pt, n_max=512, max_batch=2, chunk_size=4,
                         device="cpu")
    solo.submit(Request(uid=1, prompt=prompts[1], max_new_tokens=8))
    np.testing.assert_array_equal(done[1].output, solo.run()[0].output)
    _assert_drained(eng)
    for lc in eng._state.caches:
        assert not lc["hist"].any() and not lc["kv"].meta_ids.any()
    if offload:
        assert eng.staging.resident_count() == 0
        for name in eng.host.k:
            assert not eng.host.k[name].any() and not eng.host.v[name].any()


def test_tail_block_private_copy_on_write(setup):
    """Identical prompts share every full block but the one holding the
    last prompt token: each holder's decode writes land in its own
    block, and both emit the same tokens."""
    _, pt, _, _ = setup
    prompt = np.random.RandomState(3).randint(
        0, CFG_T.vocab_size, size=(53,)).astype(np.int32)  # 3 blocks + 5
    eng = _two_slot(pt)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=20))
    eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=20))
    eng.start()
    checked = False
    steps = 0
    while eng.pending():
        eng.step_serve()
        steps += 1
        assert steps < 500
        live = {r.uid for r in eng._slots if r is not None}
        if ({0, 1} <= live and eng._bt[1, 3] >= 0
                and eng.shared_block_hits >= 3 and not checked):
            bt = eng._bt.copy()
            np.testing.assert_array_equal(bt[0, :3], bt[1, :3])
            assert bt[0, 3] != bt[1, 3], "tail block was shared"
            assert all(eng._refcnt[int(b)] == 2 for b in bt[0, :3])
            assert eng._refcnt[int(bt[0, 3])] == eng._refcnt[int(bt[1, 3])] == 1
            checked = True
    assert checked
    done = {r.uid: r for r in eng._done}
    np.testing.assert_array_equal(done[0].output, done[1].output)
    _assert_drained(eng)


def test_hist_invariant_every_mixed_step(setup):
    """One mixed step per round (chunk_size=1): after every step,
    including the admissions whose histograms were rebuilt from the
    mapped blocks' metadata, the audit holds (histograms == recompute)."""
    _, pt, _, _ = setup
    prompts = _workload(n_shared=96, n_suffix=13, n_req=3)
    eng = PagedServingEngine(CFG_T, pt, n_max=256, max_batch=2,
                             block_size=BS, chunk_size=1, prefill_budget=8,
                             share_prefixes=True, device="cpu")
    got = _serve(eng, Request, prompts, gen=4, audit=True)
    assert sorted(got) == [0, 1, 2]
    assert eng.shared_block_hits > 0 and eng.decode_steps > 15
    _assert_drained(eng)


def test_offload_share_matches_reference(setup, reference):
    """The offloaded engine with sharing (12 of 64 blocks staged): tokens,
    sharing counters and the exact staging statistics per uid equal the
    reference offloaded engine's, its tokens equal solo prefill's, and
    at the end refcounts are empty and staging drained."""
    _, pt, prompts, solo = setup
    jeng, want = reference("offload", **OFFLOAD)
    eng = PagedServingEngine(CFG_T, pt, share_prefixes=True, device="cpu",
                             **OFFLOAD)
    assert isinstance(eng, OffloadedPagedServingEngine)
    got = _serve(eng, Request, prompts, audit=True)
    for uid in want:
        np.testing.assert_array_equal(got[uid].output, want[uid].output,
                                      err_msg=f"uid {uid}")
        np.testing.assert_array_equal(got[uid].output, solo[uid])
        for name in EXACT + ("shared_prefix_blocks",):
            assert getattr(got[uid], name) == getattr(want[uid], name), \
                (uid, name)
    assert eng.blocks_consumed == jeng.blocks_consumed
    assert eng.shared_block_hits == jeng.shared_block_hits == 27
    assert sum(r.staging_misses for r in got.values()) > 0
    assert eng.host.fetched_fill_rows > 0
    _assert_drained(eng)
    assert eng.staging.resident_count() == 0


# ------------------------------------------------------ constructor gates --
@pytest.mark.parametrize("offload", [False, True])
def test_share_requires_prefill_budget(setup, offload):
    _, pt, _, _ = setup
    kw = dict(offload=True, num_device_blocks=12) if offload else {}
    with pytest.raises(ValueError, match="prefill_budget"):
        PagedServingEngine(CFG_T, pt, n_max=128, max_batch=1,
                           share_prefixes=True, device="cpu", **kw)


@pytest.mark.parametrize("offload", [False, True])
def test_share_constructs_with_budget(setup, offload):
    _, pt, _, _ = setup
    kw = dict(offload=True, num_device_blocks=12) if offload else {}
    eng = PagedServingEngine(CFG_T, pt, n_max=128, max_batch=1,
                             block_size=BS, prefill_budget=16,
                             share_prefixes=True, device="cpu", **kw)
    assert eng.share_prefixes
    assert isinstance(eng, OffloadedPagedServingEngine) == offload


def test_share_unsupported_arch_raises(setup, monkeypatch):
    """A layer whose window lives in a slot-local ring buffer (a
    ``LayerDef`` with ``use_pariskv=False``) cannot be populated by a
    shared prefix: refused when the engine is built."""
    _, pt, _, _ = setup
    plan = TSV.layer_defs(CFG_T)
    assert TSV.share_support_reason(CFG_T) is None
    monkeypatch.setattr(TSV, "layer_defs", lambda cfg: plan[:1] + [
        dataclasses.replace(plan[1], use_pariskv=False)])
    assert "ring buffer" in TSV.share_support_reason(CFG_T)
    assert TSV.fill_supported(CFG_T) and not TSV.share_supported(CFG_T)
    with pytest.raises(ValueError, match="prefix sharing unavailable.*ring"):
        PagedServingEngine(CFG_T, pt, n_max=128, max_batch=1, block_size=BS,
                           prefill_budget=16, share_prefixes=True,
                           device="cpu")
