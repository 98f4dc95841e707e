"""The port's ``PagedServingEngine(offload=True)`` against the JAX
reference's ``OffloadedPagedServingEngine`` on the qwen2 smoke config in
float32, at the geometry of ``tests/test_offload_pool.py`` (a staging pool
of 16 of 64 host blocks, so eviction and write-back cycle). Weights are
scaled ×8 so that greedy outputs vary. Per uid the greedy tokens and the
exact staging statistics (``staging_hits``, ``staging_misses``,
``fetched_bytes``, ``prefetched_blocks``, ``prefetch_hits``, and the
deduplicated ``fetched_unique_bytes``) must be identical: the drift run
with and without overlap, the meta view, evict/readmit, cancel, a
mispredicting prefetch hook, no prefetch, and chunked prefill. Each
reference run happens once per module."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import (OffloadedPagedServingEngine,  # noqa: E402
                                 PagedServingEngine, Request)

CFG_J = dataclasses.replace(JC.smoke("qwen2-1.5b"), dtype="float32")
CFG_T = dataclasses.replace(TC.smoke("qwen2-1.5b"), dtype="float32")
NUM_BLOCKS, NUM_DEVICE = 64, 16
GEOM = dict(n_max=512, max_batch=2, block_size=16, num_blocks=NUM_BLOCKS,
            chunk_size=4)
EXACT = ("staging_hits", "staging_misses", "fetched_bytes",
         "prefetched_blocks", "prefetch_hits", "fetched_unique_bytes")
DRIFT = ((300, 80), (260, 10))
SHORT = ((300, 12), (260, 10))
THREE = ((300, 8), (260, 12), (140, 6))


def bad_hook(touched, k):
    """Coldest blocks first, plus ids the engine must reject."""
    order = np.argsort(touched, kind="stable")
    return [-3, NUM_BLOCKS + 5] + [int(b) for b in order[:k]]


@pytest.fixture(scope="module")
def setup():
    pj = jax.tree.map(lambda a: a * 8.0,
                      JM.init_params(CFG_J, jax.random.PRNGKey(2)))
    rng = np.random.RandomState(7)
    prompts = {n: rng.randint(0, CFG_J.vocab_size, size=(n,)).astype(np.int32)
               for n in (300, 260, 140)}
    pt = convert.params_from_jax(jax.device_get(pj), CFG_T, device="cpu")
    return pj, pt, prompts


def _serve(eng, make_request, specs, prompts, cancel_after=None):
    """Submit ``specs`` (uid = index) and serve them; with
    ``cancel_after``, uid 0 is cancelled after that many rounds."""
    for i, (plen, gen) in enumerate(specs):
        eng.submit(make_request(uid=i, prompt=prompts[plen],
                                max_new_tokens=gen))
    eng.start()
    rounds = 0
    while eng.pending():
        if rounds == cancel_after:
            eng.cancel(0)
        eng.step_serve()
        rounds += 1
    return {r.uid: r for r in eng._done}


@pytest.fixture(scope="module")
def reference(setup):
    """case → the reference's requests by uid, each case served once."""
    pj, _, prompts = setup
    cache = {}

    def run(case, specs, cancel_after=None, **kw):
        if case not in cache:
            eng = JEngine(CFG_J, pj, **GEOM, offload=True,
                          num_device_blocks=NUM_DEVICE, **kw)
            cache[case] = _serve(eng, JRequest, specs, prompts,
                                 cancel_after)
            eng.close()
        return cache[case]
    return run


def _port(setup, specs, cancel_after=None, audit=False, **kw):
    _, pt, prompts = setup
    eng = PagedServingEngine(CFG_T, pt, **GEOM, offload=True,
                             num_device_blocks=NUM_DEVICE, device="cpu", **kw)
    assert isinstance(eng, OffloadedPagedServingEngine)
    if not audit:
        return _serve(eng, Request, specs, prompts, cancel_after), eng
    for i, (plen, gen) in enumerate(specs):
        eng.submit(Request(uid=i, prompt=prompts[plen], max_new_tokens=gen))
    eng.start()
    while eng.pending():
        eng.step_serve()
        eng.verify_invariants()
    return {r.uid: r for r in eng._done}, eng


def _assert_same(got, want, label):
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].output, want[uid].output,
                                      err_msg=f"{label}: request {uid}")
        for name in EXACT:
            assert getattr(got[uid], name) == getattr(want[uid], name), \
                (label, uid, name)


@pytest.mark.parametrize("overlap", [True, False])
def test_drift_run_matches_reference(setup, reference, overlap):
    """80 decode steps over a 300-token context: the winners drift across
    the sequence and the 16-block staging pool cycles through eviction and
    write-back. Overlap on and off give the reference's tokens and
    statistics."""
    want = reference("drift", DRIFT)
    got, eng = _port(setup, DRIFT, overlap=overlap)
    _assert_same(got, want, f"drift overlap={overlap}")
    assert got[0].staging_misses > 0 and got[0].staging_hits > 0
    assert got[0].prefetch_hits > 0
    # winners repeated across query heads are read from host memory once
    assert 0 < got[0].fetched_unique_bytes < got[0].fetched_bytes
    assert eng.host.fetched_head_rows == sum(r.staging_misses
                                            for r in got.values())
    assert 0 < eng.host.fetched_unique_head_rows < eng.host.fetched_head_rows
    # one tiered gather per layer and step
    assert eng.fetch_callbacks == CFG_T.num_layers * eng.decode_steps
    assert sum(r.fetch_callbacks for r in got.values()) > 0
    assert all(r.fetch_stall_s == 0.0 for r in got.values())
    assert len(eng._free) == eng.num_blocks
    assert eng.staging.resident_count() == 0


def test_meta_view_matches_reference(setup, reference):
    want = reference("metaview", SHORT, fused=False)
    got, _ = _port(setup, SHORT, fused=False)
    _assert_same(got, want, "meta view")
    assert sum(r.staging_misses for r in got.values()) > 0


def test_evict_readmit_matches_reference(setup, reference):
    """Three requests through two slots: the third takes a slot and host
    blocks reclaimed from a finished request (staging released without
    write-back, host zeroed, fresh installs). The staging invariants and
    the histograms hold at every chunk boundary."""
    want = reference("evict", THREE)
    got, eng = _port(setup, THREE, audit=True)
    _assert_same(got, want, "evict/readmit")
    assert eng.peak_concurrency == 2
    assert len(eng._free) == eng.num_blocks


def test_cancel_matches_reference_and_reclaims_both_tiers(setup, reference):
    specs = ((300, 40), (260, 10))
    want = reference("cancel", specs, cancel_after=1)
    got, eng = _port(setup, specs, cancel_after=1)
    _assert_same(got, want, "cancel")
    assert got[0].cancelled and 0 < len(got[0].output) < 40
    assert len(eng._free) == eng.num_blocks
    assert eng.staging.resident_count() == 0
    assert (eng.staging.dev_map == -1).all()
    for name in eng.host.k:
        assert not eng.host.k[name].any() and not eng.host.v[name].any()
    for lc in eng._state.caches:
        assert not lc["hist"].any() and not lc["kv"].k.any()


@pytest.mark.parametrize("case,kw", [
    ("badhook", dict(prefetch_hook=bad_hook)),
    ("noprefetch", dict(prefetch=False))])
def test_prefetch_policy_moves_bytes_not_tokens(setup, reference, case, kw):
    """A hook that prefetches the least useful blocks (and out-of-range
    ids), and no prefetch at all, each give the reference's tokens and
    statistics under the same policy."""
    want = reference(case, SHORT, **kw)
    got, _ = _port(setup, SHORT, **kw)
    _assert_same(got, want, case)
    if case == "noprefetch":
        assert all(r.prefetched_blocks == 0 for r in got.values())


def test_chunked_prefill_matches_reference(setup, reference):
    """Mixed prefill+decode chunks (prefill_budget=8): the filling slot
    reads its prefix through the tiered gather, staged blocks from staging
    and the others from host memory, while its frontier stays pinned
    staged. Tokens and statistics (fill rows priced as full rows) equal
    the reference's, and so do the host pool's fill-row counts."""
    specs = ((300, 12), (260, 10))
    want = reference("chunked", specs, prefill_budget=8)
    got, eng = _port(setup, specs, prefill_budget=8)
    _assert_same(got, want, "chunked")
    assert eng.host.fetched_fill_rows > 0
    assert eng.host.fetched_unique_fill_rows == eng.host.fetched_fill_rows
    assert len(eng._free) == eng.num_blocks
    assert eng.staging.resident_count() == 0


def test_undersized_staging_pool_raises(setup):
    _, pt, prompts = setup
    eng = PagedServingEngine(CFG_T, pt, **GEOM, offload=True,
                             num_device_blocks=4, device="cpu")
    eng.submit(Request(uid=0, prompt=prompts[300], max_new_tokens=4))
    with pytest.raises(RuntimeError, match="staging pool exhausted"):
        eng.run()


@pytest.mark.parametrize("option,item", [
    (dict(share_prefixes=True, prefill_budget=16), "A8"),
    (dict(share_prefixes=True), "A8"),
    (dict(faults=object()), "A10"), (dict(fetch_timeout_s=0.5), "A10")])
def test_options_not_ported_raise_with_roadmap_item(setup, option, item):
    _, pt, _ = setup
    with pytest.raises(NotImplementedError, match=item):
        PagedServingEngine(CFG_T, pt, **GEOM, offload=True, device="cpu",
                           **option)


def test_mesh_shards_with_offload_raise(setup):
    _, pt, _ = setup
    with pytest.raises(NotImplementedError, match="resident engine"):
        PagedServingEngine(CFG_T, pt, **GEOM, offload=True, mesh_shards=2,
                           device="cpu")


def test_offloaded_engine_needs_a_card_or_an_explicit_cpu(setup):
    _, pt, _ = setup
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="params live on cpu"):
            PagedServingEngine(CFG_T, pt, **GEOM, offload=True)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedServingEngine(CFG_T, pt, **GEOM, offload=True)
