"""Chunked prefill (``prefill_budget > 0``) in the port against the JAX
reference on the qwen2 smoke config in float32, on the staggered workload
of ``tests/test_chunked_prefill.py`` (prompts 33/48/70, 6/9/5 new tokens,
n_max 256, two slots): per uid the greedy tokens of the slot engine and of
the paged engine (fused and meta view, ample and 3-block pools) equal the
reference's chunked engine's and the port's own solo engine's. The
incremental histogram holds at every mixed step, a cancel mid-fill
reclaims blocks and histograms, and the chunk's modules match the
reference's on seeded numpy inputs: ``fill_enc_end``, the three chunk
writes and ``paged_fill_hist_update`` exactly, ``chunk_fill_attention``
and ``attn_fill_chunk`` to atol 1e-5. Each reference run happens once per
module."""
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
from repro.core import attention as JA  # noqa: E402
from repro.core import cache as JCC  # noqa: E402
from repro.core.config import ParisKVConfig as JP  # noqa: E402
from repro.core.encode import KeyMetadata as JMeta  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import PagedServingEngine as JPaged  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JSlot  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import attention as TA  # noqa: E402
from repro_torch.core import cache as TCC  # noqa: E402
from repro_torch.core.config import ParisKVConfig as TP  # noqa: E402
from repro_torch.core.encode import KeyMetadata as TMeta  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serving import (PagedServingEngine, Request,  # noqa: E402
                                 ServingEngine)

CFG_J = dataclasses.replace(JC.smoke("qwen2-1.5b"), dtype="float32")
CFG_T = dataclasses.replace(TC.smoke("qwen2-1.5b"), dtype="float32")
SPECS = [(33, 6), (48, 9), (70, 5)]
SLOT = dict(n_max=256, max_batch=2)
PAGED = dict(n_max=256, max_batch=2, block_size=64, chunk_size=4,
             prefill_budget=16)


@pytest.fixture(scope="module")
def workload():
    """Reference weights ×8 (varied greedy outputs), the port's copy, the
    prompts, and the port's solo (prefill_budget=0) tokens."""
    pj = jax.tree.map(lambda a: a * 8.0,
                      JM.init_params(CFG_J, jax.random.PRNGKey(2)))
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, CFG_J.vocab_size, size=(s,)).astype(np.int32)
               for s, _ in SPECS]
    pt = convert.params_from_jax(jax.device_get(pj), CFG_T, device="cpu")
    solo = _serve(ServingEngine(CFG_T, pt, chunk_size=4, device="cpu",
                                **SLOT), Request, prompts)
    return pj, pt, prompts, {u: r.output for u, r in solo.items()}


@pytest.fixture(scope="module")
def reference(workload):
    """case → the reference engine's outputs by uid, each case once."""
    pj, _, prompts, _ = workload
    cache = {}

    def run(case, make):
        if case not in cache:
            cache[case] = {u: r.output for u, r in
                           _serve(make(pj), JRequest, prompts).items()}
        return cache[case]
    return run


def _serve(eng, make_request, prompts):
    for i, ((_, gen), p) in enumerate(zip(SPECS, prompts)):
        eng.submit(make_request(uid=i, prompt=p, max_new_tokens=gen))
    return {r.uid: r for r in eng.run()}


def _assert_tokens(got, want, solo, label):
    assert sorted(got) == [0, 1, 2]
    for uid, (_, gen) in enumerate(SPECS):
        assert got[uid].output.shape == (gen,)
        np.testing.assert_array_equal(got[uid].output, want[uid],
                                      err_msg=f"{label}: request {uid} vs "
                                              f"the reference")
        np.testing.assert_array_equal(got[uid].output, solo[uid],
                                      err_msg=f"{label}: request {uid} vs "
                                              f"solo prefill")
        assert got[uid].ttft_s > 0 and len(got[uid].token_times) == gen


# ------------------------------------------------------------ engines ------
@pytest.mark.parametrize("budget,chunk", [(8, 4), (16, 4), (16, 8)])
def test_slot_engine_chunked_matches_reference_and_solo(workload, reference,
                                                        budget, chunk):
    """Fills spanning several chunks and completing mid-chunk."""
    _, pt, prompts, solo = workload
    want = reference(f"slot{budget}/{chunk}", lambda pj: JSlot(
        CFG_J, pj, chunk_size=chunk, prefill_budget=budget, **SLOT))
    got = _serve(ServingEngine(CFG_T, pt, chunk_size=chunk,
                               prefill_budget=budget, device="cpu", **SLOT),
                 Request, prompts)
    _assert_tokens(got, want, solo, f"slot budget={budget} chunk={chunk}")
    assert len(set(np.concatenate(list(solo.values())))) > 5


@pytest.mark.parametrize("num_blocks", [None, 3])
@pytest.mark.parametrize("fused", [True, False])
def test_paged_engine_chunked_matches_reference_and_solo(workload, reference,
                                                         fused, num_blocks):
    """Fused path and meta view, with an ample pool and a 3-block pool
    that serializes admissions; every block returns to the free list."""
    _, pt, prompts, solo = workload
    want = reference(f"paged{fused}/{num_blocks}", lambda pj: JPaged(
        CFG_J, pj, fused=fused, num_blocks=num_blocks, **PAGED))
    eng = PagedServingEngine(CFG_T, pt, fused=fused, num_blocks=num_blocks,
                             device="cpu", **PAGED)
    got = _serve(eng, Request, prompts)
    _assert_tokens(got, want, solo, f"paged fused={fused} "
                                    f"num_blocks={num_blocks}")
    assert len(eng._free) == eng.num_blocks
    assert eng._filling is None


def test_fill_hist_invariant_every_mixed_step(workload):
    """One mixed step per serving round (chunk_size=1): after every step —
    mid-fill, at completion, across admissions and evictions — each
    occupied slot's incremental histogram equals a recompute from the
    pool's ids over [sink, enc_end)."""
    _, pt, prompts, solo = workload
    eng = PagedServingEngine(CFG_T, pt, n_max=256, max_batch=2,
                             block_size=32, chunk_size=1, prefill_budget=8,
                             device="cpu")
    for i, ((_, gen), p) in enumerate(zip(SPECS, prompts)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=gen))
    eng.start()
    steps = mid_fill = 0
    while eng.pending():
        eng.step_serve()
        steps += 1
        mid_fill += eng._filling is not None
        eng.verify_hist()
        assert steps < 500, "serving loop did not converge"
    assert steps > 20 and mid_fill > 10
    done = {r.uid: r.output for r in eng._done}
    for uid in solo:
        np.testing.assert_array_equal(done[uid], solo[uid])


def test_cancel_mid_fill_reclaims_blocks_and_hist(workload):
    """cancel() while a slot is still filling: the fill stops, its blocks
    return to the free list, the histograms end zeroed, and the other
    request gives the solo engine's tokens."""
    _, pt, _, _ = workload
    rng = np.random.RandomState(3)
    prompts = {0: rng.randint(0, CFG_T.vocab_size, size=(200,)),
               1: rng.randint(0, CFG_T.vocab_size, size=(20,))}
    eng = PagedServingEngine(CFG_T, pt, n_max=256, max_batch=2,
                             block_size=32, chunk_size=4, prefill_budget=8,
                             device="cpu")
    eng.submit(Request(uid=0, prompt=prompts[0].astype(np.int32),
                       max_new_tokens=8))
    eng.submit(Request(uid=1, prompt=prompts[1].astype(np.int32),
                       max_new_tokens=6))
    eng.start()
    eng.step_serve()
    eng.step_serve()
    fp = eng._state.fill_pos
    assert 0 < fp[0] < 200, "expected uid 0 to still be mid-fill"
    assert len(eng._alloc[0]) > 0
    eng.cancel(0)
    while eng.pending():
        eng.step_serve()
    done = {r.uid: r for r in eng._done}
    assert sorted(done) == [0, 1]
    assert done[0].cancelled and len(done[0].output) == 0
    assert done[1].output.shape == (6,) and not done[1].cancelled
    assert len(eng._free) == eng.num_blocks
    assert all(not lc["hist"].any() for lc in eng._state.caches)
    solo = ServingEngine(CFG_T, pt, n_max=256, max_batch=1, chunk_size=4,
                         device="cpu")
    solo.submit(Request(uid=1, prompt=prompts[1].astype(np.int32),
                        max_new_tokens=6))
    np.testing.assert_array_equal(done[1].output, solo.run()[0].output)


# ------------------------------------------------------------ modules ------
PCFG_J = JP(sink_size=8, local_size=32, update_interval=16, top_k=16,
            min_candidates=32)
PCFG_T = TP(sink_size=8, local_size=32, update_interval=16, top_k=16,
            min_candidates=32)
NB, BS, G, D, NC = 12, 16, 2, 64, 256
NSUB = PCFG_J.num_subspaces(D)
NBLK = 6


def _chunk(rng, P):
    k = rng.randn(P, G, D).astype(np.float32)
    v = rng.randn(P, G, D).astype(np.float32)
    meta = (rng.randint(0, NC, size=(G, P, NSUB)).astype(np.uint8),
            rng.randint(0, 2 ** 31, size=(G, P, NSUB)).astype(np.uint32),
            rng.randn(G, P, NSUB).astype(np.float32))
    return k, v, meta


def _pool(rng, n_meta, n_kv):
    return [rng.randn(n_kv, BS, G, D).astype(np.float32),
            rng.randn(n_kv, BS, G, D).astype(np.float32),
            rng.randint(0, NC, size=(n_meta, G, BS, NSUB)).astype(np.uint8),
            rng.randint(0, 2 ** 31, size=(n_meta, G, BS, NSUB)
                        ).astype(np.uint32),
            rng.randn(n_meta, G, BS, NSUB).astype(np.float32)]


def _port(arrays, cls):
    return cls(*[torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                  else a.copy()) for a in arrays])


def _same(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, w)


def _tmeta(meta):
    return TMeta(*[torch.from_numpy(m.view(np.int32) if m.dtype == np.uint32
                                    else m)[None] for m in meta])


def test_fill_enc_end_matches_reference():
    f = np.arange(0, 130, dtype=np.int32)
    want = np.asarray(JCC.fill_enc_end(jnp.asarray(f), PCFG_J))
    np.testing.assert_array_equal(
        TCC.fill_enc_end(torch.from_numpy(f), PCFG_T).numpy(), want)
    assert [TCC.fill_enc_end(int(x), PCFG_T) for x in f] == want.tolist()


@pytest.mark.parametrize("start,valid_n", [(0, 12), (37, 12), (120, 5),
                                           (90, 3)])
def test_chunk_writes_match_reference(start, valid_n):
    """Contiguous, paged and tiered chunk writes: the pad tail, writes past
    the store or the table, through unallocated blocks and unstaged
    staging blocks are all dropped as the reference drops them."""
    P = 12
    rng = np.random.RandomState(start + valid_n)
    k, v, meta = _chunk(rng, P)
    valid = np.arange(P) < valid_n
    n = NBLK * BS
    # contiguous: 2 rows of n positions, row 1 written
    cont = [rng.randn(2, n, G, D).astype(np.float32),
            rng.randn(2, n, G, D).astype(np.float32),
            rng.randint(0, NC, size=(2, G, n, NSUB)).astype(np.uint8),
            rng.randint(0, 2 ** 31, size=(2, G, n, NSUB)).astype(np.uint32),
            rng.randn(2, G, n, NSUB).astype(np.float32)]
    want = JCC.fill_chunk_write(
        JCC.LayerKVCache(*map(jnp.asarray, cont)), 1, start, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(valid), JMeta(*map(jnp.asarray, meta)))
    got = TCC.fill_chunk_write(_port(cont, TCC.LayerKVCache), 1, start,
                               torch.from_numpy(k), torch.from_numpy(v),
                               valid_n, _tmeta(meta))
    _same(got, want)
    # paged: a table row with an unallocated block
    bt_row = np.array([5, 2, 9, -1, 0, 7], np.int32)
    pool = _pool(rng, NB, NB)
    want = JCC.paged_fill_chunk_write(
        JCC.PagedLayerKVCache(*map(jnp.asarray, pool)), jnp.asarray(bt_row),
        start, jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        JMeta(*map(jnp.asarray, meta)))
    got = TCC.paged_fill_chunk_write(_port(pool, TCC.PagedLayerKVCache),
                                     bt_row, start, torch.from_numpy(k),
                                     torch.from_numpy(v), valid_n,
                                     _tmeta(meta))
    _same(got, want)
    # tiered: metadata through the host row, K/V through the staging row
    dev_row = np.array([3, -1, 1, -1, 0, 2], np.int32)
    tier = _pool(rng, NB, 4)
    want = JCC.tiered_fill_chunk_write(
        JCC.PagedLayerKVCache(*map(jnp.asarray, tier)), jnp.asarray(bt_row),
        jnp.asarray(dev_row), start, jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(valid), JMeta(*map(jnp.asarray, meta)))
    got = TCC.tiered_fill_chunk_write(_port(tier, TCC.PagedLayerKVCache),
                                      bt_row, dev_row, start,
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), valid_n,
                                      _tmeta(meta))
    _same(got, want)


@pytest.mark.parametrize("f0,f1", [(0, 12), (30, 42), (36, 48), (60, 90),
                                   (80, 95)])
def test_paged_fill_hist_update_matches_reference(f0, f1):
    """The histogram increment of a fill step through a table row with an
    unallocated block, integers exact."""
    rng = np.random.RandomState(f0 * 7 + f1)
    ids = rng.randint(0, NC, size=(NB, G, BS, NSUB)).astype(np.uint8)
    pool = _pool(rng, NB, NB)
    pool[2] = ids
    bt_row = np.array([5, 2, 9, -1, 0, 7], np.int32)
    hist = rng.randint(0, 50, size=(G, NSUB, NC)).astype(np.int32)
    want = JCC.paged_fill_hist_update(
        JCC.PagedLayerKVCache(*map(jnp.asarray, pool)), jnp.asarray(hist),
        jnp.asarray(bt_row), jnp.int32(f0), jnp.int32(f1), PCFG_J,
        f1 - f0 + 1)
    got = torch.from_numpy(hist.copy())[None]
    TCC.paged_fill_hist_update(_port(pool, TCC.PagedLayerKVCache), got,
                               torch.from_numpy(bt_row)[None], f0, f1,
                               PCFG_T)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_chunk_fill_attention_and_layer_match_reference():
    """Chunk-causal attention over a prefix with invalid entries and a
    chunk with a pad tail; then the whole layer (qkv with bias at the
    chunk's positions, attention, output projection)."""
    rng = np.random.RandomState(5)
    b, P, H, n = 1, 8, 4, 40
    q = rng.randn(b, P, H, D).astype(np.float32)
    kp, vp = (rng.randn(b, n, G, D).astype(np.float32) for _ in range(2))
    kn, vn = (rng.randn(b, P, G, D).astype(np.float32) for _ in range(2))
    start = 33
    pref_pos = np.where(np.arange(n) < start, np.arange(n), -1)[None]
    q_pos = (start + np.arange(P))[None]
    new_pos = np.where(np.arange(P) < 5, q_pos, -1)
    want = JA.chunk_fill_attention(
        *map(jnp.asarray, (q, kp, vp, pref_pos, kn, vn, q_pos, new_pos)),
        sm_scale=0.125)
    got = TA.chunk_fill_attention(
        *map(torch.from_numpy, (q, kp, vp, pref_pos, kn, vn, q_pos,
                                new_pos)), sm_scale=0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)

    dm = 32
    p = {"wq": rng.randn(dm, H * D), "wk": rng.randn(dm, G * D),
         "wv": rng.randn(dm, G * D), "wo": rng.randn(H * D, dm),
         "bq": rng.randn(H * D), "bk": rng.randn(G * D),
         "bv": rng.randn(G * D)}
    p = {k: (0.1 * a).astype(np.float32) for k, a in p.items()}
    x = rng.randn(b, P, dm).astype(np.float32)
    spec_j = JL.AttnSpec(num_heads=H, num_kv_heads=G, head_dim=D,
                         rope_theta=1e6, qkv_bias=True)
    spec_t = TL.AttnSpec(num_heads=H, num_kv_heads=G, head_dim=D,
                         rope_theta=1e6, qkv_bias=True)
    wy, wk, wv = JL.attn_fill_chunk(
        {k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x), spec_j,
        *map(jnp.asarray, (q_pos, kp, vp, pref_pos, new_pos)))
    gy, gk, gv = TL.attn_fill_chunk(
        {k: torch.from_numpy(a) for k, a in p.items()}, torch.from_numpy(x),
        spec_t, *map(torch.from_numpy, (q_pos, kp, vp, pref_pos, new_pos)))
    for g, w in ((gy, wy), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
