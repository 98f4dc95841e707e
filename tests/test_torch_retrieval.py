"""Fused paged retrieval and the paged cache: the port against the JAX
reference across a drift loop (80 decode steps with promotions), on the
same numpy keys, values and queries (CPU, float32).

At every step: the incremental histograms equal the reference's and a
recompute from the pool; Stage-I coarse scores, the top-C candidate sets,
the winners and their physical rows are identical; the pool metadata the
promotions wrote is identical (weights to float32 rounding)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cache as JCC  # noqa: E402
from repro.core import encode as JE  # noqa: E402
from repro.core import retrieval as JR  # noqa: E402
from repro.core import srht as JS  # noqa: E402
from repro.core.config import ParisKVConfig as JP  # noqa: E402
from repro_torch.core import cache as TCC  # noqa: E402
from repro_torch.core import encode as TE  # noqa: E402
from repro_torch.core import retrieval as TR  # noqa: E402
from repro_torch.core import srht as TS  # noqa: E402
from repro_torch.core.config import ParisKVConfig as TP  # noqa: E402
from repro_torch.kernels.rerank.ref import block_relative  # noqa: E402

KW = dict(sink_size=16, local_size=64, update_interval=32, top_k=32,
          min_candidates=64)
CFG_J, CFG_T = JP(**KW), TP(**KW)
D, G, H = 64, 2, 4
SIGNS_J = jnp.asarray(JS.rademacher_signs(CFG_J.padded_dim(D),
                                          CFG_J.srht_seed))
SIGNS_T = torch.from_numpy(TS.rademacher_signs(CFG_T.padded_dim(D),
                                               CFG_T.srht_seed))
BS, NBLK, NUM_BLOCKS = 32, 8, 20
# jitted once per module: eager JAX would compile every primitive apart
PREFILL_J = jax.jit(JCC.prefill_write, static_argnums=(3,))


def _t(a):
    return torch.from_numpy(np.array(a))


def _tables(b, alloc, seed):
    """Shuffled block tables (b, NBLK); row i owns alloc[i] blocks, the
    rest are -1. Also the scatter rows with out-of-range sentinels."""
    perm = np.random.RandomState(seed).permutation(NUM_BLOCKS)
    bt = np.full((b, NBLK), -1, np.int32)
    used = 0
    for i, n in enumerate(alloc):
        bt[i, :n] = perm[used:used + n]
        used += n
    return bt, np.where(bt >= 0, bt, NUM_BLOCKS).astype(np.int32)


def _build(k, v, lens, bt, phys):
    """Solo-prefill each row on both sides and scatter it into a pool."""
    b = k.shape[0]
    n_max = BS * NBLK
    pool_j = JCC.init_paged_cache(NUM_BLOCKS, BS, G, D, CFG_J, jnp.float32)
    pool_t = TCC.init_paged_cache(NUM_BLOCKS, BS, G, D, CFG_T, torch.float32,
                                  "cpu")
    hists_j, hists_t, regs = [], [], []
    for i in range(b):
        c1 = JCC.init_layer_cache(1, n_max, G, D, CFG_J, jnp.float32)
        c1, r1 = PREFILL_J(c1, jnp.asarray(k[i:i + 1]),
                           jnp.asarray(v[i:i + 1]), CFG_J, SIGNS_J,
                           lengths=jnp.asarray(lens[i:i + 1]))
        stacked = JCC.paged_scatter_prefill(
            JCC.PagedLayerKVCache(*jax.tree.map(lambda a: a[None], pool_j)),
            jax.tree.map(lambda a: a[None], c1), jnp.asarray(phys[i]))
        pool_j = jax.tree.map(lambda a: a[0], stacked)
        hists_j.append(JCC.bucket_hist_from_meta(c1.meta_ids, r1, CFG_J))

        t1 = TCC.init_layer_cache(1, n_max, G, D, CFG_T, torch.float32, "cpu")
        t1, tr1 = TCC.prefill_write(t1, _t(k[i:i + 1]), _t(v[i:i + 1]), CFG_T,
                                    SIGNS_T, lengths=_t(lens[i:i + 1]))
        TCC.paged_scatter_prefill(pool_t, t1, _t(phys[i]))
        hists_t.append(TCC.bucket_hist_from_meta(t1.meta_ids, tr1, CFG_T))
        regs.append((int(r1.pos[0]), int(r1.enc_end[0])))
        assert (int(tr1.pos[0]), int(tr1.enc_end[0])) == regs[-1]
    pos, enc = map(np.asarray, zip(*regs))
    return (pool_j, jnp.concatenate(hists_j), pool_t, torch.cat(hists_t),
            pos.astype(np.int32), enc.astype(np.int32))


def _recompute(pool_t, bt_t, pos, enc):
    regions = TCC.CacheRegions(pos=_t(pos), enc_end=_t(enc))
    return TCC.bucket_hist_from_meta(TCC.paged_ids_view(pool_t, bt_t),
                                     regions, CFG_T)


def _assert_pools_equal(pool_j, pool_t):
    np.testing.assert_array_equal(pool_t.meta_ids.numpy(),
                                  np.asarray(pool_j.meta_ids))
    np.testing.assert_array_equal(pool_t.meta_codes.numpy(),
                                  np.asarray(pool_j.meta_codes).view(np.int32))
    np.testing.assert_allclose(pool_t.meta_w.numpy(),
                               np.asarray(pool_j.meta_w), rtol=1e-5)
    np.testing.assert_array_equal(pool_t.k.numpy(), np.asarray(pool_j.k))


def test_fused_retrieval_identical_across_drift():
    b, lens = 2, np.asarray([128, 40], np.int32)
    rng = np.random.RandomState(0)
    k = (rng.randn(b, 128, G, D) * np.linspace(2.0, 0.2, D)).astype(
        np.float32)
    v = rng.randn(b, 128, G, D).astype(np.float32)
    bt, phys = _tables(b, [7, 5], seed=0)
    pool_j, hist_j, pool_t, hist_t, pos, enc = _build(k, v, lens, bt, phys)
    btj, btt = jnp.asarray(bt), _t(bt)
    n_log = BS * NBLK
    C = CFG_J.candidate_count(n_log)

    append_j = jax.jit(JCC.paged_decode_append)
    promote_j = jax.jit(lambda p, h, bt_, r: JCC.paged_maybe_promote_hist(
        p, h, bt_, r, CFG_J, SIGNS_J))
    retrieve_j = jax.jit(lambda p, bt_, qt, h, e: JR.retrieve_paged_fused(
        p, bt_, qt, h, e, CFG_J, C, CFG_J.top_k))
    promotions = 0
    for step in range(80):
        kt = rng.randn(b, G, D).astype(np.float32)
        pos = pos + 1
        pool_j = append_j(pool_j, btj, jnp.asarray(kt), jnp.asarray(kt),
                          jnp.asarray(pos))
        TCC.paged_decode_append(pool_t, btt, _t(kt), _t(kt), _t(pos))
        reg_j = JCC.CacheRegions(pos=jnp.asarray(pos), enc_end=jnp.asarray(enc))
        pool_j, hist_j, reg_j = promote_j(pool_j, hist_j, btj, reg_j)
        _, hist_t, reg_t = TCC.paged_maybe_promote_hist(
            pool_t, hist_t, btt, TCC.CacheRegions(_t(pos), _t(enc)), CFG_T,
            SIGNS_T)
        new_enc = reg_t.enc_end.numpy()
        np.testing.assert_array_equal(new_enc, np.asarray(reg_j.enc_end))
        promotions += int((new_enc != enc).any())
        enc = new_enc

        np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j),
                                      err_msg=f"hist vs reference, {step}")
        np.testing.assert_array_equal(
            hist_t.numpy(), _recompute(pool_t, btt, pos, enc).numpy(),
            err_msg=f"hist invariant broke at step {step}")

        q = rng.randn(b, G, H // G, D).astype(np.float32)
        qj = JE.encode_query(jnp.asarray(q), CFG_J, SIGNS_J)
        qt = TE.encode_query(_t(q), CFG_T, SIGNS_T)
        want = retrieve_j(pool_j, btj, qj, hist_j, jnp.asarray(enc))
        got = TR.retrieve_paged_fused(pool_t, btt, qt, hist_t, _t(enc),
                                      CFG_T, C, CFG_T.top_k)
        msg = f"step {step}"
        np.testing.assert_array_equal(got.coarse_scores.numpy(),
                                      np.asarray(want.coarse_scores), msg)
        np.testing.assert_array_equal(got.cand_indices.numpy(),
                                      np.asarray(want.cand_indices), msg)
        order_t = np.argsort(got.indices.numpy(), -1)
        order_j = np.argsort(np.asarray(want.indices), -1)
        np.testing.assert_array_equal(
            np.take_along_axis(got.indices.numpy(), order_t, -1),
            np.take_along_axis(np.asarray(want.indices), order_j, -1), msg)
        np.testing.assert_array_equal(
            np.take_along_axis(got.phys_rows.numpy(), order_t, -1),
            np.take_along_axis(np.asarray(want.phys_rows), order_j, -1), msg)
        # estimates: float32 sums in another order (rtol 1e-5, atol 1e-4)
        np.testing.assert_allclose(
            np.take_along_axis(got.scores.numpy(), order_t, -1),
            np.take_along_axis(np.asarray(want.scores), order_j, -1),
            rtol=1e-5, atol=1e-4, err_msg=msg)
    assert promotions >= 2, "test never exercised post-promotion drift"
    _assert_pools_equal(pool_j, pool_t)


def test_hist_invariant_under_evict_and_readmit():
    """Evicting a row (zeroed blocks + zeroed hist) and re-admitting a new
    prompt into its blocks restores the invariant and matches the
    reference; the surviving row's histogram is untouched."""
    b, lens = 2, np.asarray([128, 96], np.int32)
    rng = np.random.RandomState(1)
    k = rng.randn(b, 128, G, D).astype(np.float32)
    bt, phys = _tables(b, [8, 6], seed=1)
    pool_j, hist_j, pool_t, hist_t, pos, enc = _build(k, k, lens, bt, phys)
    keep = hist_t[1].clone()
    TCC.paged_clear_blocks(pool_t, _t(phys[0]))
    hist_t[0] = 0
    assert (pool_t.k[bt[0][bt[0] >= 0]] == 0).all()
    k2 = rng.randn(1, 64, G, D).astype(np.float32)
    t1 = TCC.init_layer_cache(1, BS * NBLK, G, D, CFG_T, torch.float32, "cpu")
    t1, tr1 = TCC.prefill_write(t1, _t(k2), _t(k2), CFG_T, SIGNS_T,
                                lengths=_t([64]))
    TCC.paged_scatter_prefill(pool_t, t1, _t(phys[0]))
    hist_t[0] = TCC.bucket_hist_from_meta(t1.meta_ids, tr1, CFG_T)[0]
    pos[0], enc[0] = int(tr1.pos[0]), int(tr1.enc_end[0])
    np.testing.assert_array_equal(
        hist_t.numpy(), _recompute(pool_t, _t(bt), pos, enc).numpy())
    assert torch.equal(hist_t[1], keep)
    c1 = JCC.init_layer_cache(1, BS * NBLK, G, D, CFG_J, jnp.float32)
    _, r1 = JCC.prefill_write(c1, jnp.asarray(k2), jnp.asarray(k2), CFG_J,
                              SIGNS_J, lengths=jnp.asarray([64]))
    assert (int(r1.pos[0]), int(r1.enc_end[0])) == (pos[0], enc[0])


@pytest.mark.parametrize("lengths", [[5, 300, 1000], [8, 40, 200]])
def test_initial_regions_and_window(lengths):
    """Region boundaries after prefill match the reference (enc_end is
    clamped to the sink for short prompts)."""
    want = JCC.initial_regions(jnp.asarray(lengths, jnp.int32), CFG_J)
    got = TCC.initial_regions(torch.tensor(lengths), CFG_T)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.enc_end.numpy(),
                                  np.asarray(want.enc_end))
    assert TCC.window_size(CFG_T) == JCC.window_size(CFG_J)


def _contiguous(k, v, lens):
    """A batched contiguous cache prefilled on both sides (LEFT-aligned,
    per-row lengths)."""
    b, S = k.shape[:2]
    n_max = BS * NBLK
    c_j = JCC.init_layer_cache(b, n_max, G, D, CFG_J, jnp.float32)
    c_j, _ = PREFILL_J(c_j, jnp.asarray(k), jnp.asarray(v), CFG_J, SIGNS_J,
                       lengths=jnp.asarray(lens))
    c_t = TCC.init_layer_cache(b, n_max, G, D, CFG_T, torch.float32, "cpu")
    TCC.prefill_write(c_t, _t(k), _t(v), CFG_T, SIGNS_T, lengths=_t(lens))
    return c_j, c_t


def _select_sorted(scores, num_candidates):
    """Top-C by a stable descending sort (``lax.top_k``'s order, ties
    lowest index first): the reference's ``select_candidates``, the cut
    that the bucket top-C must match as a set."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :num_candidates].to(torch.int32)


def _retrieve(ids, codes, w, qt, enc_end, C, hist_sample, bucket_select):
    """``TR.retrieve``, or with ``bucket_select`` False the same pipeline
    cut by ``_select_sorted`` (descending) instead of the bucket top-C."""
    if bucket_select:
        return TR.retrieve(ids, codes, w, qt, enc_end, CFG_T, C, CFG_T.top_k,
                           hist_sample=hist_sample)
    coarse = TR.collision_scores_hist(ids, qt.q_sub, enc_end, CFG_T,
                                      hist_sample)[0]
    cand = _select_sorted(coarse, C)
    won = TR.rerank_topk(codes, w, qt, cand, enc_end, CFG_T, CFG_T.top_k)
    return TR.RetrievalResult(won.top_idx, won.top_est, cand, coarse,
                              won.phys_rows)


def _retrieve_paged(view, qt, enc_end, C, bt, hist_sample, bucket_select):
    """``TR.retrieve_paged`` through ``_retrieve``: the winners translated
    to physical pool rows through the block table."""
    if bucket_select:
        return TR.retrieve_paged(view, qt, enc_end, CFG_T, C, CFG_T.top_k, bt,
                                 BS, hist_sample=hist_sample)
    res = _retrieve(*view, qt, enc_end, C, hist_sample, False)
    blk, phys = block_relative(res.indices, bt, BS)
    return TR.PagedRetrievalResult(
        indices=res.indices, block_ids=blk, phys_rows=phys,
        scores=res.scores, cand_indices=res.cand_indices,
        coarse_scores=res.coarse_scores)


def _promote_block(cache, start, cfg, signs):
    """Encode keys [start, start + update_interval) of every row (the
    reference's ``promote_block``) through ``promote_rows``."""
    b = cache.k.shape[0]
    return TCC.promote_rows(cache, torch.full((b,), start, dtype=torch.int32),
                            torch.ones((b,), dtype=torch.bool), cfg, signs)


def _assert_same_retrieval(got, want, msg):
    """Integer outputs exact (winners as sets: equal estimates may order
    differently); estimates to float32 reassociation."""
    for name in ("coarse_scores", "cand_indices"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      f"{name}, {msg}")
    order_t = np.argsort(got.indices.numpy(), -1)
    order_j = np.argsort(np.asarray(want.indices), -1)
    fields = ["indices", "scores"] + (
        ["phys_rows"] if hasattr(want, "phys_rows") else [])
    for name in fields:
        a = np.take_along_axis(getattr(got, name).numpy(), order_t, -1)
        b = np.take_along_axis(np.asarray(getattr(want, name)), order_j, -1)
        if name == "scores":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3,
                                       err_msg=f"{name}, {msg}")
        else:
            np.testing.assert_array_equal(a, b, f"{name}, {msg}")


@pytest.mark.parametrize("hist_sample,bucket_select",
                         [(0, True), (0, False), (64, True), (64, False)])
def test_contiguous_and_meta_view_retrieval_identical_across_drift(
        hist_sample, bucket_select):
    """``retrieve`` over a contiguous cache and ``retrieve_paged`` over a
    shuffled paged pool's materialized view (block tables with -1
    entries) against the reference over 80 decode steps with promotions:
    Stage-I scores, candidates, winners and physical rows identical,
    estimates within rtol 1e-4 / atol 1e-3; ``rerank``'s enc_end mask
    selects the same invalid candidates as the reference's valid[cand]."""
    b, lens = 2, np.asarray([128, 40], np.int32)
    rng = np.random.RandomState(7)
    k = (rng.randn(b, 128, G, D) * np.linspace(2.0, 0.2, D)).astype(
        np.float32)
    v = rng.randn(b, 128, G, D).astype(np.float32)
    bt, phys = _tables(b, [7, 5], seed=2)
    pool_j, hist_j, pool_t, hist_t, pos, enc = _build(k, v, lens, bt, phys)
    c_j, c_t = _contiguous(k, v, lens)
    btj, btt = jnp.asarray(bt), _t(bt)
    n = BS * NBLK
    C = CFG_J.candidate_count(n)
    kw = dict(hist_sample=hist_sample, bucket_select=bucket_select)

    def j_retrieve(ids, codes, w, qt, valid):
        meta = JE.KeyMetadata(ids[:, :, None], codes[:, :, None],
                              w[:, :, None])
        return JR.retrieve(meta, qt, valid, CFG_J, C, CFG_J.top_k, **kw)

    retrieve_j = jax.jit(j_retrieve)
    view_j = jax.jit(JCC.paged_meta_view)
    paged_j = jax.jit(lambda view, qt, valid, bt_: JR.retrieve_paged(
        JE.KeyMetadata(*(a[:, :, None] for a in view)), qt, valid, CFG_J,
        C, CFG_J.top_k, bt_, BS, **kw))
    rerank_j = jax.jit(lambda ids, codes, w, qt, cand, valid: JR.rerank(
        JE.KeyMetadata(ids[:, :, None], codes[:, :, None], w[:, :, None]),
        qt, cand, valid, CFG_J))
    append_j = jax.jit(JCC.paged_decode_append)
    promote_j = jax.jit(lambda p, h, bt_, r: JCC.paged_maybe_promote_hist(
        p, h, bt_, r, CFG_J, SIGNS_J))
    c_append_j = jax.jit(JCC.decode_append)
    c_promote_j = jax.jit(lambda c, r: JCC.maybe_promote(c, r, CFG_J,
                                                         SIGNS_J))
    promotions = 0
    for step in range(80):
        kt = rng.randn(b, G, D).astype(np.float32)
        pos = pos + 1
        pj, pt = jnp.asarray(pos), _t(pos)
        pool_j = append_j(pool_j, btj, jnp.asarray(kt), jnp.asarray(kt), pj)
        TCC.paged_decode_append(pool_t, btt, _t(kt), _t(kt), pt)
        c_j = c_append_j(c_j, jnp.asarray(kt), jnp.asarray(kt), pj)
        TCC.decode_append(c_t, _t(kt), _t(kt), pt)
        reg_j = JCC.CacheRegions(pos=pj, enc_end=jnp.asarray(enc))
        reg_t = TCC.CacheRegions(pos=pt, enc_end=_t(enc))
        pool_j, hist_j, _ = promote_j(pool_j, hist_j, btj, reg_j)
        TCC.paged_maybe_promote_hist(pool_t, hist_t, btt, reg_t, CFG_T,
                                     SIGNS_T)
        c_j, reg_j = c_promote_j(c_j, reg_j)
        _, reg_t = TCC.maybe_promote(c_t, reg_t, CFG_T, SIGNS_T)
        new_enc = reg_t.enc_end.numpy()
        np.testing.assert_array_equal(new_enc, np.asarray(reg_j.enc_end))
        promotions += int((new_enc != enc).any())
        enc = new_enc

        valid_j = JCC.retrieval_valid_mask(n, reg_j, CFG_J)
        np.testing.assert_array_equal(
            TR.region_mask(n, reg_t.enc_end, CFG_T).numpy(),
            np.asarray(valid_j))
        valid_j = jnp.broadcast_to(valid_j[:, None, None], (b, G, 1, n))
        q = rng.randn(b, G, H // G, D).astype(np.float32)
        qj = JE.encode_query(jnp.asarray(q), CFG_J, SIGNS_J)
        qt = TE.encode_query(_t(q), CFG_T, SIGNS_T)
        msg = f"step {step}"

        want = retrieve_j(c_j.meta_ids, c_j.meta_codes, c_j.meta_w, qj,
                          valid_j)
        got = _retrieve(c_t.meta_ids, c_t.meta_codes, c_t.meta_w, qt,
                        reg_t.enc_end, C, hist_sample, bucket_select)
        _assert_same_retrieval(got, want, "contiguous " + msg)
        # the winners' rows in the store seen as one block per batch row
        np.testing.assert_array_equal(
            got.phys_rows.numpy(),
            got.indices.numpy() + n * np.arange(b)[:, None, None, None], msg)
        est_j = np.asarray(rerank_j(c_j.meta_ids, c_j.meta_codes, c_j.meta_w,
                                    qj, want.cand_indices, valid_j))
        est_t = TR.rerank(c_t.meta_codes, c_t.meta_w, qt, got.cand_indices,
                          reg_t.enc_end, CFG_T).numpy()
        np.testing.assert_array_equal(est_t == TR.NEG_INF, est_j == -1e30)
        np.testing.assert_allclose(est_t, est_j, rtol=1e-4, atol=1e-3)

        view_t = TCC.paged_meta_view(pool_t, btt)
        ids_j, codes_j, w_j = view_j(pool_j, btj)
        np.testing.assert_array_equal(view_t[0].numpy(), np.asarray(ids_j))
        np.testing.assert_array_equal(view_t[1].numpy(),
                                      np.asarray(codes_j).view(np.int32))
        np.testing.assert_allclose(view_t[2].numpy(), np.asarray(w_j),
                                   rtol=1e-5)
        want = paged_j(view_j(pool_j, btj), qj, valid_j, btj)
        got = _retrieve_paged(view_t, qt, reg_t.enc_end, C, btt, hist_sample,
                              bucket_select)
        _assert_same_retrieval(got, want, "meta view " + msg)
    assert promotions >= 2, "test never exercised post-promotion drift"
    np.testing.assert_array_equal(c_t.meta_ids.numpy(),
                                  np.asarray(c_j.meta_ids))


def test_contiguous_cache_ops_clamp_like_the_reference():
    """``decode_append`` at pos == n_max lands on the last row (JAX clamps
    the update slice), and ``promote_rows`` with a partial mask and a
    start past n_max - U encodes the clamped block of the masked rows
    only: integers exact, weights within 1e-6."""
    b, n = 3, 96
    rng = np.random.RandomState(11)
    k = rng.randn(b, n, G, D).astype(np.float32)
    lens = np.asarray([n, 50, 70], np.int32)
    c_j = JCC.init_layer_cache(b, n, G, D, CFG_J, jnp.float32)
    c_j, _ = PREFILL_J(c_j, jnp.asarray(k), jnp.asarray(k), CFG_J, SIGNS_J,
                       lengths=jnp.asarray(lens))
    c_t = TCC.init_layer_cache(b, n, G, D, CFG_T, torch.float32, "cpu")
    TCC.prefill_write(c_t, _t(k), _t(k), CFG_T, SIGNS_T, lengths=_t(lens))

    kt = rng.randn(b, G, D).astype(np.float32)
    pos = np.asarray([n, 50, n - 1], np.int32)
    c_j = JCC.decode_append(c_j, jnp.asarray(kt), jnp.asarray(-kt),
                            jnp.asarray(pos))
    TCC.decode_append(c_t, _t(kt), _t(-kt), _t(pos))
    np.testing.assert_array_equal(c_t.k.numpy(), np.asarray(c_j.k))
    np.testing.assert_array_equal(c_t.v.numpy(), np.asarray(c_j.v))
    np.testing.assert_array_equal(c_t.k[0, n - 1].numpy(), kt[0])

    promote_j = jax.jit(lambda c, st, mk: JCC.promote_rows(c, st, mk, CFG_J,
                                                           SIGNS_J))
    for starts, mask in (([n - 10, 20, 40], [True, False, True]),
                         ([0, n, 16], [False, True, True])):
        c_j = promote_j(c_j, jnp.asarray(starts, jnp.int32),
                        jnp.asarray(mask))
        TCC.promote_rows(c_t, torch.tensor(starts, dtype=torch.int32),
                         torch.tensor(mask), CFG_T, SIGNS_T)
        np.testing.assert_array_equal(c_t.meta_ids.numpy(),
                                      np.asarray(c_j.meta_ids))
        np.testing.assert_array_equal(
            c_t.meta_codes.numpy(), np.asarray(c_j.meta_codes).view(np.int32))
        np.testing.assert_allclose(c_t.meta_w.numpy(), np.asarray(c_j.meta_w),
                                   rtol=1e-6, atol=1e-6)
    c_j = jax.jit(lambda c: JCC.promote_block(c, jnp.int32(n - 3), CFG_J,
                                              SIGNS_J))(c_j)
    _promote_block(c_t, n - 3, CFG_T, SIGNS_T)
    np.testing.assert_array_equal(c_t.meta_ids.numpy(),
                                  np.asarray(c_j.meta_ids))
