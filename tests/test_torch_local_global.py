"""gemma's local/global modules in the port against the reference, in
float32 on the same numpy inputs (CPU):

* ``layer_plan`` of gemma2-27b and gemma3-12b, field for field;
* qk-norm (``rms_norm(plus_one=True)`` before rope) with seeded non-zero
  scales, within 1e-5;
* ``blockwise_causal_attention`` with a window of 64 on lengths below, at
  and above it (the port's small chunks skip the chunks before a q
  chunk's window), within 1e-5;
* ``_ring_prefill`` on ragged lengths < w, = w and > 2w: identical rings;
* ``attn_decode_dense``'s ring branch at pos = w - 1, w and 2w + 3, and a
  ring shorter than the window (n_max 48 < w): the written ring
  identical, the output within 1e-5;
* a ring fill chunk of P = 100 > w = 64 (``_layer_fill``): every kept
  write is the chunk's own last write to its slot, the rest of the ring
  untouched, the ring within 1e-5 of the reference's and the layer's
  output within 1e-5 of its scale;
* the slot-local rings of the paged pool (``make_paged_caches``,
  ``admit_paged`` with a shorter bucketed ring);
* B = 32 (gemma3-smoke at head_dim 256, Hg = 2): the plain
  ``bucket_count`` and ``bucket_count_span`` equal the reference's
  ``bucket_histogram``; the plain Stage I equals the reference's Pallas
  ``collision_paged`` (interpret mode) and its ``seg_hist`` numpy's
  histograms; the cut is exact; Stage II's estimates agree within rtol
  1e-4 / atol 1e-3 with the selection exact."""
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
from repro.core import encode as JE  # noqa: E402
from repro.core import retrieval as JR  # noqa: E402
from repro.core import srht as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import serve as JSV  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import attention as TA  # noqa: E402
from repro_torch.core import cache as TCC  # noqa: E402
from repro_torch.core import encode as TE  # noqa: E402
from repro_torch.core import retrieval as TR  # noqa: E402
from repro_torch.kernels import SEG_LEN  # noqa: E402
from repro_torch.kernels.collision import (bucket_count,  # noqa: E402
                                           bucket_count_span)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import serve as TSV  # noqa: E402

W = 64          # the smoke configs' sliding window


def _t(a):
    return torch.from_numpy(np.array(a))           # writable copy


def _cfgs(arch, **extra):
    return (dataclasses.replace(JC.smoke(arch), dtype="float32", **extra),
            dataclasses.replace(TC.smoke(arch), dtype="float32", **extra))


def _local(arch):
    """The reference's and the port's local LayerDef of ``arch``'s smoke
    config, and seeded float32 parameters of one such layer (qk-norm
    scales non-zero) in both forms."""
    cfg_j, cfg_t = _cfgs(arch)
    ld_j = JM.layer_plan(cfg_j)[0].layers[0]
    ld_t = TM.layer_plan(cfg_t)[0].layers[0]
    pj = JM.init_layer(jax.random.PRNGKey(3), cfg_j, ld_j)
    rng = np.random.RandomState(5)

    def leaf(path, a):
        if jax.tree_util.keystr(path).endswith(("['q_norm']", "['k_norm']")):
            return jnp.asarray(0.5 * rng.standard_normal(a.shape),
                               jnp.float32)
        return a * 8.0
    pj = jax.tree_util.tree_map_with_path(leaf, pj)
    pt = jax.tree.map(lambda a: _t(np.asarray(a)), pj)
    return cfg_j, cfg_t, ld_j, ld_t, pj, pt


@pytest.mark.parametrize("arch", ["gemma2-27b", "gemma3-12b"])
def test_layer_plan_matches_reference(arch):
    """Period, repeat and every LayerDef field, the AttnSpec's fields
    (``causal`` included: True on every layer) and ``cross`` (False)."""
    for cfg_j, cfg_t in ((JC.get(arch), TC.get(arch)), _cfgs(arch)):
        plan_j, plan_t = JM.layer_plan(cfg_j), TM.layer_plan(cfg_t)
        assert len(plan_j) == len(plan_t) == 1
        (sj,), (st,) = plan_j, plan_t
        assert st.repeat == sj.repeat == cfg_t.num_layers // \
            cfg_t.local_global_period
        assert len(st.layers) == len(sj.layers) == cfg_t.local_global_period
        for lj, lt in zip(sj.layers, st.layers):
            assert (lt.mixer, lt.ffn, lt.d_ff, lt.use_pariskv, lt.cross) == (
                lj.mixer, lj.ffn, lj.d_ff, lj.use_pariskv, lj.cross)
            aj = dataclasses.asdict(lj.attn)
            assert aj["causal"] is True and lt.cross is False
            assert dataclasses.asdict(lt.attn) == aj
    (st,) = TM.layer_plan(TC.get(arch))
    local, glob = st.layers[0], st.layers[-1]
    assert local.attn.sliding_window == TC.get(arch).sliding_window
    assert not local.use_pariskv and glob.use_pariskv
    assert glob.attn.sliding_window == 0
    assert local.attn.qk_norm == glob.attn.qk_norm == (arch == "gemma3-12b")
    assert local.attn.softcap == (50.0 if arch == "gemma2-27b" else 0.0)
    assert local.attn.scale() == TC.get(arch).query_pre_attn_scalar ** -0.5


def test_qk_norm_projection_matches_reference():
    """gemma3's q/k projections with seeded non-zero qk-norm scales (scale
    1 + s, before rope) at ragged positions."""
    _, _, ld_j, ld_t, pj, pt = _local("gemma3-12b")
    assert ld_t.attn.qk_norm
    x = np.random.RandomState(1).randn(2, 11, 256).astype(np.float32)
    pos = np.array([np.arange(11), np.arange(40, 51)], np.int32)
    want = JL._project_qkv(pj["attn"], jnp.asarray(x), ld_j.attn,
                           jnp.asarray(pos))
    got = TL._project_qkv(pt["attn"], _t(x), ld_t.attn, _t(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    s = np.random.RandomState(2).randn(64).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(_t(x[..., :64]), _t(s), plus_one=True).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x[..., :64]), jnp.asarray(s),
                               plus_one=True)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S", [40, 64, 200])
def test_blockwise_window_matches_reference(S):
    """Window 64 with softcap on S below, at and above the window; the
    reference in one chunk, the port in chunks of 32 / 64 (ragged S padded,
    the chunks before each q chunk's window skipped)."""
    rng = np.random.RandomState(S)
    q = rng.randn(2, S, 4, 64).astype(np.float32)
    k = rng.randn(2, S, 2, 64).astype(np.float32)
    v = rng.randn(2, S, 2, 64).astype(np.float32)
    kw = dict(sm_scale=0.125, softcap=50.0, sliding_window=W)
    want = np.asarray(JA.blockwise_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_chunk=S,
        kv_chunk=S, **kw))
    got = TA.blockwise_causal_attention(_t(q), _t(k), _t(v), q_chunk=32,
                                        kv_chunk=64, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ring_prefill_matches_reference():
    """Ragged lengths < w, = w, > 2w (and the whole padded width): slot j
    holds the latest real position ≡ j (mod w), zeros where none."""
    rng = np.random.RandomState(0)
    S = 160
    k = rng.randn(4, S, 2, 16).astype(np.float32)
    v = rng.randn(4, S, 2, 16).astype(np.float32)
    lens = np.array([40, W, 150, S], np.int32)
    zeros = np.zeros((4, W, 2, 16), np.float32)
    want = JSV._ring_prefill((jnp.asarray(zeros),) * 2, jnp.asarray(k),
                             jnp.asarray(v), jnp.asarray(lens))
    ring = (_t(zeros) + 7.0, _t(zeros) + 7.0)       # stale contents
    TSV._ring_prefill(ring, _t(k), _t(v), _t(lens))
    for g, w in zip(ring, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (ring[0][0, 40:] == 0).all() and (ring[0][0, :40] != 0).all()
    np.testing.assert_array_equal(ring[0][2, 149 % W].numpy(), k[2, 149])


@pytest.mark.parametrize("n", [W, 48])
@pytest.mark.parametrize("arch", ["gemma2-27b", "gemma3-12b"])
def test_ring_decode_matches_reference(arch, n):
    """A ring of n = w slots at pos = w - 1, w, 2w + 3, and one of n = 48 <
    w (n_max below the window, the reference's window-masked dense branch)
    at pos = 0, 30, 47, over stale slots: the token written at pos % n,
    slots > pos masked before the ring wraps."""
    _, _, ld_j, ld_t, pj, pt = _local(arch)
    rng = np.random.RandomState(9)
    x = rng.randn(3, 256).astype(np.float32)
    kr = rng.randn(3, n, 2, 64).astype(np.float32)
    vr = rng.randn(3, n, 2, 64).astype(np.float32)
    pos = np.array([W - 1, W, 2 * W + 3] if n == W else [0, 30, n - 1],
                   np.int32)
    want, (kj, vj) = JL.attn_decode_dense(
        pj["attn"], jnp.asarray(x), (jnp.asarray(kr), jnp.asarray(vr)),
        jnp.asarray(pos), ld_j.attn)
    ring = (_t(kr), _t(vr))
    got = TL.attn_decode_dense(pt["attn"], _t(x), ring, _t(pos), ld_t.attn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for g, w, old in zip(ring, (kj, vj), (kr, vr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
        keep = np.ones((3, n), bool)
        keep[np.arange(3), pos % n] = False
        np.testing.assert_array_equal(g.numpy()[keep], old[keep])


def test_ring_fill_chunk_wrapping_the_window():
    """A chunk of P = 100 > w = 64 (90 valid, a pad tail of 10) at start
    70 of slot 1: the prefix read from the ring by position, attention in
    the window, and only each slot's last write kept."""
    cfg_j, cfg_t, ld_j, ld_t, pj, pt = _local("gemma3-12b")
    rng = np.random.RandomState(4)
    P, start, n, slot = 100, 70, 90, 1
    x = rng.randn(1, P, 256).astype(np.float32)
    kr = rng.randn(2, W, 2, 64).astype(np.float32)
    vr = rng.randn(2, W, 2, 64).astype(np.float32)
    q_pos = (start + np.arange(P, dtype=np.int32))[None]
    fj = JSV.FillCtx(slot=jnp.int32(slot), start=jnp.int32(start),
                     q_pos=jnp.asarray(q_pos),
                     valid=jnp.asarray(np.arange(P)[None] < n),
                     valid_n=jnp.int32(n))
    yj, cj = JSV._layer_fill(pj, jnp.asarray(x), ld_j, cfg_j,
                             {"kv": (jnp.asarray(kr), jnp.asarray(vr))}, fj,
                             None)
    new_pos = np.where(np.arange(P) < n, q_pos[0], -1)[None]
    ft = TSV.FillCtx(slot, start, n, _t(q_pos), _t(new_pos), None)
    ring = (_t(kr), _t(vr))
    yt = TSV._layer_fill(pt, _t(x), ld_t, cfg_t, {"kv": ring, "ring": True},
                         ft, None, True)
    # the layer's output (residual and MLP included, |y| ~ 1e3 at params
    # x8) within 1e-5 of its scale
    yj = np.asarray(yj)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5,
                               atol=1e-5 * np.abs(yj).max())
    for g, w in zip(ring, cj["kv"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # every slot of row 1 holds its last valid write; row 0 is untouched
    _, k_new, v_new = TL._project_qkv(
        pt["attn"], TL.rms_norm(_t(x), pt["norm_attn"], cfg_t.norm_eps),
        ld_t.attn, _t(q_pos))
    last = {(start + t) % W: t for t in range(n)}
    assert len(last) == W
    for s_, t in last.items():
        np.testing.assert_array_equal(ring[0][slot, s_].numpy(),
                                      k_new[0, t].numpy())
        np.testing.assert_array_equal(ring[1][slot, s_].numpy(),
                                      v_new[0, t].numpy())
    np.testing.assert_array_equal(ring[0][0].numpy(), kr[0])


def test_ring_prefix_positions_match_reference():
    """The position each ring slot holds before a chunk at ``start``
    (the reference's ``p_s``), -1 where none."""
    for start in (0, 1, 63, 64, 65, 200):
        last = start - 1
        p_s = last - (last - np.arange(W)) % W
        np.testing.assert_array_equal(
            TSV._ring_prefix_pos(start, W, "cpu")[0].numpy(),
            np.where(p_s >= 0, p_s, -1))


def test_paged_caches_keep_rings_slot_local():
    """Rings beside the pool: (batch, min(w, n_max), G, hd) k/v, every
    head on a sharded rank too, no histogram or fetch entry; a bucketed
    prefill's shorter ring lands in the slot's first slots."""
    cfg = dataclasses.replace(TC.smoke("gemma2-27b"), dtype="float32")
    caches = TSV.make_paged_caches(cfg, 2, 8, 32, "cpu", n_max=256,
                                   num_device_blocks=4)
    ring, glob = caches
    assert TSV.is_ring(ring) and not TSV.is_ring(glob)
    assert set(ring) == {"kv", "ring"}
    assert set(glob) == {"kv", "hist", "fetch"}
    assert [t.shape for t in ring["kv"]] == [(2, W, 2, 64)] * 2
    assert TSV.pool_entries(caches) == [glob]
    short = TSV.make_caches(cfg, 1, 32, "cpu")
    assert short[0]["kv"][0].shape == (1, 32, 2, 64)
    with pytest.raises(ValueError, match="n_max"):
        TSV.make_paged_caches(cfg, 2, 8, 32, "cpu")

    st = TSV.init_paged_slot_state(cfg, 2, 8, 32, device="cpu", n_max=256)
    for t in st.caches[0]["kv"]:
        t.fill_(5.0)
    for t in short[0]["kv"]:
        t.copy_(torch.randn(t.shape))
    regions = TCC.CacheRegions(torch.tensor([19], dtype=torch.int32),
                               torch.tensor([0], dtype=torch.int32))
    TSV.admit_paged(st, 1, torch.full((1,), 8, dtype=torch.int32), short,
                    regions, 3, 4, cfg.pariskv)
    for big, small in zip(st.caches[0]["kv"], short[0]["kv"]):
        np.testing.assert_array_equal(big[1, :32].numpy(), small[0].numpy())
        assert (big[1, 32:] == 5.0).all() and (big[0] == 5.0).all()


def _b32_pool(cfg_j, seed=0, nb=10, bs=32, G=2):
    """A pool of reference-encoded random keys at head_dim 256 (B = 32)."""
    D = cfg_j.head_dim
    rng = np.random.RandomState(seed)
    keys = (rng.randn(nb, G, bs, D) * np.linspace(2.0, 0.2, D)).astype(
        np.float32)
    signs = jnp.asarray(JS.rademacher_signs(D, cfg_j.pariskv.srht_seed))
    meta = JE.encode_keys(jnp.asarray(keys), cfg_j.pariskv, signs)
    kv = rng.randn(2, nb, bs, G, D).astype(np.float32)
    ids, codes, w = (np.asarray(meta.centroid_ids), np.asarray(meta.codes),
                     np.asarray(meta.weights))
    pool_j = JCC.PagedLayerKVCache(jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                                   jnp.asarray(ids), jnp.asarray(codes),
                                   jnp.asarray(w))
    pool_t = TCC.PagedLayerKVCache(_t(kv[0]), _t(kv[1]), _t(ids),
                                   _t(codes.view(np.int32)), _t(w))
    return pool_j, pool_t, rng


def test_b32_stage1_cut_count_and_stage2_match_reference():
    cfg_j, cfg_t = _cfgs("gemma3-12b", head_dim=256)
    pj_cfg, pt_cfg = cfg_j.pariskv, cfg_t.pariskv
    B, nc = pt_cfg.num_subspaces(256), pt_cfg.num_centroids()
    assert B == 32
    pool_j, pool_t, rng = _b32_pool(cfg_j)
    bt = np.array([[3, 7, 1, 9, 4], [0, 8, 6, -1, -1]], np.int32)
    enc = np.array([150, 70], np.int32)
    n = bt.shape[1] * 32
    ids = np.asarray(pool_j.meta_ids)                     # (nb, G, bs, B)
    view = np.moveaxis(ids[np.maximum(bt, 0)], 2, 1).reshape(2, 2, n, B)
    valid = ((np.arange(n)[None] >= pt_cfg.sink_size)
             & (np.arange(n)[None] < enc[:, None]))
    hist_j = np.asarray(JR.bucket_histogram(
        jnp.asarray(view), jnp.asarray(valid)[:, None], nc))
    # bucket_count (contiguous region) and bucket_count_span (per row
    # through the table) == the reference's jnp histogram
    np.testing.assert_array_equal(
        bucket_count(_t(view), _t(enc), pt_cfg.sink_size, nc).numpy(), hist_j)
    for r in range(2):
        h = torch.zeros((1, 2, B, nc), dtype=torch.int32)
        bucket_count_span(pool_t.meta_ids, _t(bt[r:r + 1]),
                          pt_cfg.sink_size, int(enc[r]), nc, h)
        np.testing.assert_array_equal(h[0].numpy(), hist_j[r])

    q = rng.randn(2, 2, 2, 256).astype(np.float32)          # Hg = 2
    signs_j = jnp.asarray(JS.rademacher_signs(256, pj_cfg.srht_seed))
    qj = JE.encode_query(jnp.asarray(q), pj_cfg, signs_j)
    qt = TE.encode_query(_t(q), pt_cfg, TSV.rotation_signs(cfg_t, "cpu"))
    C = pt_cfg.candidate_count(n)
    want = JR.retrieve_paged_fused(pool_j, jnp.asarray(bt), qj,
                                   jnp.asarray(hist_j), jnp.asarray(enc),
                                   pj_cfg, C, pj_cfg.top_k, use_kernels=True)
    got = TR.retrieve_paged_fused(pool_t, _t(bt), qt, _t(hist_j), _t(enc),
                                  pt_cfg, C, pt_cfg.top_k)
    # Stage I (the Pallas kernel, interpret mode) and the cut: identical
    np.testing.assert_array_equal(got.coarse_scores.numpy(),
                                  np.asarray(want.coarse_scores))
    assert got.coarse_scores.max() > 0
    assert got.coarse_scores.max() <= TR.max_collision_score(pt_cfg, B) == 192
    np.testing.assert_array_equal(got.cand_indices.numpy(),
                                  np.asarray(want.cand_indices))
    # seg_hist: numpy's histogram of score + 1 per segment
    sr = TR.max_collision_score(pt_cfg, B)
    _, seg_hist = TR.collision_scores_paged_hist(
        pool_t.meta_ids, _t(bt), qt.q_sub, _t(hist_j), _t(enc), pt_cfg)
    assert seg_hist.shape == (2, 2, 2, -(-n // SEG_LEN), sr + 2)
    sc = np.asarray(want.coarse_scores)
    for j in range(seg_hist.shape[3]):
        seg = sc[..., j * SEG_LEN:(j + 1) * SEG_LEN] + 1
        np.testing.assert_array_equal(
            seg_hist[..., j, :].numpy(),
            np.apply_along_axis(np.bincount, -1, seg, minlength=sr + 2))
    # Stage II with its top-k: the same winners, estimates to float32 sums
    order_t = np.argsort(got.indices.numpy(), -1)
    order_j = np.argsort(np.asarray(want.indices), -1)
    for a, b in ((got.indices, want.indices),
                 (got.phys_rows, want.phys_rows)):
        np.testing.assert_array_equal(
            np.take_along_axis(a.numpy(), order_t, -1),
            np.take_along_axis(np.asarray(b), order_j, -1))
    np.testing.assert_allclose(
        np.take_along_axis(got.scores.numpy(), order_t, -1),
        np.take_along_axis(np.asarray(want.scores), order_j, -1),
        rtol=1e-4, atol=1e-3)
