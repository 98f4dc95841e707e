"""The port's host-offloaded tier, module by module, against the JAX
reference on the same numpy inputs in float32: the tiered winner gather's
plain version (against the Pallas ``gather_kv_tiered_kernel`` in interpret
mode on staged rows, against the reference layer's hit/miss blend with its
numpy host gather, and its host reads and distinct count against the
reference's deduplicating ``_dedup_heads_gather``), the tiered cache
operations, ``StagingMap`` and
``HostKVPool``, and one tiered decode layer (fused and meta view). Integer
outputs, gathered rows and pool contents must be identical; encoded
weights (rtol 1e-5, atol 1e-6) and the layer's output (rtol 1e-4, atol
1e-4) agree to float32 reassociation."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores, and torch's
# spinning OpenMP pool would otherwise slow each of them many times over
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import cache as JCC  # noqa: E402
from repro.core import encode as JE  # noqa: E402
from repro.core import retrieval as JR  # noqa: E402
from repro.core import srht as JS  # noqa: E402
from repro.core.config import ParisKVConfig as JP  # noqa: E402
from repro.kernels.gather_kv.ops import gather_kv_tiered_kernel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serving import offload as JO  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch.core import cache as TCC  # noqa: E402
from repro_torch.core import retrieval as TR  # noqa: E402
from repro_torch.core.config import ParisKVConfig as TP  # noqa: E402
from repro_torch.kernels.gather_kv import gather_heads_tiered  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serving import offload as TO  # noqa: E402

CFG_J = JP(sink_size=8, local_size=32, update_interval=16, top_k=16,
           min_candidates=32)
CFG_T = TP(sink_size=8, local_size=32, update_interval=16, top_k=16,
           min_candidates=32)
NB, ND, BS, G, HG, D = 24, 10, 16, 2, 2, 64
NBLK = 8                                   # n_max = 128 logical positions
B = CFG_J.num_subspaces(D)


def _t(a):
    return torch.from_numpy(np.array(a))           # writable copy


def _tier(seed):
    """Host K/V pool (NB, BS, G, D), block tables with -1 tails, a dev_map
    staging ND of the NB blocks (some allocated blocks unstaged), and a
    staging pool holding the staged blocks' host rows."""
    rng = np.random.RandomState(seed)
    host = rng.randn(2, NB, BS, G, D).astype(np.float32)
    bt = np.full((2, NBLK), -1, np.int32)
    perm = rng.permutation(NB).astype(np.int32)
    bt[0, :8], bt[1, :5] = perm[:8], perm[8:13]
    dev_map = np.full((NB,), -1, np.int32)
    staged = rng.choice(perm[:13], size=ND, replace=False)
    dev_map[staged] = rng.permutation(ND)
    staging = np.zeros((2, ND, BS, G, D), np.float32)
    staging[:, dev_map[staged]] = host[:, staged]
    return host, bt, dev_map, staging, rng


def test_tiered_gather_plain_matches_pallas_kernel_on_staged_rows():
    """On staged winners the plain tiered gather computes exactly the
    reference's ``gather_kv_tiered_kernel`` (dev_map-composed paged Pallas
    gather, interpret mode); missed rows come from the host pool and rows
    through -1 table entries are zero."""
    host, bt, dev_map, staging, rng = _tier(0)
    lidx = rng.randint(0, NBLK * BS, size=(2, 40)).astype(np.int32)
    lidx[1, :4] = [100, 127, 90, 80]                 # through -1 entries
    want = np.asarray(gather_kv_tiered_kernel(
        jnp.asarray(staging[0].reshape(ND, BS, G * D)), jnp.asarray(bt),
        jnp.asarray(dev_map), jnp.asarray(lidx))).reshape(2, 40, G, D)
    hb = bt[np.arange(2)[:, None], lidx // BS]
    phys = np.where(hb >= 0, hb * BS + lidx % BS, -1).astype(np.int32)
    rows = np.broadcast_to(phys[:, None, None], (2, G, 1, 40)).copy()
    k, v = gather_heads_tiered(_t(staging[0]), _t(staging[1]),
                               _t(host[0].reshape(-1, G, D)),
                               _t(host[1].reshape(-1, G, D)), _t(dev_map),
                               _t(rows))
    got = k.numpy()[:, :, 0].transpose(0, 2, 1, 3)    # (2, 40, G, D)
    staged = (hb >= 0) & (dev_map[np.maximum(hb, 0)] >= 0)
    missed = (hb >= 0) & ~staged
    assert staged.sum() > 10 and missed.sum() > 10 and (hb < 0).any()
    np.testing.assert_array_equal(got[staged], want[staged])
    flat = host.reshape(2, NB * BS, G, D)
    np.testing.assert_array_equal(got[missed], flat[0][phys[missed]])
    np.testing.assert_array_equal(
        v.numpy()[:, :, 0].transpose(0, 2, 1, 3)[missed],
        flat[1][phys[missed]])
    assert not got[hb < 0].any()


def test_tiered_gather_plain_matches_reference_blend():
    """The reference layer's blend, reproduced from its own pieces
    (``tiered_winner_rows``, ``gather_heads_physical`` on staging, the
    numpy host gather of the misses, ``where(resident, hit, miss)``),
    equals the plain tiered gather fed ``where(valid | resident, phys,
    -1)`` — valid and invalid winners, staged and unstaged blocks."""
    host, _, dev_map, staging, rng = _tier(1)
    phys = rng.randint(0, NB * BS, size=(2, G, HG, 30)).astype(np.int32)
    valid = rng.rand(2, G, HG, 30) < 0.7
    resident, stag_rows = JR.tiered_winner_rows(jnp.asarray(phys),
                                                jnp.asarray(dev_map), BS)
    resident = np.asarray(resident)
    miss_rows = np.where(valid & ~resident, phys, -1)
    flat = host.reshape(2, NB * BS, G, D)
    k_miss = np.zeros((2, G, HG, 30, D), np.float32)
    v_miss = np.zeros_like(k_miss)
    JO._dedup_heads_gather(flat[0], flat[1], miss_rows, k_miss, v_miss)
    want = [np.where(resident[..., None],
                     np.asarray(JCC.gather_heads_physical(
                         jnp.asarray(staging[i]), stag_rows)), miss)
            for i, miss in ((0, k_miss), (1, v_miss))]
    rows = np.where(valid | resident, phys, -1).astype(np.int32)
    got = gather_heads_tiered(_t(staging[0]), _t(staging[1]), _t(flat[0]),
                              _t(flat[1]), _t(dev_map), _t(rows))
    assert resident.any() and (~resident & valid).any()
    assert (~resident & ~valid).any() and (resident & ~valid).any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_dedup_tiered_gather_plain_matches_reference_dedup():
    """The plain deduplicating gather on constructed duplicates (query
    heads of one kv head picking the same rows, -1 rows, repeats across
    query heads and winners): with nothing staged its output and distinct
    count equal ``_dedup_heads_gather``'s; with a staging pool its output
    equals the undeduplicated blend and its count the distinct missed
    (row, head) pairs. The wrapper adds that count to ``count``."""
    from repro_torch.kernels.gather_kv.ref import (
        gather_heads_tiered_dedup_ref, gather_heads_tiered_ref)
    host, _, dev_map, staging, rng = _tier(4)
    flat = host.reshape(2, NB * BS, G, D)
    pick = rng.randint(0, NB * BS, size=(2, G, 12))
    rows = pick[..., rng.randint(0, 12, size=(HG, 30))].astype(np.int32)
    rows[:, :, 0, :5] = -1
    rows[0, 1, 1, :] = rows[0, 1, 0, :]                # a whole head repeated
    none_staged = np.full((NB,), -1, np.int32)
    want_k = np.zeros((2, G, HG, 30, D), np.float32)
    want_v = np.zeros_like(want_k)
    req, uniq = JO._dedup_heads_gather(flat[0], flat[1], rows, want_k,
                                       want_v)
    k, v, distinct = gather_heads_tiered_dedup_ref(
        _t(staging[0]), _t(staging[1]), _t(flat[0]), _t(flat[1]),
        _t(none_staged), _t(rows))
    assert distinct == uniq and uniq < req
    np.testing.assert_array_equal(k.numpy(), want_k)
    np.testing.assert_array_equal(v.numpy(), want_v)

    count = torch.zeros((2,), dtype=torch.int64)
    got = gather_heads_tiered(_t(staging[0]), _t(staging[1]), _t(flat[0]),
                              _t(flat[1]), _t(dev_map), _t(rows), count[1:])
    blend = [gather_heads_tiered_ref(_t(staging[i]), _t(flat[i]),
                                     _t(dev_map), _t(rows)) for i in (0, 1)]
    for g, w in zip(got, blend):
        assert torch.equal(g, w)
    missed = (rows >= 0) & (dev_map[np.maximum(rows, 0) // BS] < 0)
    keys = (rows * G + np.arange(G)[None, :, None, None])[missed]
    assert 0 < len(np.unique(keys)) < missed.sum()
    assert count.tolist() == [0, len(np.unique(keys))]


def test_tiered_table_and_winner_maps_match_reference():
    _, bt, dev_map, _, rng = _tier(2)
    np.testing.assert_array_equal(
        TCC.tiered_kv_tables(_t(bt), _t(dev_map)).numpy(),
        np.asarray(JCC.tiered_kv_tables(jnp.asarray(bt),
                                        jnp.asarray(dev_map))))
    phys = rng.randint(0, NB * BS, size=(2, G, HG, 17)).astype(np.int32)
    res_j, rows_j = JR.tiered_winner_rows(jnp.asarray(phys),
                                          jnp.asarray(dev_map), BS)
    res_t, rows_t = TR.tiered_winner_rows(_t(phys), _t(dev_map), BS)
    np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))
    np.testing.assert_array_equal(rows_t.numpy()[res_t.numpy()],
                                  np.asarray(rows_j)[np.asarray(res_j)])


def _pools(seed):
    """A tiered pool in both layouts: the port's per-layer leaves and the
    reference's stacked ones (leading stage-repeat axis of 1)."""
    rng = np.random.RandomState(seed)
    k = rng.randn(2, ND, BS, G, D).astype(np.float32)
    ids = rng.randint(0, 256, size=(NB, G, BS, B)).astype(np.uint8)
    codes = rng.randint(0, 2 ** 32, size=(NB, G, BS, B),
                        dtype=np.uint64).astype(np.uint32)
    w = rng.rand(NB, G, BS, B).astype(np.float32)
    pool_t = TCC.PagedLayerKVCache(_t(k[0]), _t(k[1]), _t(ids),
                                   _t(codes.view(np.int32)), _t(w))
    pool_j = JCC.PagedLayerKVCache(*(jnp.asarray(a)[None] for a in
                                     (k[0], k[1], ids, codes, w)))
    return pool_t, pool_j, rng


def _same(pool_t, pool_j):
    for t, j in zip(pool_t, pool_j):
        j = np.asarray(j)[0]
        np.testing.assert_array_equal(
            t.numpy(), j.view(np.int32) if j.dtype == np.uint32 else j)


def test_tiered_pool_writes_match_reference():
    """Metadata-only prefill scatter (with pad sentinels), staging
    installs (with pad slots) and eviction hygiene over two id spaces."""
    pool_t, pool_j, rng = _pools(3)
    n = 4 * BS
    meta1 = (rng.randint(0, 256, size=(1, G, n, B)).astype(np.uint8),
             rng.randint(0, 2 ** 31, size=(1, G, n, B)).astype(np.uint32),
             rng.rand(1, G, n, B).astype(np.float32))
    kv1 = np.zeros((1, n, G, D), np.float32)
    phys = np.array([5, 17, NB, 2], np.int32)               # NB: a pad
    c1_t = TCC.LayerKVCache(_t(kv1), _t(kv1), _t(meta1[0]),
                            _t(meta1[1].view(np.int32)), _t(meta1[2]))
    c1_j = JCC.LayerKVCache(*(jnp.asarray(a)[None] for a in
                              (kv1, kv1) + meta1))
    TCC.tiered_scatter_prefill_meta(pool_t, c1_t, _t(phys))
    pool_j = JCC.tiered_scatter_prefill_meta(pool_j, c1_j, jnp.asarray(phys))
    _same(pool_t, pool_j)

    stag = np.array([3, ND, 7], np.int32)                  # ND: a pad slot
    pay = rng.randn(2, 3, BS, G, D).astype(np.float32)
    TCC.tiered_stage_blocks(pool_t, _t(stag), _t(pay[0]), _t(pay[1]))
    pool_j = JCC.tiered_stage_blocks(pool_j, jnp.asarray(stag),
                                     jnp.asarray(pay[0])[None],
                                     jnp.asarray(pay[1])[None])
    _same(pool_t, pool_j)

    meta_blk, stag_blk = np.array([17, 2, NB], np.int32), np.array(
        [7, ND, 0], np.int32)
    TCC.tiered_clear_blocks(pool_t, _t(meta_blk), _t(stag_blk))
    pool_j = JCC.tiered_clear_blocks(pool_j, jnp.asarray(meta_blk),
                                     jnp.asarray(stag_blk))
    _same(pool_t, pool_j)
    assert not pool_t.k[7].any() and not pool_t.meta_w[17].any()
    assert pool_t.k[3].any() and pool_t.meta_w[5].any()


def test_promotion_gathers_keys_through_staging_tables():
    """``paged_promote_rows_hist(kv_tables=…)`` reads the promoted keys
    from staging through the composed tables and scatters metadata and
    histogram counts through the host tables, as the reference does."""
    host, bt, _, _, rng = _tier(4)
    pool_t, pool_j, _ = _pools(5)
    # the promoted spans [40, 56) and [33, 49) lie in blocks 2 and 3; the
    # engine pins them staged (they are in the local window)
    starts = np.array([40, 33], np.int32)
    dev_map = np.full((NB,), -1, np.int32)
    span = [int(b) for b in bt[:, 2:4].ravel()] + [int(bt[0, 0])]
    dev_map[span] = rng.permutation(ND)[:len(span)]
    staging = np.zeros((2, ND, BS, G, D), np.float32)
    staging[:, dev_map[span]] = host[:, span]
    kvt = np.asarray(JCC.tiered_kv_tables(jnp.asarray(bt),
                                          jnp.asarray(dev_map)))
    pool_t = pool_t._replace(k=_t(staging[0]))
    pool_j = pool_j._replace(k=jnp.asarray(staging[0]))
    pool_j = JCC.PagedLayerKVCache(*(a[0] if a.ndim == 5 and a.shape[0] == 1
                                     else a for a in pool_j))
    hist = rng.randint(0, 5, size=(2, G, B, 256)).astype(np.int32)
    mask = np.array([True, True])
    signs = JS.rademacher_signs(CFG_J.padded_dim(D), CFG_J.srht_seed)
    got_pool, got_hist = TCC.paged_promote_rows_hist(
        pool_t, _t(hist), _t(bt), _t(starts), _t(mask), CFG_T, _t(signs),
        kv_tables=_t(kvt))
    want_pool, want_hist = JCC.paged_promote_rows_hist(
        pool_j, jnp.asarray(hist), jnp.asarray(bt), jnp.asarray(starts),
        jnp.asarray(mask), CFG_J, jnp.asarray(signs),
        kv_tables=jnp.asarray(kvt))
    np.testing.assert_array_equal(got_hist.numpy(), np.asarray(want_hist))
    np.testing.assert_array_equal(got_pool.meta_ids.numpy(),
                                  np.asarray(want_pool.meta_ids))
    np.testing.assert_array_equal(
        got_pool.meta_codes.numpy(),
        np.asarray(want_pool.meta_codes).view(np.int32))
    # the weights are float32 norms: summation order differs
    np.testing.assert_allclose(got_pool.meta_w.numpy(),
                               np.asarray(want_pool.meta_w), rtol=1e-5,
                               atol=1e-6)
    assert not np.array_equal(got_hist.numpy(), hist)


def test_staging_map_matches_reference():
    """The same pin/acquire/install/touch/release sequence gives the
    reference's dev_map, owner, free list and returned slots."""
    maps = (JO.StagingMap(NB, 6), TO.StagingMap(NB, 6))
    rng = np.random.RandomState(6)
    outs = ([], [])
    for step in range(60):
        op, hb, n = int(rng.randint(6)), int(rng.randint(NB)), \
            int(rng.randint(1, 4))
        touch = rng.randint(NB, size=3)
        for sm, out in zip(maps, outs):
            if op <= 1 and not sm.resident(hb):
                got = sm.acquire()
                out.append(got)
                if got is not None:
                    sm.install(hb, got[0])
            elif op == 2 and sm.resident(hb):
                sm.pin(hb)
            elif op == 3:
                got = sm.acquire_batch(n)
                out.append(got)
                fresh = [b for b in range(NB) if not sm.resident(b)]
                for b, (s, _) in zip(fresh[hb:], got):
                    sm.install(b, s)
            elif op == 4:
                sm.touch(touch)
            else:
                out.append(sm.release_host_blocks([hb, (hb + 1) % NB]))
            if step % 9 == 8:
                sm.unpin_all()
    assert outs[0] == outs[1]
    for name in ("dev_map", "owner", "pinned", "ref"):
        np.testing.assert_array_equal(getattr(maps[1], name),
                                      getattr(maps[0], name))
    assert list(maps[1].free) == list(maps[0].free)
    assert maps[1].resident_count() == maps[0].resident_count() > 0


def test_host_pool_matches_reference():
    """write_prefill (pad sentinels skipped), writeback, read_blocks and
    zero_blocks leave the reference's bytes; a negative block raises
    HostIndexError before any write."""
    rng = np.random.RandomState(7)
    ref = JO.HostKVPool({"e": (1, G, D)}, NB, BS, np.float32)
    pool = TO.HostKVPool({"e": (G, D)}, NB, BS, torch.float32)
    rows = rng.randn(2, 4 * BS, G, D).astype(np.float32)
    phys = np.array([3, NB + 2, 9, 0], np.int32)
    ref.write_prefill("e", phys, rows[0][None], rows[1][None])
    pool.write_prefill("e", phys, _t(rows[0]), _t(rows[1]))
    blocks = rng.randn(2, 2, BS, G, D).astype(np.float32)
    ref.writeback("e", np.array([5, 9]), blocks[0][None], blocks[1][None])
    pool.writeback("e", np.array([5, 9]), _t(blocks[0]), _t(blocks[1]))
    for got, want in zip(pool.read_blocks("e", np.array([0, 5, 9, 3])),
                         ref.read_blocks("e", np.array([0, 5, 9, 3]))):
        np.testing.assert_array_equal(got.numpy(), want[0])
    ref.zero_blocks(np.array([9]))
    pool.zero_blocks(np.array([9]))
    np.testing.assert_array_equal(pool.k["e"].numpy(), ref.k["e"][0])
    np.testing.assert_array_equal(pool.v["e"].numpy(), ref.v["e"][0])
    kf, _ = pool.flat("e")
    assert kf.shape == (NB * BS, G, D) and kf.data_ptr() == \
        pool.k["e"].data_ptr()
    assert pool.bytes_per_head_row("e") == ref.bytes_per_head_row("e")
    assert pool.bytes_per_row("e") == ref.bytes_per_row("e")
    assert pool.held_bytes == pool.nbytes == 2 * NB * BS * G * D * 4
    assert TO.pinned_bytes_held(33 << 20) == 64 << 20
    assert TO.pinned_bytes_held(32 << 20) == 32 << 20
    before = pool.k["e"].clone()
    for bad in (lambda: pool.write_prefill("e", np.array([1, -2]),
                                           _t(rows[0][:2 * BS]),
                                           _t(rows[1][:2 * BS])),
                lambda: pool.writeback("e", np.array([NB]), _t(blocks[0][:1]),
                                       _t(blocks[1][:1])),
                lambda: pool.read_blocks("e", np.array([-1]))):
        with pytest.raises(TO.HostIndexError, match="out of range"):
            bad()
    assert torch.equal(pool.k["e"], before)


@pytest.mark.parametrize("fused", [True, False])
def test_tiered_decode_layer_matches_reference(fused):
    """One tiered ParisKV decode layer (append through the composed
    tables, Stage I/II over the host tables, the hit/miss winner blend,
    sink/window from staging) on both sides: the layer output within
    float32 reassociation, the appended staging pool, and the fetch
    statistics ``touched``/``rows`` exactly."""
    rng = np.random.RandomState(8)
    H, d_model = G * HG, 64
    spec_j = JL.AttnSpec(num_heads=H, num_kv_heads=G, head_dim=D,
                         rope_theta=1e6, qkv_bias=True)
    spec_t = TL.AttnSpec(num_heads=H, num_kv_heads=G, head_dim=D,
                         rope_theta=1e6, qkv_bias=True)
    p = {n: (rng.randn(*s) * 0.3).astype(np.float32) for n, s in (
        ("wq", (d_model, H * D)), ("wk", (d_model, G * D)),
        ("wv", (d_model, G * D)), ("wo", (H * D, d_model)),
        ("bq", (H * D,)), ("bk", (G * D,)), ("bv", (G * D,)))}
    x = rng.randn(2, d_model).astype(np.float32)
    host = rng.randn(2, NB, BS, G, D).astype(np.float32)
    bt = np.full((2, NBLK), -1, np.int32)
    perm = rng.permutation(NB).astype(np.int32)
    bt[0, :7], bt[1, :6] = perm[:7], perm[7:13]
    pos = np.array([100, 90], np.int32)          # last token per row
    enc = np.array([60, 54], np.int32)
    # staged, as the engine pins them: the sink block and each row's
    # window + append blocks (window 48: [54, 101] and [44, 91]); blocks 1
    # (and 2 of row 0) of the retrieval regions stay on the host
    dev_map = np.full((NB,), -1, np.int32)
    stage = [int(b) for b in (bt[0, 0], *bt[0, 3:7], bt[1, 0], *bt[1, 2:6])]
    assert len(stage) == ND
    dev_map[stage] = rng.permutation(ND)
    staging = np.zeros((2, ND, BS, G, D), np.float32)
    staging[:, dev_map[stage]] = host[:, stage]
    keys = host[0].transpose(0, 2, 1, 3)                       # (NB,G,BS,D)
    signs = JS.rademacher_signs(CFG_J.padded_dim(D), CFG_J.srht_seed)
    meta = JE.encode_keys(jnp.asarray(keys), CFG_J, jnp.asarray(signs))
    ids, codes, w = (np.asarray(a) for a in meta)
    pool_t = TCC.PagedLayerKVCache(_t(staging[0]), _t(staging[1]), _t(ids),
                                   _t(codes.view(np.int32)), _t(w))
    regions_t = TCC.CacheRegions(_t(pos), _t(enc))
    hist = TCC.bucket_hist_from_meta(TCC.paged_ids_view(pool_t, _t(bt)),
                                     regions_t, CFG_T)
    n_cand = CFG_J.candidate_count(NBLK * BS)

    ref_host = JO.HostKVPool({"e": (1, G, D)}, NB, BS, np.float32)
    ref_host.k["e"][0], ref_host.v["e"][0] = host[0], host[1]
    pool_j = JCC.PagedLayerKVCache(*(jnp.asarray(a) for a in (
        staging[0], staging[1], ids, codes, w)))
    y_j, pool_j, st_j = JL.attn_decode_pariskv_tiered(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), pool_j,
        jnp.asarray(hist.numpy()), jnp.asarray(bt), jnp.asarray(dev_map),
        ref_host.entry("e"), jnp.int32(0),
        JCC.CacheRegions(jnp.asarray(pos), jnp.asarray(enc)), spec_j,
        CFG_J, jnp.asarray(signs), n_cand, fused=fused)

    flat = host.reshape(2, NB * BS, G, D)
    kvt = TCC.tiered_kv_tables(_t(bt), _t(dev_map))
    y_t, res, st_t = TL.attn_decode_pariskv_tiered(
        {k: _t(v) for k, v in p.items()}, _t(x), pool_t, hist, _t(bt), kvt,
        _t(dev_map), _t(flat[0]), _t(flat[1]), regions_t, spec_t, CFG_T,
        _t(signs), n_cand, fused=fused)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)
    # the appended key went through float32 projections and rope
    np.testing.assert_allclose(pool_t.k.numpy(), np.asarray(pool_j.k),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(st_t["touched"].numpy(),
                                  np.asarray(st_j["touched"]))
    np.testing.assert_array_equal(st_t["rows"].numpy(),
                                  np.asarray(st_j["rows"]))
    rows = st_t["rows"].numpy()
    assert st_t["calls"] == 1
    assert (rows[:, 1] > 0).all() and (rows[:, 2] > 0).all()


def test_tiered_wrapper_never_falls_back_off_the_cpu():
    """A staging pool that is not on the CPU gets the kernel or an
    exception (meta tensors stand in for a card here)."""
    before = dict(TK.LAUNCHES)
    m = dict(device="meta")
    stag = torch.empty((ND, BS, G, D), **m)
    host = torch.empty((NB * BS, G, D))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        gather_heads_tiered(stag, stag, host, host,
                            torch.empty((NB,), dtype=torch.int32, **m),
                            torch.empty((2, G, HG, 5), dtype=torch.int32,
                                        **m))
    assert TK.LAUNCHES == before
