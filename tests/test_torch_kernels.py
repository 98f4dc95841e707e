"""The port's kernel modules against the JAX reference's kernels.

On the CPU every wrapper takes its plain PyTorch version (``ref.py``); the
JAX side runs its Pallas kernels as its own tests do here (interpret mode)
or, for the serving-path twins, the jnp functions. Same numpy inputs, small
shapes with ragged n, ties, -1 scores and -1 block-table entries. Integer
outputs and gathered rows must be identical; Stage-II estimates agree to
float32 reassociation (rtol 1e-5, atol 1e-5).

``tests/test_torch_cuda.py`` compares each CUDA kernel with its plain
version on the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores, and torch's
# spinning OpenMP pool would otherwise slow each of them many times over
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.core import cache as JCC  # noqa: E402
from repro.core import encode as JE  # noqa: E402
from repro.core import retrieval as JR  # noqa: E402
from repro.core import srht as JS  # noqa: E402
from repro.core.config import ParisKVConfig as JP  # noqa: E402
from repro.kernels.bucket_topk.ops import bucket_topk as j_bucket_topk  # noqa: E402
from repro.kernels.collision import collision_scores_kernel as j_coll_flat  # noqa: E402
from repro.kernels.collision import collision_scores_paged_kernel as j_coll  # noqa: E402
from repro.kernels.gather_kv.ops import gather_kv_kernel as j_gather  # noqa: E402
from repro.kernels.gather_kv.ops import gather_kv_paged_kernel  # noqa: E402
from repro.kernels.rerank import rerank_paged_kernel as j_rerank  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch.core import retrieval as TR  # noqa: E402
from repro_torch.core.config import ParisKVConfig as TP  # noqa: E402
from repro_torch.kernels.bucket_topk import bucket_topk  # noqa: E402
from repro_torch.kernels.collision import (bucket_count,  # noqa: E402
                                           collision_scores_kernel,
                                           collision_scores_paged_kernel)
from repro_torch.kernels.gather_kv import (gather_decode_paged,  # noqa: E402
                                           gather_kv_kernel,
                                           gather_rows_paged)
from repro_torch.kernels.rerank import rerank_topk_paged  # noqa: E402
from repro_torch.kernels.rerank.ref import rerank_paged_ref  # noqa: E402

CFG_J = JP(sink_size=16, local_size=64, update_interval=32, top_k=32,
           min_candidates=64)
CFG_T = TP(sink_size=16, local_size=64, update_interval=32, top_k=32,
           min_candidates=64)
D, G, HG = 64, 2, 2
B = CFG_J.num_subspaces(D)


def _pool(seed, nb=12, bs=32):
    """Random pool metadata encoded from random keys, plus K/V rows."""
    rng = np.random.RandomState(seed)
    keys = rng.randn(nb, G, bs, D).astype(np.float32)
    signs = jnp.asarray(JS.rademacher_signs(D, CFG_J.srht_seed))
    meta = JE.encode_keys(jnp.asarray(keys), CFG_J, signs)
    kv = rng.randn(2, nb, bs, G, D).astype(np.float32)
    return (np.asarray(meta.centroid_ids), np.asarray(meta.codes),
            np.asarray(meta.weights), kv, rng)


def _t(a):
    return torch.from_numpy(np.array(a))           # writable copy


def test_collision_plain_matches_pallas_kernel():
    ids, _, _, _, rng = _pool(0)
    bt = np.array([[7, 2, 9, -1], [0, 11, -1, -1]], np.int32)
    enc_end = np.array([110, 50], np.int32)          # ragged valid regions
    tables = rng.randint(0, 7, size=(2, G, HG, B, 256)).astype(np.int32)
    want = np.asarray(j_coll(jnp.asarray(ids), jnp.asarray(bt),
                             jnp.asarray(tables), jnp.asarray(enc_end),
                             CFG_J.sink_size))
    got = collision_scores_paged_kernel(
        _t(ids), _t(bt), _t(tables), _t(enc_end), CFG_T.sink_size,
        TR.max_collision_score(CFG_T, B))[0]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).any() and (want > 0).any()


@pytest.mark.parametrize("n", [1000, 1024, 4096])
@pytest.mark.parametrize("ids_dtype", [np.uint8, np.int32])
def test_contiguous_collision_plain_matches_pallas_kernel(n, ids_dtype):
    """The contiguous Stage-I route (the paged kernel over the store's
    one-block-per-row table; plain on the CPU) == the reference's
    ``collision_scores_kernel`` (the Pallas ``_collision_pallas`` in
    interpret mode, which pads n to its block) over lead dims (2, 3) when
    the region is the whole store, and equals it inside [sink, enc_end)
    and -1 outside when masked."""
    rng = np.random.RandomState(n)
    ids = rng.randint(0, 256, size=(2, 3, n, B)).astype(ids_dtype)
    tables = rng.randint(0, 7, size=(2, 3, B, 256)).astype(np.int32)
    want = np.asarray(j_coll_flat(jnp.asarray(ids), jnp.asarray(tables)))
    sr = TR.max_collision_score(CFG_T, B)
    got, _ = collision_scores_kernel(_t(ids), _t(tables[:, :, None]),
                                     _t(np.full(2, n, np.int32)), 0, sr)
    assert got.dtype == torch.int32 and got.shape == (2, 3, 1, n)
    np.testing.assert_array_equal(got[:, :, 0].numpy(), want)

    enc_end = np.array([n - 7, 40], np.int32)
    heads = np.stack([tables, tables[:, ::-1]], 2)            # (2, 3, 2, ..)
    masked, _ = collision_scores_kernel(_t(ids.astype(np.uint8)), _t(heads),
                                        _t(enc_end), 16, sr)
    masked = masked.numpy()
    assert masked.shape == (2, 3, 2, n)
    for i, e in enumerate(enc_end):
        np.testing.assert_array_equal(masked[i, :, 0, 16:e], want[i, :, 16:e])
        assert (masked[i, :, :, :16] == -1).all()
        assert (masked[i, :, :, e:] == -1).all()
    np.testing.assert_array_equal(masked[:, 1:2, 1, 16:40],
                                  want[:, 1:2, 16:40])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contiguous_gather_plain_matches_pallas_kernel(dtype):
    """gather_kv_kernel (the paged gather's logical mode over one block per
    store; plain on the CPU) == the reference's ``gather_kv_kernel`` (the
    Pallas ``_gather_rows_pallas``, interpret mode) with duplicate indices
    and an index broadcast over lead dims; the contiguous decode gather
    (sink, window and winners through the one-block-per-row table) equals
    the reference's jnp gathers: ``gather_kv_heads`` for the winners, the
    sink slice and ``dynamic_slice`` for the window, whose start past
    n - W clamps."""
    rng = np.random.RandomState(5)
    store = rng.randn(2, 3, 50, 64).astype(np.float32)
    idx = rng.randint(0, 50, size=(2, 3, 17)).astype(np.int32)
    idx[:, :, :4] = 7                                    # duplicates
    js = jnp.asarray(store).astype(dtype)
    ts = _t(store).to(getattr(torch, dtype))
    for ix in (idx, idx[:1, :1]):
        want = np.asarray(j_gather(js, jnp.asarray(ix)), np.float32)
        got = gather_kv_kernel(ts, _t(ix))
        assert got.dtype == ts.dtype
        np.testing.assert_array_equal(got.float().numpy(), want)

    from repro.core.attention import gather_kv_heads as j_heads
    n, sink, W = 40, 3, 11
    cache = rng.randn(2, n, G, D).astype(np.float32)
    hidx = rng.randint(0, n, size=(2, G, HG, 9)).astype(np.int32)
    phys = hidx + n * np.arange(2, dtype=np.int32)[:, None, None, None]
    ws = np.array([5, 33], np.int32)                     # 33 > n - W
    dk, dv, wk, wv = gather_decode_paged(
        _t(cache), _t(cache * 2), TK.row_tables(2, "cpu"),
        _t(np.minimum(ws, n - W)), sink, W, _t(phys))
    want = np.asarray(j_heads(jnp.asarray(cache), jnp.asarray(hidx)))
    np.testing.assert_array_equal(wk.numpy(), want)
    np.testing.assert_array_equal(wv.numpy(), 2 * want)
    for i in range(2):
        rows = np.concatenate([cache[i, :sink], np.asarray(
            lax.dynamic_slice_in_dim(jnp.asarray(cache[i]), ws[i], W))])
        np.testing.assert_array_equal(dk[i].numpy(), rows)
        np.testing.assert_array_equal(dv[i].numpy(), 2 * rows)


def test_collision_scores_paged_matches_jnp_twin():
    """Stage I end to end (centroid scores → tier table → kernel) equals
    the reference's serving twin on the same query and histogram."""
    ids, _, _, _, rng = _pool(1)
    bt = np.array([[3, 5, 1, 8], [4, 10, 6, -1]], np.int32)
    enc_end = np.array([128, 70], np.int32)
    q_sub = rng.randn(2, G, HG, B, 8).astype(np.float32)
    view = np.moveaxis(ids[np.maximum(bt, 0)], 2, 1).reshape(2, G, 128, B)
    valid = ((np.arange(128)[None] >= CFG_J.sink_size)
             & (np.arange(128)[None] < enc_end[:, None]))
    hist = np.asarray(JR.bucket_histogram(view, jnp.asarray(valid)[:, None],
                                          256))
    want = np.asarray(JR.collision_scores_paged(
        jnp.asarray(ids), jnp.asarray(bt), jnp.asarray(q_sub),
        jnp.asarray(hist), jnp.asarray(enc_end), CFG_J))
    got = TR.collision_scores_paged(_t(ids), _t(bt), _t(q_sub), _t(hist),
                                    _t(enc_end), CFG_T)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [100, 1000, 1025])
def test_bucket_topk_plain_matches_pallas_kernel(n):
    rng = np.random.RandomState(n)
    scores = rng.randint(-1, 20, size=(3, n)).astype(np.int32)  # many ties
    scores[1, : n // 2] = -1
    k = min(64, n)
    want = np.asarray(j_bucket_topk(jnp.asarray(scores), k,
                                    score_range=21, block_n=256))
    got = bucket_topk(_t(scores), k, 20)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["ragged", "all_ties", "mostly_invalid"])
def test_select_candidates_bucket_matches_reference(case):
    rng = np.random.RandomState(5)
    scores = rng.randint(-1, 97, size=(2, G, HG, 333)).astype(np.int32)
    if case == "all_ties":
        scores[:] = 7
    elif case == "mostly_invalid":
        scores[..., 40:] = -1
    C = 100
    want = np.asarray(JR.select_candidates_bucket(jnp.asarray(scores), C, 96))
    got = TR.select_candidates_bucket(_t(scores), C, 96)
    np.testing.assert_array_equal(got.numpy(), want)
    # lax.top_k's index set, ascending
    top = np.sort(np.asarray(JR.select_candidates(jnp.asarray(scores), C)),
                  -1)
    np.testing.assert_array_equal(got.numpy(), top)
    with pytest.raises(ValueError):
        bucket_topk(_t(scores), 334, 96)


def test_rerank_plain_matches_pallas_kernel_and_twin():
    _, codes, w, _, rng = _pool(2)
    nb, _, bs, _ = codes.shape
    C = 40
    phys = rng.choice(nb * bs, size=(1, G, HG, C), replace=False
                      ).astype(np.int32)
    cand = rng.randint(0, 200, size=(1, G, HG, C)).astype(np.int32)
    cand[..., :5] = 3                                 # below the sink
    enc_end = np.array([150], np.int32)
    q_sub = rng.randn(1, G, HG, B, 8).astype(np.float32)
    q_norm = np.abs(rng.randn(1, G, HG)).astype(np.float32) + 0.5
    got = rerank_paged_ref(_t(codes.view(np.int32)), _t(w), _t(phys),
                           _t(cand), _t(q_sub), _t(q_norm), _t(enc_end),
                           CFG_T.sink_size, 8, 3)
    # the Pallas kernel per (b, h) row; it applies no validity mask
    for h in range(HG):
        want = np.asarray(j_rerank(jnp.asarray(codes), jnp.asarray(w),
                                   jnp.asarray(phys[0, :, h]),
                                   jnp.asarray(q_sub[0, :, h]),
                                   jnp.asarray(q_norm[0, :, h]), m=8,
                                   block_c=32))
        valid = (cand[0, :, h] >= 16) & (cand[0, :, h] < 150)
        np.testing.assert_allclose(got.numpy()[0, :, h][valid], want[valid],
                                   rtol=1e-5, atol=1e-5)
    # the serving twin masks invalid candidates to the finite -1e30
    qt = JE.QueryTransform(jnp.asarray(q_norm), jnp.asarray(q_sub))
    twin = np.asarray(JR.rerank_paged(jnp.asarray(codes), jnp.asarray(w),
                                      jnp.asarray(phys), jnp.asarray(cand),
                                      qt, jnp.asarray(enc_end), CFG_J))
    np.testing.assert_allclose(got.numpy(), twin, rtol=1e-5, atol=1e-5)
    assert (got.numpy() == -1e30).sum() >= 5


def test_gather_plain_matches_pallas_kernel_and_twins():
    _, _, _, kv, rng = _pool(3)
    pool_k, pool_v = kv
    nb, bs = pool_k.shape[:2]
    bt = np.array([[5, 1, 10, 3], [2, 8, -1, -1]], np.int32)
    lidx = np.stack([rng.randint(0, 128, 20), rng.randint(0, 64, 20)]
                    ).astype(np.int32)
    lidx[1, :3] = [100, 127, 64]                     # through -1 entries
    gk, gv = gather_rows_paged(_t(pool_k), _t(pool_v), _t(bt), _t(lidx))
    twin = np.asarray(JCC.paged_gather_rows(jnp.asarray(pool_k),
                                            jnp.asarray(bt),
                                            jnp.asarray(lidx)))
    np.testing.assert_array_equal(gk.numpy(), twin)
    # the Pallas kernel takes pre-clipped tables; compare where allocated
    flat_pool = jnp.asarray(pool_v.reshape(nb, bs, G * D))
    pallas = np.asarray(gather_kv_paged_kernel(
        flat_pool, jnp.asarray(np.maximum(bt, 0)), jnp.asarray(lidx)))
    alloc = bt[np.arange(2)[:, None], lidx // bs] >= 0
    np.testing.assert_array_equal(gv.numpy().reshape(2, 20, G * D)[alloc],
                                  pallas[alloc])
    assert not alloc.all()

    # the decode gather: sink and window rows through the table (window
    # starts reaching the -1 entries) and the winners by physical row
    phys = rng.randint(0, nb * bs, size=(2, G, HG, 7)).astype(np.int32)
    ws = np.array([40, 50], np.int32)
    dk, dv, wk, wv = gather_decode_paged(_t(pool_k), _t(pool_v), _t(bt),
                                         _t(ws), 3, 20, _t(phys))
    dense = np.concatenate([np.broadcast_to(np.arange(3), (2, 3)),
                            ws[:, None] + np.arange(20)], 1).astype(np.int32)
    for got, pool in ((dk, pool_k), (dv, pool_v)):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JCC.paged_gather_rows(
                jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(dense))))
    for got, pool in ((wk, pool_k), (wv, pool_v)):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JCC.gather_heads_physical(
                jnp.asarray(pool), jnp.asarray(phys))))
    only_k = gather_rows_paged(_t(pool_k), None, _t(bt), _t(lidx))
    np.testing.assert_array_equal(only_k.numpy(), gk.numpy())


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU gets the kernel or an exception —
    never the plain version (meta tensors stand in for a card here)."""
    before = dict(TK.LAUNCHES)
    m = dict(device="meta")
    ids = torch.empty((4, G, 8, 16), dtype=torch.uint8, **m)
    bt = torch.empty((2, 3), dtype=torch.int32, **m)
    i32 = torch.empty((2,), dtype=torch.int32, **m)
    calls = [
        lambda: collision_scores_paged_kernel(
            ids, bt, torch.empty((2, G, HG, 16, 256), dtype=torch.int32,
                                 **m), i32, 2, 96),
        lambda: bucket_topk(torch.empty((2, 50), dtype=torch.int32, **m),
                            8, 96),
        lambda: rerank_topk_paged(
            torch.empty((4, G, 8, 16), dtype=torch.int32, **m),
            torch.empty((4, G, 8, 16), **m), bt,
            torch.empty((2, G, HG, 5), dtype=torch.int32, **m),
            torch.empty((2, G, HG, 16, 8), **m), torch.empty((2, G, HG), **m),
            i32, 2, 3),
        lambda: gather_rows_paged(
            torch.empty((4, 8, G, D), **m), None, bt,
            torch.empty((2, 5), dtype=torch.int32, **m)),
        lambda: gather_decode_paged(
            torch.empty((4, 8, G, D), **m), torch.empty((4, 8, G, D), **m),
            bt, i32, 2, 3, torch.empty((2, G, HG, 5), dtype=torch.int32, **m)),
        lambda: collision_scores_kernel(
            torch.empty((2, G, 40, 16), dtype=torch.uint8, **m),
            torch.empty((2, G, HG, 16, 256), dtype=torch.int32, **m), i32, 2,
            96),
        lambda: bucket_count(
            torch.empty((2, G, 40, 16), dtype=torch.uint8, **m), i32, 2, 256),
        lambda: gather_kv_kernel(torch.empty((2, 40, D), **m),
                                 torch.empty((2, 5), dtype=torch.int32, **m)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()
    assert TK.LAUNCHES == before
