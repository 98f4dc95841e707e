"""The contiguous path's route onto the paged kernels: a contiguous store is
a pool of one block per batch row (``kernels.row_tables``). The port's
plain versions against the JAX reference on the same numpy inputs (CPU):

- ``bucket_count`` (the region's bucket histogram, one kernel on the card)
  against ``bucket_histogram`` over the region, full and strided;
- the contiguous Stage I through the paged Stage I: scores against
  ``collision_scores``, its histograms per segment against numpy's, and
  the cut from them against ``select_candidates_bucket``;
- the contiguous decode rows through the paged decode gather against the
  reference's sink slice, ``dynamic_slice`` window (a start past n - W
  clamps) and ``gather_kv_heads``, and the attention over them.

Integer outputs and gathered rows are identical; the attention output
agrees to float32 reassociation (rtol 1e-5, atol 1e-5)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import attention as JA  # noqa: E402
from repro.core import retrieval as JR  # noqa: E402
from repro.core.config import ParisKVConfig as JP  # noqa: E402
from repro_torch.core import attention as TA  # noqa: E402
from repro_torch.core import retrieval as TR  # noqa: E402
from repro_torch.core.config import ParisKVConfig as TP  # noqa: E402
from repro_torch.kernels import SEG_LEN, row_tables  # noqa: E402
from repro_torch.kernels.collision import bucket_count  # noqa: E402
from repro_torch.kernels.collision.ref import bucket_count_ref  # noqa: E402

KW = dict(sink_size=16, local_size=64, update_interval=32, top_k=32,
          min_candidates=64)
CFG_J, CFG_T = JP(**KW), TP(**KW)
D, G, HG = 64, 2, 3
B, NC = CFG_T.num_subspaces(D), CFG_T.num_centroids()


def _t(a):
    return torch.from_numpy(np.array(a))


def _ids(n, seed):
    """(3, G, n, B) uint8 ids and ragged regions: the whole store, a
    ragged end, and an end at the sink (an empty region)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, NC, size=(3, G, n, B)).astype(np.uint8)
    enc_end = np.array([n, n // 2 + 7, CFG_T.sink_size], np.int32)
    return ids, enc_end, rng


def _valid(n, enc_end):
    pos = np.arange(n)
    return (pos >= CFG_T.sink_size) & (pos < enc_end[:, None])   # (b, n)


@pytest.mark.parametrize("n", [300, 512])
@pytest.mark.parametrize("stride", [1, 4])
def test_bucket_count_matches_reference_histogram(n, stride):
    """bucket_count == the reference's ``bucket_histogram`` over [sink,
    enc_end) of positions ≡ 0 (mod stride), scaled by the stride, as its
    ``collision_scores`` samples them; an empty region counts zeros."""
    ids, enc_end, _ = _ids(n, seed=n + stride)
    enc_end[1] = 3                                   # below the sink too
    valid = _valid(n, enc_end)[:, None]
    want = np.asarray(JR.bucket_histogram(
        jnp.asarray(ids[:, :, ::stride]), jnp.asarray(valid[..., ::stride]),
        NC)) * stride
    got = bucket_count_ref(_t(ids), _t(enc_end), CFG_T.sink_size, NC, stride)
    assert got.dtype == torch.int32 and got.shape == (3, G, B, NC)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        bucket_count(_t(ids), _t(enc_end), CFG_T.sink_size, NC,
                     stride).numpy(), want)
    assert (want[1:] == 0).all() and want[0].sum() > 0


@pytest.mark.parametrize("n", [300, 1000])
@pytest.mark.parametrize("hist_sample", [0, 64])
def test_contiguous_stage1_and_cut_match_reference(n, hist_sample):
    """The contiguous Stage I through the paged kernel's plain version:
    scores identical to the reference's ``collision_scores`` (the region's
    histogram, strided with ``hist_sample``); ``seg_hist`` identical to
    numpy's histogram of score + 1 over each 256-position segment; the cut
    from it identical to ``select_candidates_bucket``."""
    ids, enc_end, rng = _ids(n, seed=7 * n + hist_sample)
    q_sub = rng.randn(3, G, HG, B, CFG_T.m).astype(np.float32)
    valid = _valid(n, enc_end)[:, None, None]               # (b, 1, 1, n)
    want = np.asarray(JR.collision_scores(
        jnp.asarray(ids[:, :, None]), jnp.asarray(q_sub), jnp.asarray(valid),
        CFG_J, hist_sample=hist_sample))
    scores, seg_hist = TR.collision_scores_hist(
        _t(ids), _t(q_sub), _t(enc_end), CFG_T, hist_sample=hist_sample)
    np.testing.assert_array_equal(scores.numpy(), want)
    assert (want[2] == -1).all() and (want[0, ..., CFG_T.sink_size:] >= 0).all()

    sr = TR.max_collision_score(CFG_T, B)
    nseg = -(-n // SEG_LEN)
    assert seg_hist.shape == (3, G, HG, nseg, sr + 2)
    for j in range(nseg):
        seg = want[..., j * SEG_LEN:(j + 1) * SEG_LEN] + 1
        hist = np.apply_along_axis(np.bincount, -1, seg, minlength=sr + 2)
        np.testing.assert_array_equal(seg_hist[..., j, :].numpy(), hist)

    C = CFG_T.candidate_count(n)
    cut = TR.select_candidates_bucket(scores, C, sr, seg_hist=seg_hist)
    np.testing.assert_array_equal(
        cut.numpy(), np.asarray(JR.select_candidates_bucket(
            jnp.asarray(want), C, sr)))


def test_contiguous_decode_rows_match_reference_gathers():
    """Sink, window and winner rows of a contiguous cache through the paged
    decode gather (plain version) and the one-block-per-row table equal
    the reference's: the sink slice, the ``dynamic_slice`` window (row 1's
    start lies past n - W and clamps) and ``gather_kv_heads`` of the
    winners at rows i·n + position; the decode attention over them agrees
    with the reference's ``sparse_decode_attention``."""
    b, n, k = 2, 200, 9
    W = CFG_T.local_size + CFG_T.update_interval
    rng = np.random.RandomState(3)
    kc = rng.randn(b, n, G, D).astype(np.float32)
    vc = rng.randn(b, n, G, D).astype(np.float32)
    top = rng.randint(CFG_T.sink_size, 150, size=(b, G, HG, k)).astype(
        np.int32)
    phys = top + n * np.arange(b, dtype=np.int32)[:, None, None, None]
    ws = np.array([20, n - W + 25], np.int32)
    rows = TA.paged_decode_rows(
        _t(kc), _t(vc), row_tables(b, "cpu"), _t(np.minimum(ws, n - W)),
        _t(phys), sink_size=CFG_T.sink_size, window_size=W)
    sink = CFG_T.sink_size
    window = jax.vmap(lambda row, s: jax.lax.dynamic_slice_in_dim(
        row, s, W, axis=0))
    for got, want in ((rows.k_sink, kc[:, :sink]), (rows.v_sink, vc[:, :sink]),
                      (rows.k_loc, window(jnp.asarray(kc), jnp.asarray(ws))),
                      (rows.v_loc, window(jnp.asarray(vc), jnp.asarray(ws))),
                      (rows.k_ret, JA.gather_kv_heads(jnp.asarray(kc),
                                                      jnp.asarray(top))),
                      (rows.v_ret, JA.gather_kv_heads(jnp.asarray(vc),
                                                      jnp.asarray(top)))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    q = rng.randn(b, G * HG, D).astype(np.float32)
    pos = ws + W - 1
    enc_end = np.array([150, 150], np.int32)
    kw = dict(sink_size=sink, window_size=W, sm_scale=D ** -0.5)
    want = np.asarray(JA.sparse_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(top),
        jnp.asarray(ws), jnp.asarray(pos), jnp.asarray(enc_end), **kw))
    got = TA.sparse_decode_attention(
        _t(q), _t(kc), _t(vc), _t(top), _t(ws), _t(pos), _t(enc_end),
        _t(phys), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
