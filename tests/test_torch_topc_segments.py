"""The hand-off from Stage I to the top-C cut through score histograms per
segment, on the CPU, against the JAX reference.

The paged Stage I writes, beside its scores, the histogram of score + 1
over every segment of ``SEG_LEN`` positions; the top-C cut finds its
threshold from their sum and each segment's output offset and tie share
from the segments before it. The plain versions here do the kernels'
arithmetic per segment, so these tests check the decomposition itself:
the histograms equal a numpy histogram per segment of the reference's
``collision_scores_paged`` scores, and the cut equals
``select_candidates_bucket`` exactly (ragged rows, all ties, mostly
invalid rows, more candidates than valid keys, threshold ties over several
segments, n not a multiple of the segment). ``tests/test_torch_cuda.py``
holds both kernels against these plain versions on the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import encode as JE  # noqa: E402
from repro.core import retrieval as JR  # noqa: E402
from repro.core import srht as JS  # noqa: E402
from repro.core.config import ParisKVConfig as JP  # noqa: E402
from repro_torch import kernels as TK  # noqa: E402
from repro_torch.core import retrieval as TR  # noqa: E402
from repro_torch.core.config import ParisKVConfig as TP  # noqa: E402
from repro_torch.kernels import SEG_LEN  # noqa: E402
from repro_torch.kernels.bucket_topk import (bucket_topk,  # noqa: E402
                                             segment_histogram)
from repro_torch.kernels.bucket_topk.ref import bucket_topk_ref  # noqa: E402
from repro_torch.kernels.collision import (  # noqa: E402
    collision_scores_paged_kernel)

KW = dict(sink_size=16, local_size=64, update_interval=32, top_k=32,
          min_candidates=64)
CFG_J, CFG_T = JP(**KW), TP(**KW)
D, G, HG = 64, 2, 3
B = CFG_J.num_subspaces(D)
SR = max(CFG_J.tier_weights) * B          # the largest Stage-I score


def _t(a):
    return torch.from_numpy(np.array(a))           # writable copy


def _np_seg_hist(scores, rng):
    """numpy histogram of score + 1 per segment of SEG_LEN positions."""
    n = scores.shape[-1]
    nseg = -(-n // SEG_LEN)
    out = np.zeros(scores.shape[:-1] + (nseg, rng), np.int32)
    for j in range(nseg):
        seg = scores[..., j * SEG_LEN:(j + 1) * SEG_LEN] + 1
        for idx in np.ndindex(scores.shape[:-1]):
            out[idx + (j,)] = np.bincount(seg[idx], minlength=rng)
    return out


def _stage1(seed, bt, enc_end, nb=24, bs=32):
    """Reference and port Stage I on one random pool: → (reference
    scores, port scores, port seg_hist)."""
    rng = np.random.RandomState(seed)
    keys = rng.randn(nb, G, bs, D).astype(np.float32)
    signs = jnp.asarray(JS.rademacher_signs(D, CFG_J.srht_seed))
    ids = np.asarray(JE.encode_keys(jnp.asarray(keys), CFG_J,
                                    signs).centroid_ids)
    b, nblk = bt.shape
    n = nblk * bs
    q_sub = rng.randn(b, G, HG, B, 8).astype(np.float32)
    view = np.moveaxis(ids[np.maximum(bt, 0)], 2, 1).reshape(b, G, n, B)
    valid = ((np.arange(n)[None] >= CFG_J.sink_size)
             & (np.arange(n)[None] < enc_end[:, None]))
    hist = np.asarray(JR.bucket_histogram(view, jnp.asarray(valid)[:, None],
                                          256))
    want = np.asarray(JR.collision_scores_paged(
        jnp.asarray(ids), jnp.asarray(bt), jnp.asarray(q_sub),
        jnp.asarray(hist), jnp.asarray(enc_end), CFG_J))
    got, seg_hist = TR.collision_scores_paged_hist(
        _t(ids), _t(bt), _t(q_sub), _t(hist), _t(enc_end), CFG_T)
    return want, got.numpy(), seg_hist.numpy()


# 24 blocks of 32 → n = 768, three segments; the second row holds 4
# blocks, short enough that C exceeds its valid keys
BT = np.array([[3, 5, 1, 8, 0, 9, 2, 11, 14, 12, 13, 15, 16, 17, 18, 19,
                20, 21, 22, 23, -1, -1, -1, -1],
               [4, 10, 6, 7, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
                -1, -1, -1, -1, -1, -1, -1, -1]], np.int32)


@pytest.mark.parametrize("enc_end", [(640, 70), (600, 128)])
def test_stage1_seg_hist_matches_numpy_of_reference_scores(enc_end):
    """The plain Stage I's histograms per segment equal a numpy histogram
    of the reference's scores, segment by segment (masked positions in bin
    0), and its scores equal the reference's."""
    want, got, seg_hist = _stage1(1, BT, np.asarray(enc_end, np.int32))
    np.testing.assert_array_equal(got, want)
    assert seg_hist.shape == (2, G, HG, 3, SR + 2)
    np.testing.assert_array_equal(seg_hist, _np_seg_hist(want, SR + 2))
    assert seg_hist[1, ..., 1:, 0].min() == SEG_LEN  # masked segments
    # the direct wrapper call gives the same pair
    ids = torch.zeros((24, G, 32, B), dtype=torch.uint8)
    s, h = collision_scores_paged_kernel(
        ids, _t(BT), torch.zeros((2, G, HG, B, 256), dtype=torch.uint8),
        _t(np.asarray(enc_end, np.int32)), 16, SR)
    assert h.shape == seg_hist.shape and h.sum() == s.numel()


@pytest.mark.parametrize("C", [100, 300])
def test_stage1_to_topc_handoff_matches_reference(C):
    """Stage I's histograms feed the cut: the candidates equal the
    reference's on its own Stage-I scores, also when C exceeds the short
    row's 54 valid keys and -1 ties are taken from masked segments."""
    enc_end = np.array([640, 70], np.int32)
    want, got, seg_hist = _stage1(2, BT, enc_end)
    ref = np.asarray(JR.select_candidates_bucket(jnp.asarray(want), C, SR))
    cand = TR.select_candidates_bucket(_t(got), C, SR,
                                       seg_hist=_t(seg_hist)).numpy()
    np.testing.assert_array_equal(cand, ref)
    if C == 300:                      # ties at -1 reach the next segment
        assert (cand[1] >= SEG_LEN).any()


def _scores(case):
    """(scores (2, G, HG, n) int32, C) for one case of the cut."""
    rng = np.random.RandomState(7)
    n = {"ragged": 1000, "all_ties": 768, "mostly_invalid": 1024,
         "c_above_valid": 1024, "ties_span_segments": 1024,
         "ragged_n_hist_pass": 1000}[case]
    s = rng.randint(-1, SR + 1, size=(2, G, HG, n)).astype(np.int32)
    C = 100
    if case == "ragged":                       # a -1 tail per row
        for i, e in enumerate((1000, 431)):
            s[i, ..., e:] = -1
    elif case == "all_ties":
        s[:] = 7
    elif case == "mostly_invalid":
        s[..., 300:] = -1
    elif case == "c_above_valid":              # 40 valid < C: -1 ties taken
        s[..., :40] = rng.randint(0, SR + 1, size=s[..., :40].shape)
        s[..., 40:] = -1
    elif case == "ties_span_segments":
        s = rng.randint(-1, SR - 10, size=s.shape).astype(np.int32)
        s[..., rng.choice(n, 30, replace=False)] = SR
        s[..., 3::7] = SR - 3                  # 146 ties over 4 segments
        C = 130                                # quota 100: ends mid-segment
    return s, C


@pytest.mark.parametrize("case", ["ragged", "all_ties", "mostly_invalid",
                                  "c_above_valid", "ties_span_segments",
                                  "ragged_n_hist_pass"])
def test_topc_from_seg_hist_matches_reference(case):
    """The cut from histograms per segment (the histogram pass's plain
    version, then the per-segment arithmetic) equals the reference's
    select_candidates_bucket and the port's whole-row plain version."""
    scores, C = _scores(case)
    want = np.asarray(JR.select_candidates_bucket(jnp.asarray(scores), C, SR))
    hist = segment_histogram(_t(scores), SR)
    np.testing.assert_array_equal(hist.numpy(), _np_seg_hist(scores, SR + 2))
    got = bucket_topk(_t(scores), C, SR, seg_hist=hist).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, bucket_topk_ref(_t(scores), C,
                                                       SR).numpy())
    if case == "ties_span_segments":
        # the threshold is the tie value; its ties lie in every segment and
        # the quota ends inside one that keeps untaken ties after it
        seg = np.arange(scores.shape[-1]) // SEG_LEN
        taken = np.zeros(scores.shape, bool)
        np.put_along_axis(taken, got, True, -1)
        ties = scores == SR - 3
        assert all(len(np.unique(seg[ties[i]])) >= 3
                   for i in np.ndindex(scores.shape[:-1]))
        last = (ties & taken).nonzero()[-1].max()
        assert (ties[..., last + 1:(seg[last] + 1) * SEG_LEN] & ~taken[
            ..., last + 1:(seg[last] + 1) * SEG_LEN]).any()
    if case == "c_above_valid":
        taken = np.take_along_axis(scores, got, -1)
        assert ((taken == -1).sum(-1) == C - 40).all()


def test_seg_hist_must_fit_the_scores():
    """A seg_hist of the wrong shape or type raises on every device."""
    scores = torch.zeros((2, 600), dtype=torch.int32)
    good = segment_histogram(scores, SR)
    assert good.shape == (2, 3, SR + 2)
    for bad in (good[:, :2], good[..., :-1], good.long()):
        with pytest.raises(ValueError, match="seg_hist"):
            bucket_topk(scores, 50, SR, seg_hist=bad)


def test_new_wrappers_never_fall_back_off_the_cpu():
    """The histogram pass, the cut from histograms and Stage I with its
    histograms get the kernel or an exception on a tensor that is not on
    the CPU (meta tensors stand in for a card here)."""
    before = dict(TK.LAUNCHES)
    m = dict(device="meta")
    scores = torch.empty((2, 600), dtype=torch.int32, **m)
    hist = torch.empty((2, 3, SR + 2), dtype=torch.int32, **m)
    calls = [
        lambda: segment_histogram(scores, SR),
        lambda: bucket_topk(scores, 50, SR, seg_hist=hist),
        lambda: collision_scores_paged_kernel(
            torch.empty((4, G, 8, 16), dtype=torch.uint8, **m),
            torch.empty((2, 3), dtype=torch.int32, **m),
            torch.empty((2, G, HG, 16, 256), dtype=torch.uint8, **m),
            torch.empty((2,), dtype=torch.int32, **m), 2, SR),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()
    assert TK.LAUNCHES == before
