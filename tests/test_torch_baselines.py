"""The paper's comparison code in the port against the reference, in
float32 on the same numpy inputs (CPU): the analysis helpers its
benchmarks import (``exact_topk``, ``recall_at_k``,
``estimate_inner_products``, ``radius_levels``, ``quantize_radii``,
``decode_centroid``, ``srht_rotate_t``) and the baselines (MagicPIG's
SimHash tables, PQCache's k-means, coarse and PQ retrieval, full
attention's re-exports).

Integer outputs are exact: signatures, ``retrieve`` ids, cluster
assignments, PQ codes, ``coarse_retrieve`` and ``pq_retrieve`` ids,
``exact_topk`` ids, ``quantize_radii``, ``decode_centroid``; so are
``radius_levels`` (numpy on both sides). Floats agree within the
tolerance stated beside each. Every retrieve meets a
constructed case of tied scores, which ``lax.top_k`` breaks lowest index
first, and ``pq_retrieve`` clusters tied at its probe threshold. torch
cannot reproduce ``jax.random``: MagicPIG's tables take the reference's
projections and k-means the reference's initial points, computed here
with jax. Where a float near tie flips an integer output, the assertion
message carries its margin."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores, and torch's
# spinning OpenMP pool would otherwise slow each of them many times over
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.baselines import full_attention as JFA  # noqa: E402
from repro.baselines import magicpig as JMP  # noqa: E402
from repro.baselines import pqcache as JPQ  # noqa: E402
from repro.core import centroids as Jcent  # noqa: E402
from repro.core import encode as JE  # noqa: E402
from repro.core import quantizer as JQ  # noqa: E402
from repro.core import retrieval as JR  # noqa: E402
from repro.core import srht as JS  # noqa: E402
from repro.core.config import ParisKVConfig as JP  # noqa: E402
from repro_torch.baselines import full_attention as TFA  # noqa: E402
from repro_torch.baselines import magicpig as TMP  # noqa: E402
from repro_torch.baselines import pqcache as TPQ  # noqa: E402
from repro_torch.core import attention as TA  # noqa: E402
from repro_torch.core import centroids as Tcent  # noqa: E402
from repro_torch.core import encode as TE  # noqa: E402
from repro_torch.core import quantizer as TQ  # noqa: E402
from repro_torch.core import retrieval as TR  # noqa: E402
from repro_torch.core import srht as TS  # noqa: E402

CFG = JP()
D = 64
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))           # writable copy


def _keys(n, d=D, seed=0, batch=()):
    return np.random.RandomState(seed).randn(*batch, n, d).astype(np.float32)


# ------------------------------------------------------------ helpers ----
def test_exact_topk_matches_reference():
    """Batched keys (2, 3, 512, 64) with invalid positions: ids exact,
    inner products within 1e-5; the margin of any id that differs."""
    keys = _keys(512, batch=(2, 3))
    q = np.random.RandomState(1).randn(2, 3, D).astype(np.float32)
    valid = np.random.RandomState(2).rand(2, 3, 512) > 0.2
    ids_j, vals_j = JR.exact_topk(jnp.asarray(keys), jnp.asarray(q),
                                  jnp.asarray(valid), 40)
    ids_t, vals_t = TR.exact_topk(_t(keys), _t(q), _t(valid), 40)
    assert ids_t.dtype == torch.int32
    ids_j, vals_j = np.asarray(ids_j), np.asarray(vals_j)
    diff = ids_t.numpy() != ids_j
    margins = np.abs(np.diff(vals_j, axis=-1)).min()
    assert not diff.any(), f"{diff.sum()} ids differ; least gap {margins}"
    np.testing.assert_allclose(vals_t.numpy(), vals_j, **FLOAT_TOL)


def test_exact_topk_ties_lowest_index_first():
    """Eight copies of one key among zeros, every key valid but the last
    two: the copies rank by index, then the zeros by index, then the
    invalid ones at NEG_INF."""
    keys = np.zeros((16, D), np.float32)
    keys[[3, 5, 6, 9, 10, 12, 13, 15]] = 1.0
    q = np.ones(D, np.float32)
    valid = np.arange(16) < 14
    want, _ = JR.exact_topk(jnp.asarray(keys), jnp.asarray(q),
                            jnp.asarray(valid), 16)
    got, vals = TR.exact_topk(_t(keys), _t(q), _t(valid), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [3, 5, 6, 9, 10, 12, 13, 0, 1, 2, 4, 7, 8, 11,
                            14, 15]
    assert float(vals[-1]) == np.float32(TR.NEG_INF)


def test_recall_at_k_matches_reference():
    rng = np.random.RandomState(3)
    retrieved = rng.randint(0, 64, (4, 5, 16)).astype(np.int32)
    oracle = rng.randint(0, 64, (4, 5, 16)).astype(np.int32)
    oracle[0, 0] = retrieved[0, 0]                       # recall 1
    want = np.asarray(JR.recall_at_k(jnp.asarray(retrieved),
                                     jnp.asarray(oracle)))
    got = TR.recall_at_k(_t(retrieved), _t(oracle)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 1.0


def test_estimate_inner_products_matches_reference():
    """The RSQ-IP estimate over all keys from the reference's metadata
    (codes as int32 bit patterns) within 1e-5 relative; the port's own
    encoding gives the same estimates."""
    keys = _keys(256, batch=(2,))
    q = np.random.RandomState(4).randn(2, D).astype(np.float32)
    signs = JS.rademacher_signs(D, CFG.srht_seed)
    meta = JE.encode_keys(jnp.asarray(keys), CFG, jnp.asarray(signs))
    qt = JE.encode_query(jnp.asarray(q), CFG, jnp.asarray(signs))
    want = np.asarray(JE.estimate_inner_products(meta, qt, CFG))
    meta_t = TE.KeyMetadata(_t(meta.centroid_ids),
                            _t(np.asarray(meta.codes).view(np.int32)),
                            _t(meta.weights))
    qt_t = TE.QueryTransform(_t(qt.q_norm), _t(qt.q_sub))
    got = TE.estimate_inner_products(meta_t, qt_t, CFG).numpy()
    assert got.shape == (2, 256)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    own = TE.estimate_inner_products(
        TE.encode_keys(_t(keys), CFG, _t(signs)),
        TE.encode_query(_t(q), CFG, _t(signs)), CFG).numpy()
    np.testing.assert_allclose(own, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m,dim,bits", [(8, 128, 2), (8, 64, 1), (4, 64, 3)])
def test_radius_levels_and_quantize_radii(m, dim, bits):
    """Levels bit for bit (the same numpy arithmetic); quantized radii
    exact, also at the thresholds themselves (searchsorted's left side)."""
    tau_t, lv_t = TQ.radius_levels(m, dim, bits)
    tau_j, lv_j = JQ.radius_levels(m, dim, bits)
    np.testing.assert_array_equal(tau_t, tau_j)
    np.testing.assert_array_equal(lv_t, lv_j)
    r = np.concatenate([np.random.RandomState(5).rand(500), tau_j,
                        np.nextafter(tau_j, 1)]).astype(np.float32)
    want = np.asarray(JQ.quantize_radii(jnp.asarray(r), m, dim, bits))
    got = TQ.quantize_radii(_t(r), m, dim, bits).numpy()
    np.testing.assert_array_equal(got, want)


def test_decode_centroid_matches_reference():
    ids = np.random.RandomState(6).randint(0, 256, (3, 7)).astype(np.uint8)
    want = np.asarray(Jcent.decode_centroid(jnp.asarray(ids), 8))
    got = Tcent.decode_centroid(_t(ids), 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim", [64, 96])
def test_srht_rotate_t_inverts_the_rotation(dim):
    """Within 1e-6 of the reference's, and the inverse of ``srht_rotate``
    (a padded dimension 96 → 128 comes back cut to 96)."""
    dp = 1 << (dim - 1).bit_length()
    signs = JS.rademacher_signs(dp, CFG.srht_seed)
    x = _keys(5, dim, seed=7)
    y = np.asarray(JS.srht_rotate(jnp.asarray(x), jnp.asarray(signs)))
    want = np.asarray(JS.srht_rotate_t(jnp.asarray(y), jnp.asarray(signs),
                                       dim))
    got = TS.srht_rotate_t(_t(y), _t(signs), dim).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    back = TS.srht_rotate_t(TS.srht_rotate(_t(x), _t(signs)), _t(signs), dim)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-5)


def test_full_attention_baseline_reexports_the_port():
    """The module names the port's three dense oracles, as the
    reference's names its own."""
    for name in ("blockwise_causal_attention", "dense_decode_attention",
                 "full_attention"):
        assert getattr(TFA, name) is getattr(TA, name)
        assert callable(getattr(JFA, name))


# ----------------------------------------------------------- MagicPIG ----
def _lsh(L=10, K=10, seed=0):
    proj = np.asarray(JMP.make_params(D, L, K, seed).projections)
    return (JMP.LSHParams(jnp.asarray(proj)),
            TMP.LSHParams(_t(proj)), proj)


def _sig_margin(x, proj, differ):
    """The least |projection| over the (key, table) pairs that differ."""
    y = np.einsum("lkd,nd->nlk", proj, x)
    return float(np.abs(y[differ]).min()) if differ.any() else None


def test_signatures_match_reference():
    """Packed sign bits of 2,048 keys in 10 tables of 10 bits equal the
    reference's uint32 words as values; ``append`` adds the new keys'
    below; ``make_params`` draws (L, K, d) on the CPU when asked."""
    keys = _keys(2048, seed=8)
    pj, pt, proj = _lsh()
    want = np.asarray(JMP.build(jnp.asarray(keys[:1500]), pj).codes)
    tables = TMP.build(_t(keys[:1500]), pt)
    got = tables.codes.numpy()
    differ = got != want.astype(np.int64)
    assert not differ.any(), ("signatures differ", _sig_margin(
        keys[:1500], proj, differ))
    grown = TMP.append(tables, _t(keys[1500:]))
    want_all = np.asarray(JMP.append(JMP.build(jnp.asarray(keys[:1500]), pj),
                                     jnp.asarray(keys[1500:])).codes)
    np.testing.assert_array_equal(grown.codes.numpy(),
                                  want_all.astype(np.int64))
    assert grown.codes.dtype == torch.int64 and grown.codes.max() < 1 << 10
    own = TMP.make_params(D, 4, 6, seed=3, device="cpu")
    assert own.projections.shape == (4, 6, D)
    assert torch.equal(own.projections,
                       TMP.make_params(D, 4, 6, seed=3, device="cpu")
                       .projections)


@pytest.mark.parametrize("min_collisions", [1, 2, 3])
def test_retrieve_matches_reference(min_collisions):
    """Ids exact for queries near stored keys (high counts) and random
    ones (mostly ties at 0 and at ``min_collisions``)."""
    keys = _keys(2048, seed=9)
    pj, pt, _ = _lsh()
    tj, tt = JMP.build(jnp.asarray(keys), pj), TMP.build(_t(keys), pt)
    rng = np.random.RandomState(10)
    for q in (keys[77] + 0.3 * rng.randn(D).astype(np.float32),
              rng.randn(D).astype(np.float32)):
        want = np.asarray(JMP.retrieve(tj, jnp.asarray(q), 128,
                                       min_collisions))
        got = TMP.retrieve(tt, _t(q), 128, min_collisions)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_retrieve_ties_lowest_index_first():
    """Constructed counts: keys equal to the query collide in every table,
    their negatives in none; with every key one of the two, the copies
    come first by index, then the rest by index (all score 0)."""
    q = _keys(1, seed=11)[0]
    keys = np.stack([q if i % 3 == 0 else -q for i in range(60)])
    pj, pt, _ = _lsh()
    want = np.asarray(JMP.retrieve(JMP.build(jnp.asarray(keys), pj),
                                   jnp.asarray(q), 30))
    got = TMP.retrieve(TMP.build(_t(keys), pt), _t(q), 30).numpy()
    np.testing.assert_array_equal(got, want)
    copies = list(range(0, 60, 3))
    assert got.tolist() == copies + [i for i in range(60)
                                     if i % 3][:10]


def test_sampled_attention_matches_reference():
    """Within 1e-5 over the retrieved set."""
    keys, values = _keys(1024, seed=12), _keys(1024, seed=13)
    pj, pt, _ = _lsh()
    q = keys[5] + 0.2 * _keys(1, seed=14)[0]
    want = np.asarray(JMP.sampled_attention(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(values),
        JMP.build(jnp.asarray(keys), pj), 64, 0.125))
    got = TMP.sampled_attention(_t(q), _t(keys), _t(values),
                                TMP.build(_t(keys), pt), 64, 0.125)
    np.testing.assert_allclose(got.numpy(), want, **FLOAT_TOL)


# ------------------------------------------------------------ PQCache ----
N_PQ, FIT, COARSE, SUB = 4096, 2048, 16, 8


def _perm(seed, n, k):
    """The reference's initial points: ``jax.random.permutation``'s first
    k."""
    return np.array(jax.random.permutation(jax.random.PRNGKey(seed),
                                           n)[:k])


def _assign_margin(x, cents, differ):
    """The least gap between the two nearest squared distances of the
    points whose assignment differs."""
    d2 = ((x[:, None] - cents[None]) ** 2).sum(-1)
    two = np.sort(d2, -1)[:, :2]
    gaps = (two[:, 1] - two[:, 0])[differ]
    return float(gaps.min()) if gaps.size else None


@pytest.fixture(scope="module")
def pq():
    """The reference's PQCache over 4,096 keys (16 coarse clusters, 8
    sub-codebooks of 256, fitted on the first 2,048) and the port's from
    the same initial points."""
    keys = _keys(N_PQ, seed=15)
    book_j = JPQ.build_pq(jnp.asarray(keys), COARSE, SUB, seed=0,
                          fit_sample=FIT)
    book_t = TPQ.build_pq(_t(keys), COARSE, SUB, seed=0, fit_sample=FIT,
                          coarse_init=_perm(0, FIT, COARSE),
                          sub_init=[_perm(1 + b, FIT, 256)
                                    for b in range(SUB)])
    return keys, book_j, book_t


def test_kmeans_matches_reference():
    """20 Lloyd iterations from the reference's initial points: centroids
    within 1e-5; the final assignment exact."""
    x = _keys(1024, 16, seed=16)
    want = np.asarray(JPQ.kmeans(jnp.asarray(x), 12, seed=4))
    got = TPQ.kmeans(_t(x), 12, seed=4, init=_perm(4, 1024, 12)).numpy()
    np.testing.assert_allclose(got, want, **FLOAT_TOL)
    a_t = TPQ.assign_clusters(_t(x), _t(want)).numpy()
    a_j = np.asarray(JPQ.assign_clusters(jnp.asarray(x), jnp.asarray(want)))
    assert (a_t == a_j).all(), _assign_margin(x, want, a_t != a_j)
    own = TPQ.kmeans(_t(x), 12, seed=4)
    assert torch.equal(own, TPQ.kmeans(_t(x), 12, seed=4))


def test_kmeans_keeps_an_empty_clusters_centroid():
    """The third initial point duplicates the first, so every point nearest
    to both takes the first (the first minimum wins): the third cluster is
    empty after one iteration and keeps its centroid, as the
    reference's."""
    x = _keys(64, 4, seed=18)
    init = _perm(5, 64, 3)
    x[init[2]] = x[init[0]]
    want = np.asarray(JPQ.kmeans(jnp.asarray(x), 3, iters=1, seed=5))
    got = TPQ.kmeans(_t(x), 3, iters=1, seed=5, init=init).numpy()
    np.testing.assert_allclose(got, want, **FLOAT_TOL)
    np.testing.assert_array_equal(got[2], x[init[0]])


def test_build_pq_matches_reference(pq):
    """Coarse centroids and sub-codebooks within 1e-5; assignments and PQ
    codes (uint8) exact, a differing one reported with its margin."""
    keys, book_j, book_t = pq
    np.testing.assert_allclose(book_t.coarse.numpy(),
                               np.asarray(book_j.coarse), **FLOAT_TOL)
    np.testing.assert_allclose(book_t.sub_codebooks.numpy(),
                               np.asarray(book_j.sub_codebooks), **FLOAT_TOL)
    a_j = np.asarray(book_j.assignments)
    differ = book_t.assignments.numpy() != a_j
    assert not differ.any(), _assign_margin(
        keys, np.asarray(book_j.coarse), differ)
    assert book_t.pq_codes.dtype == torch.uint8
    codes_j = np.asarray(book_j.pq_codes)
    differ = book_t.pq_codes.numpy() != codes_j
    assert not differ.any(), f"{differ.sum()} PQ codes differ"


def test_coarse_and_pq_retrieve_match_reference(pq):
    """Ids exact at top-k 256 for four queries: the coarse ranking, whose
    members of a cluster all tie (lowest index first), and the probed ADC
    ranking at n_probe 2, 4 and 8."""
    keys, book_j, book_t = pq
    rng = np.random.RandomState(17)
    for q in rng.randn(4, D).astype(np.float32):
        want = np.asarray(JPQ.coarse_retrieve(
            jnp.asarray(keys), book_j.coarse, jnp.asarray(q), 256))
        got = TPQ.coarse_retrieve(_t(keys), book_t.coarse, _t(q), 256)
        np.testing.assert_array_equal(got.numpy(), want)
        for n_probe in (2, 4, 8):
            want = np.asarray(JPQ.pq_retrieve(book_j, jnp.asarray(q), 256,
                                              n_probe))
            got = TPQ.pq_retrieve(book_t, _t(q), 256, n_probe)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"n_probe {n_probe}")


def test_pq_retrieve_probes_clusters_tied_at_the_threshold():
    """Constructed book: clusters 1 and 2 tie at the n_probe-th largest
    score, so both are probed (``>=`` on values, not the top-n_probe ids);
    ADC scores are zero (zero codebooks), so probed keys tie by cluster
    and rank by index; unprobed keys score -1e30 and tie among themselves
    at the end, by index."""
    d, n_sub = 8, 2
    coarse = np.zeros((4, d), np.float32)
    coarse[0, 0], coarse[1, 0], coarse[2, 0], coarse[3, 0] = 3, 2, 2, 1
    assign = np.array([3, 1, 0, 2, 1, 3, 2, 0, 3, 3], np.int32)
    codes = np.zeros((10, n_sub), np.uint8)
    subs = np.zeros((n_sub, 256, d // n_sub), np.float32)
    q = np.zeros(d, np.float32)
    q[0] = 1.0
    book_j = JPQ.PQCodebook(jnp.asarray(coarse), jnp.asarray(subs),
                            jnp.asarray(assign), jnp.asarray(codes))
    book_t = TPQ.PQCodebook(_t(coarse), _t(subs), _t(assign).long(),
                            _t(codes))
    want = np.asarray(JPQ.pq_retrieve(book_j, jnp.asarray(q), 10, 2))
    got = TPQ.pq_retrieve(book_t, _t(q), 10, 2).numpy()
    np.testing.assert_array_equal(got, want)
    # cluster 0 (score 3), then clusters 1 and 2 (score 2) by index, then
    # cluster 3's keys, excluded, by index
    assert got.tolist() == [2, 7, 1, 3, 4, 6, 0, 5, 8, 9]
