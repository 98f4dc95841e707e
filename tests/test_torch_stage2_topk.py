"""Stage II with its top-k, and the one-launch decode gather, against the
JAX reference.

On the CPU ``rerank_topk_paged`` takes its plain version: the candidates'
physical rows through the block table, the rerank, ``lax.top_k``'s
selection (the float's total order, so +0.0 ranks above -0.0; ties to the
lowest candidate slot) and the winners' block-table lookup. The reference
runs ``rerank_paged`` (the jnp twin of the Pallas rerank) and
``jax.lax.top_k`` at the same batch shape. Estimates agree to float32
reassociation (rtol 1e-5, atol 1e-5); winners, physical rows and blocks
exactly, also on constructed ties: equal estimates across slots, signed
zeros, rows with fewer valid candidates than k, -1 table entries.

``gather_decode_paged`` takes the two plain paged gathers, which must give
the reference's ``paged_gather_rows`` and ``gather_heads_physical`` bit
for bit. ``tests/test_torch_cuda.py`` holds both kernels against these
plain versions on the card."""
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
from repro_torch.kernels.gather_kv import gather_decode_paged  # noqa: E402
from repro_torch.kernels.gather_kv.ref import (  # noqa: E402
    gather_heads_physical_ref, gather_rows_paged_ref)
from repro_torch.kernels.rerank import rerank_topk_paged  # noqa: E402
from repro_torch.kernels.rerank.ref import topk_ref  # noqa: E402

CFG = JP(sink_size=16, local_size=64, update_interval=32, top_k=16,
         min_candidates=64)
D, G, HG, NB, BS = 64, 2, 2, 12, 32
B = CFG.num_subspaces(D)
C, K = 48, 16
# the short row's invalid positions: below the sink, and past its region end
SHORT_INVALID = np.r_[:CFG.sink_size, CFG.sink_size + 6:128]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pool(rng):
    keys = rng.randn(NB, G, BS, D).astype(np.float32)
    signs = jnp.asarray(JS.rademacher_signs(D, CFG.srht_seed))
    meta = JE.encode_keys(jnp.asarray(keys), CFG, signs)
    return np.array(meta.codes), np.array(meta.weights)


def _case(name, seed=0):
    """Pool codes and weights, block tables, candidates, queries and region
    ends for one constructed case (b = 2 rows, 4 logical blocks each)."""
    rng = np.random.RandomState(seed)
    codes, w = _pool(rng)
    bt = np.array([[5, 1, 10, 3], [2, 8, 0, 7]], np.int32)
    enc_end = np.array([120, 110], np.int32)
    cand = np.stack([rng.choice(128, C, replace=False) for _ in
                     range(2 * G * HG)]).reshape(2, G, HG, C).astype(np.int32)
    q_sub = rng.randn(2, G, HG, B, 8).astype(np.float32)
    q_norm = (np.abs(rng.randn(2, G, HG)) + 0.5).astype(np.float32)
    if name == "equal_estimates":
        # blocks 1 and 10 hold copies of block 5's rows: every candidate of
        # logical block 1 or 2 of row 0 ties with its twin in block 0
        codes[[1, 10]] = codes[5]
        w[[1, 10]] = w[5]
    elif name == "signed_zeros":
        # |q| = 0: each estimate is +0.0 or -0.0 by the sign of its sum
        q_norm[:] = 0.0
    elif name == "short_rows":
        # row 1 holds 6 valid positions, fewer than k, at slots 10..15:
        # -1e30 ties fill in from the lowest slots
        enc_end[1] = CFG.sink_size + 6
        cand[1] = np.r_[SHORT_INVALID[:10], CFG.sink_size:CFG.sink_size + 6,
                        SHORT_INVALID[10:C - 6]]
    elif name == "unallocated":
        # -1 entries read block 0 (the clip of the reference's twins)
        bt[1, 2:] = -1
    return codes, w, bt, cand, q_sub, q_norm, enc_end


def _reference(codes, w, bt, cand, q_sub, q_norm, enc_end):
    qt = JE.QueryTransform(jnp.asarray(q_norm), jnp.asarray(q_sub))
    btj, cj = jnp.asarray(bt), jnp.asarray(cand)
    _, _, cand_phys = JR._block_relative(cj, btj, BS)
    est = JR.rerank_paged(jnp.asarray(codes), jnp.asarray(w), cand_phys, cj,
                          qt, jnp.asarray(enc_end), CFG)
    top_est, top_pos = jax.lax.top_k(est, K)
    top_idx = jnp.take_along_axis(cj, top_pos, axis=-1)
    blk, _, phys = JR._block_relative(top_idx, btj, BS)
    return [np.asarray(a) for a in (top_est, top_idx, phys, blk, est)]


@pytest.mark.parametrize("name", ["random", "equal_estimates", "signed_zeros",
                                  "short_rows", "unallocated"])
def test_rerank_topk_plain_matches_reference(name):
    codes, w, bt, cand, q_sub, q_norm, enc_end = _case(name)
    got = rerank_topk_paged(_t(codes.view(np.int32)), _t(w), _t(bt),
                            _t(cand), _t(q_sub), _t(q_norm), _t(enc_end),
                            CFG.sink_size, K, 8, 3)
    top_est, top_idx, phys, blk, est = _reference(codes, w, bt, cand, q_sub,
                                                  q_norm, enc_end)
    np.testing.assert_allclose(got.est.numpy(), est, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.top_est.numpy(), top_est, rtol=1e-5,
                               atol=1e-5)
    for field, want in (("top_idx", top_idx), ("phys_rows", phys),
                        ("block_ids", blk)):
        out = getattr(got, field)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), want, err_msg=field)
    # each case builds what its name says
    if name == "equal_estimates":
        assert (np.diff(top_est, axis=-1) == 0).any()
    elif name == "signed_zeros":
        bits = np.signbit(top_est[..., :-1]) & ~np.signbit(top_est[..., 1:])
        assert (top_est == 0).all() and not bits.any()
        assert np.signbit(est).any() and (~np.signbit(est)).any()
    elif name == "short_rows":
        assert ((top_est[1] == -1e30).sum(-1) == K - 6).all()
        np.testing.assert_array_equal(top_idx[1, ..., 6:], np.broadcast_to(
            SHORT_INVALID[:K - 6], (G, HG, K - 6)))
    elif name == "unallocated":
        assert (bt[1][top_idx[1] // BS] < 0).any()


def test_topk_order_is_lax_top_k():
    """The plain selection follows ``lax.top_k`` exactly, where a stable
    sort of the floats would not: +0.0 above -0.0, equal values and -1e30
    fill in slot order."""
    rng = np.random.RandomState(4)
    est = rng.choice(np.array([0.0, -0.0, 1.5, -1.5, -1e30], np.float32),
                     size=(6, 40))
    est[0] = -0.0
    est[1, ::3] = 0.0
    vals, pos = topk_ref(_t(est), 25)
    want_v, want_p = jax.lax.top_k(jnp.asarray(est), 25)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(np.signbit(vals.numpy()),
                                  np.signbit(np.asarray(want_v)))
    stable = torch.sort(_t(est), dim=-1, descending=True,
                        stable=True).indices
    assert not torch.equal(stable[..., :25], pos)


@pytest.mark.parametrize("winners", [True, False])
def test_decode_gather_plain_matches_reference(winners):
    """Sink rows, window rows through the table (reaching -1 entries) and
    winner head rows in one call equal the two plain gathers and the
    reference's jnp gathers, bit for bit."""
    rng = np.random.RandomState(5)
    pool = rng.randn(2, NB, BS, G, D).astype(np.float32)
    bt = np.array([[5, 1, 10, 3], [2, 8, -1, -1]], np.int32)
    ws = np.array([70, 40], np.int32)
    sink, W = 16, 40
    phys = rng.randint(0, NB * BS, size=(2, G, HG, 9)).astype(np.int32)
    out = gather_decode_paged(_t(pool[0]), _t(pool[1]), _t(bt), _t(ws), sink,
                              W, _t(phys) if winners else None)
    lidx = np.concatenate([np.broadcast_to(np.arange(sink), (2, sink)),
                           ws[:, None] + np.arange(W)], 1).astype(np.int32)
    for got, p in zip(out[:2], pool):
        np.testing.assert_array_equal(
            got.numpy(),
            gather_rows_paged_ref(_t(p), _t(bt), _t(lidx)).numpy())
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JCC.paged_gather_rows(
                jnp.asarray(p), jnp.asarray(bt), jnp.asarray(lidx))))
    if not winners:
        assert out[2] is None and out[3] is None
        return
    for got, p in zip(out[2:], pool):
        np.testing.assert_array_equal(
            got.numpy(), gather_heads_physical_ref(_t(p), _t(phys)).numpy())
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JCC.gather_heads_physical(
                jnp.asarray(p), jnp.asarray(phys))))
