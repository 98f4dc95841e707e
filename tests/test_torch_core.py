"""PyTorch port vs the JAX reference: configs, rotation, centroids,
quantizer and key/query encoding on the same numpy inputs (CPU, float32).

Integer outputs (signs, levels, centroid ids, 4-bit codes, histograms,
tier weights) must be bit-identical; float outputs agree to float32
rounding (tolerances stated per assertion)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core import centroids as Jcent  # noqa: E402
from repro.core import encode as JE  # noqa: E402
from repro.core import quantizer as JQ  # noqa: E402
from repro.core import retrieval as JR  # noqa: E402
from repro.core import srht as JS  # noqa: E402
from repro.core.config import ParisKVConfig as JP  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import centroids as Tcent  # noqa: E402
from repro_torch.core import encode as TE  # noqa: E402
from repro_torch.core import quantizer as TQ  # noqa: E402
from repro_torch.core import retrieval as TR  # noqa: E402
from repro_torch.core import srht as TS  # noqa: E402
from repro_torch.core.config import ParisKVConfig as TP  # noqa: E402
from repro_torch.kernels.collision.ref import bucket_histogram  # noqa: E402

CFG_J, CFG_T = JP(), TP()
D = 64


def _signs(dim=D):
    return (jnp.asarray(JS.rademacher_signs(dim, CFG_J.srht_seed)),
            torch.from_numpy(TS.rademacher_signs(dim, CFG_T.srht_seed)))


@pytest.mark.parametrize("name", TC.ARCHS)
def test_configs_equal_field_for_field(name):
    for getter in ("get", "smoke"):
        want = dataclasses.asdict(getattr(JC, getter)(name))
        got = dataclasses.asdict(getattr(TC, getter)(name))
        assert got == want, getter
    assert dataclasses.asdict(TP()) == dataclasses.asdict(JP())


def test_unported_arch_raises_with_roadmap_item():
    with pytest.raises(NotImplementedError, match="A13"):
        TC.get("mamba2-370m")


@pytest.mark.parametrize("dim,seed", [(64, CFG_J.srht_seed), (128, 7),
                                      (256, 0x7FFFFFFF + 5)])
def test_rademacher_signs_bit_for_bit(dim, seed):
    np.testing.assert_array_equal(TS.rademacher_signs(dim, seed),
                                  JS.rademacher_signs(dim, seed))


@pytest.mark.parametrize("m,bits", [(8, 3), (4, 3), (8, 2)])
def test_lloyd_max_levels_bit_for_bit(m, bits):
    for got, want in zip(TQ.lloyd_max_levels(m, bits),
                         JQ.lloyd_max_levels(m, bits)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_fwht_and_rotation_match():
    x = np.random.RandomState(0).randn(5, 3, 48).astype(np.float32)
    sj, st = _signs()
    # float32 butterflies in the same order: equal to rounding (atol 1e-5)
    np.testing.assert_allclose(
        TS.fwht(torch.from_numpy(x[..., :32])).numpy(),
        np.asarray(JS.fwht(jnp.asarray(x[..., :32]))), atol=1e-5)
    np.testing.assert_allclose(
        TS.srht_rotate(torch.from_numpy(x), st).numpy(),
        np.asarray(JS.srht_rotate(jnp.asarray(x), sj)), atol=1e-6)
    with pytest.raises(ValueError):
        TS.fwht(torch.zeros(3, 6))


def test_quantizer_codes_exact():
    rng = np.random.RandomState(1)
    u = rng.randn(200, 8, 8).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    u[0, 0, :4] = 0.0                          # sign ties at exactly zero
    np.testing.assert_array_equal(
        TQ.quantize_magnitudes(torch.from_numpy(np.abs(u)), 8).numpy(),
        np.asarray(JQ.quantize_magnitudes(jnp.asarray(np.abs(u)), 8)))
    got = TQ.encode_directions(torch.from_numpy(u), 8)
    want = np.asarray(JQ.encode_directions(jnp.asarray(u), 8))
    assert got.dtype == torch.int32
    # int32 bit patterns of the reference's uint32 words; bit 31 (nibble
    # 7's sign) is exercised
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    assert (got < 0).any()
    np.testing.assert_array_equal(
        TQ.decode_directions(got, 8).numpy(),
        np.asarray(JQ.decode_directions(jnp.asarray(want), 8)))


def test_centroid_assignment_and_scores():
    rng = np.random.RandomState(2)
    u = rng.randn(100, 16, 8).astype(np.float32)
    u[3, 2, 5] = 0.0
    np.testing.assert_array_equal(
        Tcent.assign(torch.from_numpy(u)).numpy(),
        np.asarray(Jcent.assign(jnp.asarray(u))))
    np.testing.assert_array_equal(Tcent.codebook(8), Jcent.codebook(8)
                                  .astype(np.float32))
    q = rng.randn(2, 3, 16, 8).astype(np.float32)
    np.testing.assert_allclose(
        Tcent.centroid_scores(torch.from_numpy(q), 8).numpy(),
        np.asarray(Jcent.centroid_scores(jnp.asarray(q), 8)), atol=1e-6)


def test_encode_keys_and_query():
    rng = np.random.RandomState(3)
    k = (rng.randn(2, 3, 150, D) * np.linspace(2.0, 0.2, D)).astype(
        np.float32)
    sj, st = _signs()
    mj = JE.encode_keys(jnp.asarray(k), CFG_J, sj)
    mt = TE.encode_keys(torch.from_numpy(k), CFG_T, st)
    np.testing.assert_array_equal(mt.centroid_ids.numpy(),
                                  np.asarray(mj.centroid_ids))
    np.testing.assert_array_equal(mt.codes.numpy(),
                                  np.asarray(mj.codes).view(np.int32))
    # weights ‖k‖·r/α in float32: a few ulps apart (rtol 1e-5)
    np.testing.assert_allclose(mt.weights.numpy(), np.asarray(mj.weights),
                               rtol=1e-5)
    q = rng.randn(2, 3, 4, D).astype(np.float32)
    qj = JE.encode_query(jnp.asarray(q), CFG_J, sj)
    qt = TE.encode_query(torch.from_numpy(q), CFG_T, st)
    np.testing.assert_allclose(qt.q_norm.numpy(), np.asarray(qj.q_norm),
                               rtol=1e-6)
    np.testing.assert_allclose(qt.q_sub.numpy(), np.asarray(qj.q_sub),
                               atol=1e-6)


def test_bucket_histogram_and_tier_weights_exact():
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 256, size=(2, 3, 300, 8)).astype(np.uint8)
    valid = rng.rand(2, 3, 300) < 0.7
    hj = np.asarray(JR.bucket_histogram(jnp.asarray(ids), jnp.asarray(valid),
                                        256))
    ht = bucket_histogram(torch.from_numpy(ids), torch.from_numpy(valid), 256)
    np.testing.assert_array_equal(ht.numpy(), hj)
    # tier tables from identical proxy scores (with exact ties, which the
    # stable argsort must order like the reference) and counts
    cs = np.round(rng.randn(2, 3, 4, 8, 256), 1).astype(np.float32)
    n_valid = valid.sum(-1)[..., None].astype(np.int32)
    want = JR.tier_weight_table(jnp.asarray(cs), jnp.asarray(hj)[:, :, None],
                                jnp.asarray(n_valid), CFG_J)
    got = TR.tier_weight_table(torch.from_numpy(cs),
                               torch.from_numpy(hj.copy())[:, :, None],
                               torch.from_numpy(n_valid), CFG_T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(np.asarray(want))) == 7   # every tier + 0 occurs
