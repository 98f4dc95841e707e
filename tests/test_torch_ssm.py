"""The state-space families' modules in the port against the reference, in
float32 on the same numpy inputs (CPU): mamba2-780m (``ssm``: SSD layers,
no attention, no FFN) and hymba-1.5b (``hybrid``: 0.5 · (ParisKV
attention + SSD) and an MLP), at smoke widths.

* ``segsum_exp``, ``ssd_chunked`` (chunks of 32 and one chunk) and
  ``ssd_recurrent_step`` within 1e-5; a length that is not a multiple of
  the chunk refused where the reference asserts;
* ``init_ssm``'s shapes, dtypes and constants (``A_log``, ``D``,
  ``dt_bias`` in float32);
* ``ssm_prefill`` on LEFT-aligned rows of unequal lengths (one shorter
  than the conv tail): output, final state and conv tail within 1e-5,
  the tail's rows exactly the reference's gather rule; ``ssm_decode`` one
  step within 1e-5;
* the reference's own check (``tests/test_substrate.py``) that a
  prefill's state continues as step-by-step ``ssm_decode`` does, on the
  port;
* ``layer_plan`` field for field, full and smoke; ``params_from_jax``
  and ``load_npz`` exact for both configs, each leaf in the tree's dtype;
* ``prefill`` and three ``decode_step``s of both smoke configs within
  1e-4 of the reference's, with and without LEFT-aligned lengths;
* teacher-forced decode against the reference's ``forward_train``
  logits, at the reference's bar (correlation > 0.98,
  ``tests/test_arch_smoke.py::test_decode_matches_forward``);
* the caches: the SSM state slot-local beside the pool (hymba) or alone
  (mamba2, no pool entry), every head on a head-sharded rank, copied by
  admission; the paged pool refusing mamba2."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores, and torch's
# spinning OpenMP pool would otherwise slow each of them many times over
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.ckpt.npz import save_checkpoint  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import serve as JSV  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import cache as TCC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import serve as TSV  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402

ARCHS = ("mamba2-780m", "hymba-1.5b")
BATCH, SEQ, N_MAX = 2, 64, 256
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))           # writable copy


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(JC.smoke(arch), dtype=dtype),
            dataclasses.replace(TC.smoke(arch), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype="float32", key=1):
    """The reference's smoke params (PRNGKey(``key``)) and the port's
    copies."""
    cfg_j, cfg_t = _cfgs(arch, dtype)
    pj = JM.init_params(cfg_j, jax.random.PRNGKey(key))
    return cfg_j, cfg_t, pj, convert.params_from_jax(jax.device_get(pj),
                                                     cfg_t, device="cpu")


@functools.lru_cache(maxsize=None)
def _mixer(key=0):
    """One float32 mamba2-smoke SSD mixer: the reference's params and the
    port's copies."""
    cfg_j, cfg_t = _cfgs("mamba2-780m")
    pj = JSSM.init_ssm(jax.random.PRNGKey(key), cfg_j, jnp.float32)
    return cfg_j, cfg_t, pj, {k: _t(v) for k, v in pj.items()}


def _ssd_inputs(l, seed=0, b=2, h=4, p=8, g=2, n=16):
    """Seeded SSD inputs, the shapes and scales of the reference's
    ``test_ssd_chunked_matches_recurrence``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, l, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, l, h) - 1)).astype(np.float32)
    A = (-np.exp(rng.randn(h) * 0.3)).astype(np.float32)
    B = (rng.randn(b, l, g, n) * 0.3).astype(np.float32)
    C = (rng.randn(b, l, g, n) * 0.3).astype(np.float32)
    return x, dt, A, B, C


def test_segsum_exp_matches_reference():
    a = -np.abs(np.random.RandomState(0).randn(2, 3, 32)).astype(np.float32)
    got = TSSM.segsum_exp(_t(a)).numpy()
    want = np.asarray(JSSM.segsum_exp(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, **TOL)
    assert (np.triu(got[0, 0], 1) == 0).all() and np.isfinite(got).all()


@pytest.mark.parametrize("l,chunk", [(64, 32), (96, 96)])
def test_ssd_chunked_matches_reference(l, chunk):
    """Chunks of 32 (the inter-chunk recurrence runs) and one chunk."""
    args = _ssd_inputs(l, seed=l)
    y_j, s_j = JSSM.ssd_chunked(*(jnp.asarray(a) for a in args), chunk)
    y_t, s_t = TSSM.ssd_chunked(*(_t(a) for a in args), chunk)
    assert y_t.shape == (2, l, 4, 8) and s_t.shape == (2, 4, 8, 16)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)


def test_ssd_chunked_refuses_a_partial_chunk():
    """The reference asserts ``l % chunk == 0``; the port raises there."""
    args = _ssd_inputs(48)
    with pytest.raises(AssertionError):
        JSSM.ssd_chunked(*(jnp.asarray(a) for a in args), 32)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        TSSM.ssd_chunked(*(_t(a) for a in args), 32)


def test_ssd_recurrent_step_matches_reference():
    x, dt, A, B, C = _ssd_inputs(1, seed=5)
    state = np.random.RandomState(6).randn(2, 4, 8, 16).astype(np.float32)
    args = (state, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    y_j, s_j = JSSM.ssd_recurrent_step(*(jnp.asarray(a) for a in args))
    y_t, s_t = TSSM.ssd_recurrent_step(*(_t(a) for a in args))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_ssm_matches_reference_layout(arch):
    """Every leaf's shape and dtype as the reference's (bf16 config), and
    the float32 constants equal (``A_log`` to float32 rounding)."""
    cfg = TC.smoke(arch)
    gen = torch.Generator().manual_seed(0)
    got = TSSM.init_ssm(cfg, torch.bfloat16, "cpu", gen)
    want = JSSM.init_ssm(jax.random.PRNGKey(0), JC.smoke(arch),
                         jnp.bfloat16)
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    for k in ("D", "dt_bias", "conv_b", "out_norm"):
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))
    np.testing.assert_allclose(got["A_log"].numpy(),
                               np.asarray(want["A_log"]), rtol=1e-6)
    assert 0.05 < float(got["conv_w"].float().std()) < 0.15


def test_ssm_prefill_left_aligned_matches_reference():
    """LEFT-aligned rows of 64, 37 and 2 tokens (the last shorter than
    the conv tail, whose head is then the convolution's zero padding):
    the output, the final state and the conv tail within 1e-5, the tail
    exactly the reference's gather rule over the port's own inputs, and
    one ``ssm_decode`` step from that cache within 1e-5."""
    cfg_j, cfg_t, pj, pt = _mixer()
    rng = np.random.RandomState(1)
    x = (rng.randn(3, SEQ, cfg_t.d_model) * 0.1).astype(np.float32)
    lens = np.array([SEQ, 37, 2], np.int32)
    valid = np.arange(SEQ)[None] < lens[:, None]
    y_j, c_j = JSSM.ssm_prefill(pj, jnp.asarray(x), cfg_j, chunk=32,
                                token_valid=jnp.asarray(valid),
                                lengths=jnp.asarray(lens))
    y_t, c_t = TSSM.ssm_prefill(pt, _t(x), cfg_t, chunk=32,
                                token_valid=_t(valid), lengths=_t(lens))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(c_t.state.numpy(), np.asarray(c_j.state),
                               **TOL)
    np.testing.assert_allclose(c_t.conv_buf.numpy(),
                               np.asarray(c_j.conv_buf), **TOL)
    # the tail's rows exactly: the reference's gather rule (each row's
    # last k - 1 real positions, zero before the prompt) applied in numpy
    # to the port's own pre-convolution inputs (a matmul away from x, so
    # equal to the reference's only within rounding)
    xBC = TSSM._split_in(cfg_t, _t(x) @ pt["w_in"])[1].numpy()
    k = cfg_t.ssm_conv_width
    idx = lens[:, None] - (k - 1) + np.arange(k - 1)[None]
    want = np.where((idx >= 0)[..., None],
                    xBC[np.arange(3)[:, None], np.clip(idx, 0, None)], 0)
    np.testing.assert_array_equal(c_t.conv_buf.numpy(), want)
    assert (c_t.conv_buf[2, 0] == 0).all() and (c_t.conv_buf[2, 1] != 0).any()
    x1 = (rng.randn(3, cfg_t.d_model) * 0.1).astype(np.float32)
    o_j, n_j = JSSM.ssm_decode(pj, jnp.asarray(x1), c_j, cfg_j)
    o_t, n_t = TSSM.ssm_decode(pt, _t(x1), c_t, cfg_t)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(n_t.state.numpy(), np.asarray(n_j.state),
                               **TOL)
    np.testing.assert_array_equal(n_t.conv_buf[:, :-1].numpy(),
                                  c_t.conv_buf[:, 1:].numpy())
    np.testing.assert_allclose(n_t.conv_buf.numpy(),
                               np.asarray(n_j.conv_buf), **TOL)


def test_ssm_prefill_matches_decode_continuation():
    """The reference's ``test_ssm_prefill_matches_decode_continuation`` on
    the port: the prefill's state equals the state of 64 ``ssm_decode``
    steps over the same inputs, and the last step's output the prefill's
    last, at the reference's bar."""
    _, cfg, _, p = _mixer()
    x = torch.from_numpy(
        (np.random.RandomState(2).randn(2, SEQ, cfg.d_model) * 0.1
         ).astype(np.float32))
    y_full, pre = TSSM.ssm_prefill(p, x, cfg, chunk=32)
    cache = TSSM.init_ssm_cache(2, cfg, torch.float32, "cpu")
    for t in range(SEQ):
        y_t, cache = TSSM.ssm_decode(p, x[:, t], cache, cfg)
    np.testing.assert_allclose(cache.state.numpy(), pre.state.numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(y_t.numpy(), y_full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(cache.conv_buf.numpy(),
                                  pre.conv_buf.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_plan_matches_reference(arch):
    """Stages, repeats and every LayerDef field, full and smoke; only MLA
    stays refused, naming ROADMAP A13.6."""
    for cfg_j, cfg_t in ((JC.get(arch), TC.get(arch)),
                         (JC.smoke(arch), TC.smoke(arch))):
        plan_j, plan_t = JM.layer_plan(cfg_j), TM.layer_plan(cfg_t)
        assert [(s.repeat, len(s.layers)) for s in plan_t] == \
            [(s.repeat, len(s.layers)) for s in plan_j]
        for sj, st in zip(plan_j, plan_t):
            for lj, lt in zip(sj.layers, st.layers):
                assert dataclasses.asdict(lt) == dataclasses.asdict(lj)
    (st,) = TM.layer_plan(TC.get(arch))
    (ld,) = st.layers
    if arch == "mamba2-780m":
        assert (st.repeat, ld.mixer, ld.ffn, ld.attn) == (48, "ssm", "none",
                                                          None)
    else:
        assert (st.repeat, ld.mixer, ld.ffn, ld.d_ff) == (32, "hybrid",
                                                          "mlp", 5504)
        assert ld.use_pariskv and ld.attn.num_kv_heads == 5


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("route", ["params_from_jax", "load_npz"])
def test_convert_carries_ssm_params(route, tmp_path):
    """bfloat16 smoke trees of both configs: every leaf of the port's
    params equals the reference's slice exactly, in its dtype (``A_log``,
    ``D`` and ``dt_bias`` float32, the rest bfloat16); a mamba2 layer has
    no attention and no ``norm_mlp``."""
    for arch in ARCHS:
        cfg_j, cfg_t, pj, _ = _params(arch, "bfloat16", key=0)
        if route == "params_from_jax":
            pt = convert.params_from_jax(jax.device_get(pj), cfg_t,
                                         device="cpu")
        else:
            path = str(tmp_path / f"{arch}.npz")
            save_checkpoint(path, pj)
            pt = convert.load_npz(path, cfg_t, device="cpu")
        assert len(pt["layers"]) == cfg_t.num_layers
        for r, got in enumerate(pt["layers"]):
            want = dict(_leaves(jax.device_get(jax.tree.map(
                lambda a: a[r], pj["stages"][0]["l0"]))))
            got = dict(_leaves(got))
            assert set(got) == set(want)
            for path_, w in want.items():
                g = got[path_]
                assert tuple(g.shape) == w.shape, path_
                f32 = path_[-1] in ("A_log", "D", "dt_bias")
                assert g.dtype == (torch.float32 if f32 else
                                   torch.bfloat16), path_
                np.testing.assert_array_equal(g.float().numpy(),
                                              np.asarray(w, np.float32))
            keys = {p[0] for p in got}
            assert keys == ({"norm_attn", "ssm"} if arch == "mamba2-780m"
                            else {"norm_attn", "attn", "ssm", "norm_mlp",
                                  "mlp"})


@functools.lru_cache(maxsize=None)
def _prefills(arch, left_aligned):
    """Both packages' prefill of the same seeded batch (LEFT-aligned rows
    of 64 and 41 tokens, or every row full) and three greedy decode steps
    → ([(reference logits, port logits)] × 4, port state)."""
    cfg_j, cfg_t, pj, pt = _params(arch)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg_t.vocab_size, (BATCH, SEQ)).astype(np.int32)
    lens = np.array([SEQ, 41], np.int32) if left_aligned else None
    lj, sj = JSV.prefill(pj, cfg_j, jnp.asarray(toks), N_MAX,
                         lengths=None if lens is None else jnp.asarray(lens))
    lt, st = TSV.prefill(pt, cfg_t, toks, N_MAX, lengths=lens, device="cpu")
    out = [(np.asarray(lj), lt.numpy())]
    tj = jnp.argmax(lj, -1).astype(jnp.int32)
    tt = lt.argmax(-1).to(torch.int32)
    for _ in range(3):
        lj, sj = JSV.decode_step(pj, cfg_j, tj, sj)
        lt, st = TSV.decode_step(pt, cfg_t, tt, st)
        out.append((np.asarray(lj), lt.numpy()))
        tj = jnp.argmax(lj, -1).astype(jnp.int32)
        tt = lt.argmax(-1).to(torch.int32)
    return out, st


@pytest.mark.parametrize("left_aligned", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_matches_reference(arch, left_aligned):
    """The reference's ``test_prefill_and_decode`` on both packages: the
    prefill's logits and three decode steps' within 1e-4, their greedy
    tokens equal, finite; with LEFT-aligned rows the short row's pads are
    skipped by the recurrence on both sides."""
    steps, st = _prefills(arch, left_aligned)
    for want, got in steps:
        assert got.shape == (BATCH, TC.smoke(arch).vocab_size)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    last = [SEQ - 1, 40] if left_aligned else [SEQ - 1] * 2
    np.testing.assert_array_equal(st.regions.pos.numpy(),
                                  np.asarray(last) + 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_train(arch):
    """The reference's ``test_decode_matches_forward`` across packages:
    the port's prefill of 40 tokens, then teacher-forced decode steps to
    48, against the reference's ``forward_train`` logits at the same
    positions (correlation > 0.98, the reference's bar) with the same
    greedy tokens."""
    cfg_j, cfg_t, pj, pt = _params(arch, key=2)
    toks = np.random.RandomState(2).randint(
        0, cfg_t.vocab_size, (BATCH, 48)).astype(np.int32)
    full, _ = JM.forward_train(pj, cfg_j, jnp.asarray(toks), remat=False)
    full = np.asarray(full)
    _, st = TSV.prefill(pt, cfg_t, toks[:, :40], N_MAX, device="cpu")
    for t in range(40, 48):
        got, st = TSV.decode_step(pt, cfg_t, torch.from_numpy(toks[:, t]),
                                  st)
        corr = np.corrcoef(got.numpy().ravel(), full[:, t].ravel())[0, 1]
        assert corr > 0.98, (t, corr)
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      full[:, t].argmax(-1))


def test_caches_keep_ssm_state_slot_local():
    """hymba: each entry holds its pool, its histogram and the SSM state
    (float32 state, conv tail in the config's dtype), every entry a pool
    entry; on a head-sharded rank the pool holds half the KV heads and the
    SSM every head. mamba2: an entry holds the state alone, no entry is a
    pool entry, and the paged pool refuses the config as
    ``UnsupportedPagedConfig`` naming stage 0, layer 0, mixer 'ssm'.
    Admission copies a prefill's state and tail into the slot's row."""
    hy = dataclasses.replace(TC.smoke("hymba-1.5b"), num_heads=4,
                             num_kv_heads=2, d_model=256)
    ma = TC.smoke("mamba2-780m")

    class Half:
        shards = 2

    caches = TSV.make_paged_caches(hy, 2, 8, 32, "cpu", num_device_blocks=4,
                                   dist=Half)
    assert TSV.pool_layers(hy) == [True, True]
    assert [set(lc) for lc in caches] == [{"kv", "hist", "fetch", "ssm"}] * 2
    assert TSV.pool_entries(caches) == caches
    assert caches[0]["kv"].k.shape[2] == 1                    # half the heads
    ssm = caches[0]["ssm"]
    assert ssm.state.shape == (2, 8, 64, 16) and ssm.state.dtype == \
        torch.float32
    assert ssm.conv_buf.shape == (2, 3, 512 + 32)
    assert ssm.conv_buf.dtype == torch.bfloat16

    mc = TSV.make_caches(ma, 2, 64, "cpu")
    assert [set(lc) for lc in mc] == [{"ssm"}] * ma.num_layers
    assert TSV.pool_entries(mc) == [] and TSV._store(mc) is None
    assert TSV.pool_layers(ma) == [False] * ma.num_layers
    with pytest.raises(TSV.UnsupportedPagedConfig) as err:
        TSV.make_paged_caches(ma, 2, 8, 32, "cpu")
    assert (err.value.stage, err.value.layer, err.value.mixer) == (0, 0,
                                                                   "ssm")
    assert "no ParisKV attention layer to page" in str(err.value)
    assert TSV.offload_support_reason(ma) == \
        TSV.sharded_support_reason(ma) == str(err.value)
    assert TSV.offload_support_reason(hy) is None
    assert TSV.sharded_support_reason(hy) is None

    regions = TCC.CacheRegions(torch.tensor([19], dtype=torch.int32),
                               torch.tensor([0], dtype=torch.int32))
    one = TSV.make_caches(ma, 1, 64, "cpu")
    for t in one[1]["ssm"]:
        t.copy_(torch.randn(t.shape))
    slot = TSV.init_slot_state(ma, 2, 64, device="cpu")
    TSV.admit_slot(slot, 1, one, regions, 3, 4)
    for big, small in zip(slot.caches[1]["ssm"], one[1]["ssm"]):
        np.testing.assert_array_equal(big[1].float().numpy(),
                                      small[0].float().numpy())
        assert (big[0] == 0).all()
    st = TSV.init_paged_slot_state(hy, 2, 8, 32, device="cpu", n_max=64)
    one = TSV.make_caches(hy, 1, 64, "cpu")
    for t in one[0]["ssm"]:
        t.copy_(torch.randn(t.shape))
    TSV.admit_paged(st, 0, torch.full((2,), 8, dtype=torch.int32), one,
                    regions, 3, 4, hy.pariskv)
    for big, small in zip(st.caches[0]["ssm"], one[0]["ssm"]):
        np.testing.assert_array_equal(big[0].float().numpy(),
                                      small[0].float().numpy())
        assert (big[1] == 0).all()
