"""deepseek-v2-lite's multi-head latent attention (``models/mla.py``) in
the port against the reference, in float32 on the same numpy inputs (CPU):

* ``init_mla``: the reference's leaves, shapes and dtypes;
* ``_latent_kv`` and ``mla_train`` (the decompressed prefill) within 1e-5;
* ``mla_prefill_cache``: the latent within 1e-5, ids and codes exact,
  weights within 1e-6 relative;
* ``mla_promote_rows`` on a masked batch: the promoted row's metadata
  exact, the other row's untouched;
* ``mla_decode`` (the absorbed form with latent-space retrieval) within
  1e-4, the latent it writes within 1e-5, the winner sets the
  reference's ``retrieve`` over the same latent's;
* the reference's ``test_mla_decode_matches_train_logits`` on the port
  (the dense absorbed decode against the decompressed forward);
* ``params_from_jax`` and ``load_npz`` exact, both stages, every leaf in
  the reference tree's dtype (the router float32);
* ``layer_plan`` and the configs field for field; ``prefill`` and decode
  steps through every layer within 1e-4 of the reference's;
* the widened plain versions at deepseek-v2-lite's retrieval shapes (one
  576-wide latent, B = 128 subspaces, Hg = 16 query heads, score range
  768, a few hundred keys): Stage I's scores and ``seg_hist`` over the
  16-lane tier table, the cut's index set, Stage II's estimates and
  top-k, ``bucket_count`` and the K-only decode gather, each against the
  reference's jnp ``collision_scores`` / ``select_candidates_bucket`` /
  ``rerank`` + ``lax.top_k`` / ``bucket_histogram`` and plain gathers,
  exact where integer."""
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
from repro.core import cache as JCC  # noqa: E402
from repro.core import encode as JE  # noqa: E402
from repro.core import retrieval as JR  # noqa: E402
from repro.core import srht as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import serve as JSV  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import cache as TCC  # noqa: E402
from repro_torch.core import encode as TE  # noqa: E402
from repro_torch.core import retrieval as TR  # noqa: E402
from repro_torch.kernels import SEG_LEN, row_tables  # noqa: E402
from repro_torch.kernels.collision import (bucket_count,  # noqa: E402
                                           lane_packed_table, table_lanes)
from repro_torch.kernels.gather_kv import gather_decode_paged  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import serve as TSV  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
B_, S_, N_MAX = 2, 40, 128
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))           # writable copy


def _jit(fn, *static):
    """The reference's ``fn`` compiled once, with the arguments at
    positions ``static`` (configs, sizes) static: JAX's op-by-op eager
    dispatch costs seconds a call at these shapes."""
    return jax.jit(fn, static_argnums=static)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(JC.smoke(ARCH), dtype=dtype),
            dataclasses.replace(TC.smoke(ARCH), dtype=dtype))


def _signs(cfg_j, cfg_t):
    dim = cfg_j.pariskv.padded_dim(cfg_j.retrieval_dim())
    return (jnp.asarray(JS.rademacher_signs(dim, cfg_j.pariskv.srht_seed)),
            TSV.rotation_signs(cfg_t, "cpu"))


@functools.lru_cache(maxsize=None)
def _layer(scale=4.0):
    """One float32 MLA layer of deepseek-smoke: the reference's params
    (×``scale``, so that scores spread) and the port's copies."""
    cfg_j, cfg_t = _cfgs()
    pj = jax.tree.map(lambda a: a * scale,
                      JMLA.init_mla(jax.random.PRNGKey(0), cfg_j,
                                    jnp.float32))
    return cfg_j, cfg_t, pj, {k: _t(v) for k, v in pj.items()}


def _x(shape, seed=1, scale=0.3):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _positions(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mla_layout_and_dtypes(dtype):
    cfg_j, cfg_t = _cfgs(dtype)
    want = JMLA.init_mla(jax.random.PRNGKey(0), cfg_j,
                         {"float32": jnp.float32,
                          "bfloat16": jnp.bfloat16}[dtype])
    got = TMLA.init_mla(cfg_t, TM.torch_dtype(cfg_t), "cpu",
                        torch.Generator().manual_seed(0))
    assert set(got) == set(want) == {"wq", "w_dkv", "kv_norm", "w_uk",
                                     "w_uv", "wo"}
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    assert torch.equal(got["kv_norm"], torch.ones_like(got["kv_norm"]))
    assert float(got["wq"].float().std()) > 0


def test_latent_kv_and_train_match_reference():
    cfg_j, cfg_t, pj, pt = _layer()
    x = _x((B_, S_, cfg_t.d_model))
    pos = _positions(B_, S_)
    c_j, kr_j = _jit(JMLA._latent_kv, 2)(pj, jnp.asarray(x), cfg_j,
                                         jnp.asarray(pos))
    c_t, kr_t = TMLA._latent_kv(pt, _t(x), cfg_t, _t(pos))
    assert c_t.shape == (B_, S_, cfg_t.kv_lora_rank)
    assert kr_t.shape == (B_, S_, cfg_t.rope_head_dim)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **TOL)
    np.testing.assert_allclose(kr_t.numpy(), np.asarray(kr_j), **TOL)
    y_j = _jit(JMLA.mla_train, 2)(pj, jnp.asarray(x), cfg_j,
                                  jnp.asarray(pos))
    y_t = TMLA.mla_train(pt, _t(x), cfg_t, _t(pos))
    assert y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)


@functools.lru_cache(maxsize=None)
def _prefilled():
    """Both packages' latent caches after ``mla_prefill_cache`` of the
    same seeded prompt (S_ positions of N_MAX)."""
    cfg_j, cfg_t, pj, pt = _layer()
    sj, st = _signs(cfg_j, cfg_t)
    x = _x((B_, S_, cfg_t.d_model), seed=2)
    pos = _positions(B_, S_)
    mj = _jit(JMLA.mla_prefill_cache, 3)(pj, jnp.asarray(x),
                                JMLA.init_mla_cache(B_, N_MAX, cfg_j,
                                                    jnp.float32),
                                cfg_j, jnp.asarray(pos), sj)
    mt = TMLA.mla_prefill_cache(pt, _t(x),
                                TMLA.init_mla_cache(B_, N_MAX, cfg_t,
                                                    torch.float32, "cpu"),
                                cfg_t, _t(pos), st)
    return mj, mt


def _clone(mt):
    return TMLA.MLACache(*(t.clone() for t in mt))


def _assert_cache_equal(mt, mj):
    np.testing.assert_allclose(mt.latent.numpy(), np.asarray(mj.latent),
                               **TOL)
    np.testing.assert_array_equal(mt.meta_ids.numpy(),
                                  np.asarray(mj.meta_ids))
    np.testing.assert_array_equal(mt.meta_codes.numpy(),
                                  np.asarray(mj.meta_codes).view(np.int32))
    np.testing.assert_allclose(mt.meta_w.numpy(), np.asarray(mj.meta_w),
                               rtol=1e-6, atol=0)


def test_prefill_cache_matches_reference():
    mj, mt = _prefilled()
    cfg = _cfgs()[1]
    B = cfg.pariskv.num_subspaces(cfg.retrieval_dim())
    assert mt.latent.shape == (B_, N_MAX, cfg.retrieval_dim())
    assert mt.meta_ids.shape == (B_, 1, N_MAX, B) == mj.meta_ids.shape
    _assert_cache_equal(mt, mj)
    assert mt.meta_w[:, :, :S_].abs().min() > 0
    assert not mt.meta_w[:, :, S_:].any()


def test_promote_rows_matches_reference_on_a_masked_batch():
    cfg_j, cfg_t = _cfgs()
    sj, st = _signs(cfg_j, cfg_t)
    mj, mt = _prefilled()
    starts = np.array([8, 20], np.int32)
    mask = np.array([True, False])
    # zero the blocks first, so that the promotion's writes show
    U = cfg_t.pariskv.update_interval
    mt0 = _clone(mt)
    for f in mt0[1:]:
        f[:, :, 8:8 + U] = 0
        f[:, :, 20:20 + U] = 0
    mj0 = JMLA.MLACache(mj.latent, *(jnp.asarray(f.numpy()) for f in mt0[1:]))
    mj0 = mj0._replace(meta_codes=jnp.asarray(
        mt0.meta_codes.numpy().view(np.uint32)))
    want = _jit(JMLA.mla_promote_rows, 3)(
        mj0, jnp.asarray(starts), jnp.asarray(mask), cfg_j.pariskv, sj)
    got = TMLA.mla_promote_rows(mt0, _t(starts), _t(mask), cfg_t.pariskv, st)
    _assert_cache_equal(got, want)
    # row 0 re-encoded [8, 8 + U) as its prefill did; row 1 untouched
    np.testing.assert_array_equal(got.meta_ids[0, :, 8:8 + U].numpy(),
                                  mt.meta_ids[0, :, 8:8 + U].numpy())
    assert not got.meta_ids[1, :, 20:20 + U].any()


def _reference_q_lat(pj, cfg, x_t, pos):
    """The reference's absorbed query of ``mla_decode`` (b, H, r + dr)."""
    b = x_t.shape[0]
    H, dn, dr, r = (cfg.num_heads, cfg.head_dim, cfg.rope_head_dim,
                    cfg.kv_lora_rank)
    q = (x_t @ pj["wq"]).reshape(b, H, dn + dr)
    q_r = JL.rope(q[..., dn:][:, None], pos[:, None], cfg.rope_theta)[:, 0]
    q_eff = jnp.einsum("bhd,rhd->bhr", q[..., :dn],
                       pj["w_uk"].reshape(r, H, dn))
    return jnp.concatenate([q_eff, q_r], -1)


@pytest.mark.parametrize("enc_end", [(24, 30), (8, 8)],
                         ids=["retrieval", "empty-region"])
def test_decode_matches_reference(enc_end):
    cfg_j, cfg_t, pj, pt = _layer()
    sj, st = _signs(cfg_j, cfg_t)
    mj, mt = _prefilled()
    mt = _clone(mt)
    x_t = _x((B_, cfg_t.d_model), seed=3)
    regions_j = JCC.CacheRegions(pos=jnp.array([S_ - 1, S_ - 5], jnp.int32),
                                 enc_end=jnp.array(enc_end, jnp.int32))
    regions_t = TCC.CacheRegions(*(_t(np.asarray(a)) for a in regions_j))
    C = cfg_t.pariskv.candidate_count(N_MAX)
    y_j, mj2 = _jit(JMLA.mla_decode, 4, 6)(pj, jnp.asarray(x_t), mj,
                                           regions_j, cfg_j, sj, C)
    y_t, res = TMLA.mla_decode(pt, _t(x_t), mt, regions_t, cfg_t, st, C)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)
    _assert_cache_equal(mt, mj2)
    # the winner sets: the reference's retrieve over the same latent
    pos = regions_j.pos + 1
    q_lat = _reference_q_lat(pj, cfg_j, jnp.asarray(x_t), pos)
    qt = _jit(JE.encode_query, 1)(q_lat[:, None], cfg_j.pariskv, sj)
    valid = JCC.retrieval_valid_mask(N_MAX, regions_j, cfg_j.pariskv)
    meta = JE.KeyMetadata(mj2.meta_ids, mj2.meta_codes, mj2.meta_w)
    want = _jit(JR.retrieve, 3, 4, 5)(
        jax.tree.map(lambda a: a[:, :, None], meta), qt,
        jnp.broadcast_to(valid[:, None, None, :], (B_, 1, 1, N_MAX)),
        cfg_j.pariskv, C, cfg_j.pariskv.top_k)
    got_idx, want_idx = res.indices.numpy(), np.asarray(want.indices)
    assert got_idx.shape == (B_, 1, cfg_t.num_heads, cfg_t.pariskv.top_k)
    for r in range(B_):
        if enc_end[r] > cfg_t.pariskv.sink_size:
            np.testing.assert_array_equal(np.sort(got_idx[r], -1),
                                          np.sort(want_idx[r], -1))


def test_mla_decode_matches_train_logits():
    """The reference's check on the port: the dense absorbed decode
    (``use_pariskv=False``) of the last position ≈ the decompressed
    forward's row, at the reference's tolerance."""
    cfg_j, cfg_t = _cfgs()
    sj, st = _signs(cfg_j, cfg_t)
    pt = {k: _t(v) for k, v in JMLA.init_mla(jax.random.PRNGKey(0), cfg_j,
                                             jnp.float32).items()}
    b, S = 2, 40
    x = _t(np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                        (b, S, cfg_t.d_model)) * 0.3))
    positions = torch.arange(S).expand(b, S)
    y_train = TMLA.mla_train(pt, x, cfg_t, positions)
    mc = TMLA.init_mla_cache(b, 128, cfg_t, torch.float32, "cpu")
    mc = TMLA.mla_prefill_cache(pt, x[:, :S - 1], mc, cfg_t,
                                positions[:, :S - 1], st)
    regions = TCC.CacheRegions(pos=torch.full((b,), S - 2, dtype=torch.int32),
                               enc_end=torch.zeros((b,), dtype=torch.int32))
    y_dec, res = TMLA.mla_decode(pt, x[:, S - 1], mc, regions, cfg_t, st,
                                 num_candidates=64, use_pariskv=False)
    assert res is None
    np.testing.assert_allclose(y_dec.numpy(), y_train[:, S - 1].numpy(),
                               rtol=2e-2, atol=2e-2)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("route", ["params_from_jax", "load_npz"])
def test_convert_carries_mla_params(route, tmp_path):
    """The bfloat16 smoke tree: both stages (the dense layer 0, then the
    MoE layers with a shared expert), every leaf of the port's params
    equal to the reference's slice in its dtype (the router float32)."""
    cfg_j, cfg_t = _cfgs("bfloat16")
    pj = _jit(JM.init_params, 0)(cfg_j, jax.random.PRNGKey(0))
    if route == "params_from_jax":
        pt = convert.params_from_jax(jax.device_get(pj), cfg_t, device="cpu")
    else:
        path = str(tmp_path / "deepseek.npz")
        save_checkpoint(path, pj)
        pt = convert.load_npz(path, cfg_t, device="cpu")
    assert len(pj["stages"]) == 2 and len(pt["layers"]) == cfg_t.num_layers
    places = [(0, 0)] + [(1, r) for r in range(cfg_t.num_layers - 1)]
    for (si, r), got in zip(places, pt["layers"]):
        want = dict(_leaves(jax.device_get(jax.tree.map(
            lambda a: a[r], pj["stages"][si]["l0"]))))
        got = dict(_leaves(got))
        assert set(got) == set(want)
        for key, w in want.items():
            g = got[key]
            assert tuple(g.shape) == w.shape, key
            f32 = key[-1] == "router"
            assert g.dtype == (torch.float32 if f32 else torch.bfloat16), key
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))
        assert {k[0] for k in got} == {"norm_attn", "attn", "norm_mlp",
                                       "mlp" if si == 0 else "moe"}
        assert {k[1] for k in got if k[0] == "attn"} == {
            "wq", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo"}
    assert "shared" in pt["layers"][1]["moe"]


def test_configs_and_layer_plan_match_reference():
    for getter in ("get", "smoke"):
        cfg_j, cfg_t = getattr(JC, getter)(ARCH), getattr(TC, getter)(ARCH)
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
        plan_j, plan_t = JM.layer_plan(cfg_j), TM.layer_plan(cfg_t)
        assert [(s.repeat, len(s.layers)) for s in plan_t] == \
            [(s.repeat, len(s.layers)) for s in plan_j]
        for sj, st in zip(plan_j, plan_t):
            for lj, lt in zip(sj.layers, st.layers):
                assert dataclasses.asdict(lt) == dataclasses.asdict(lj)
    dense, moe = TM.layer_plan(TC.get(ARCH))
    assert (dense.repeat, dense.layers[0].d_ff, dense.layers[0].ffn) == (
        1, 10_944, "mlp")
    assert (moe.repeat, moe.layers[0].d_ff, moe.layers[0].ffn) == (
        26, 1408, "moe")
    assert TSV.pool_layers(TC.get(ARCH)) == [False] * 27


@pytest.mark.parametrize("left_aligned", [False, True])
def test_prefill_and_decode_match_reference(left_aligned):
    """Both packages' ``prefill`` of one seeded batch (LEFT-aligned rows of
    64 and 41 tokens, or both full) and three greedy decode steps through
    every layer (the dense MLP layer and the MoE layers), within 1e-4;
    the caches hold an MLA entry per layer and no pool entry."""
    cfg_j, cfg_t = _cfgs()
    pj = jax.tree.map(lambda a: a * 4.0, _jit(JM.init_params, 0)(
        cfg_j, jax.random.PRNGKey(1)))
    pt = convert.params_from_jax(jax.device_get(pj), cfg_t, device="cpu")
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg_t.vocab_size, (2, 64)).astype(np.int32)
    lens = np.array([64, 41], np.int32) if left_aligned else None
    lj, sj = _jit(JSV.prefill, 1, 3)(
        pj, cfg_j, jnp.asarray(toks), N_MAX,
        lengths=None if lens is None else jnp.asarray(lens))
    lt, st = TSV.prefill(pt, cfg_t, toks, N_MAX, lengths=lens, device="cpu")
    assert all(TSV.is_mla(lc) and not TSV.is_pool(lc) for lc in st.caches)
    assert TSV.pool_entries(st.caches) == []
    for step in range(4):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(lj).max()))
        if step == 3:
            break
        tok = np.asarray(lj).argmax(-1).astype(np.int32)
        lj, sj = _jit(JSV.decode_step, 1)(pj, cfg_j, jnp.asarray(tok), sj)
        lt, st = TSV.decode_step(pt, cfg_t, _t(tok), st)


# ------------------------------------------ the widened plain versions ---
@functools.lru_cache(maxsize=None)
def _wide():
    """deepseek-v2-lite's retrieval shapes over a few hundred keys: two rows
    of n = 384 latent keys (576 wide, B = 128) and 16 query heads, the
    full config's ParisKV settings (sink 128, top-k 100)."""
    cfg_j, cfg_t = JC.get(ARCH), TC.get(ARCH)
    pcfg_j, pcfg_t = cfg_j.pariskv, cfg_t.pariskv
    sj, st = _signs(cfg_j, cfg_t)
    rng = np.random.RandomState(11)
    b, n, H, D = 2, 384, cfg_t.num_heads, cfg_t.retrieval_dim()
    lat = rng.randn(b, 1, n, D).astype(np.float32)
    q = (lat[:, :, rng.randint(0, n, H)] + 0.3 * rng.randn(b, 1, H, D)
         ).astype(np.float32)                              # (b, 1, H, D)
    mj = _jit(JE.encode_keys, 1)(jnp.asarray(lat), pcfg_j, sj)
    mt = TE.encode_keys(_t(lat), pcfg_t, st)
    qj = _jit(JE.encode_query, 1)(jnp.asarray(q), pcfg_j, sj)
    qt = TE.encode_query(_t(q), pcfg_t, st)
    enc = np.array([300, 384], np.int32)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, pj=pcfg_j, pt=pcfg_t, lat=lat,
                mj=mj, mt=mt, qj=qj, qt=qt, enc=enc, b=b, n=n, H=H)


def _valid(w):
    pos = np.arange(w["n"])
    return (pos[None] >= w["pt"].sink_size) & (pos[None] < w["enc"][:, None])


def test_wide_shapes_are_deepseeks():
    w = _wide()
    B = w["mt"].centroid_ids.shape[-1]
    rng_s = TR.max_collision_score(w["pt"], B)
    assert (B, w["H"], rng_s) == (128, 16, 768)
    assert w["pt"].candidate_count(16384) == 1311
    assert table_lanes(16, 128, rng_s) == 16
    assert table_lanes(6, 16, 96) == 8
    t16 = lane_packed_table(w["b"], 1, 16, 128, 256, "cpu", lanes=16)
    assert t16.shape == (w["b"], 1, 16, 128, 256)
    assert t16.stride()[2:] == (1, 256 * 16, 16)
    with pytest.raises(ValueError, match="8 lanes"):
        lane_packed_table(w["b"], 1, 16, 128, 256, "cpu")


def test_wide_bucket_count_matches_reference():
    w = _wide()
    nc = w["pt"].num_centroids()
    want = np.asarray(JR.bucket_histogram(
        w["mj"].centroid_ids, jnp.asarray(_valid(w))[:, None], nc))
    got = bucket_count(w["mt"].centroid_ids, _t(w["enc"]),
                       w["pt"].sink_size, nc)
    assert got.shape == (w["b"], 1, 128, nc)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wide_stage1_and_cut_match_reference():
    """Stage I over the 16-lane table (the layout the card's wide mode
    reads), its ``seg_hist`` and the cut, against the reference's jnp
    Stage I and bucket cut; scores span the range above 255."""
    w = _wide()
    pt, B = w["pt"], 128
    rng_s = TR.max_collision_score(pt, B)
    coarse, seg_hist = TR.collision_scores_hist(
        w["mt"].centroid_ids, w["qt"].q_sub, _t(w["enc"]), pt)
    valid = jnp.asarray(_valid(w))[:, None, None, :]
    want = np.asarray(_jit(JR.collision_scores, 3)(
        w["mj"].centroid_ids[:, :, None], w["qj"].q_sub, valid, w["pj"]))
    assert coarse.shape == (w["b"], 1, w["H"], w["n"])
    np.testing.assert_array_equal(coarse.numpy(), want)
    assert 255 < int(coarse.max()) <= rng_s
    assert seg_hist.shape == (w["b"], 1, w["H"], -(-w["n"] // SEG_LEN),
                              rng_s + 2)
    for j in range(seg_hist.shape[3]):
        seg = want[..., j * SEG_LEN:(j + 1) * SEG_LEN] + 1
        np.testing.assert_array_equal(
            seg_hist[..., j, :].numpy(),
            np.apply_along_axis(np.bincount, -1, seg, minlength=rng_s + 2))
    C = pt.candidate_count(w["n"])
    cand = TR.select_candidates_bucket(coarse, C, rng_s, seg_hist=seg_hist)
    want_c = _jit(JR.select_candidates_bucket, 1, 2)(jnp.asarray(want), C,
                                                     rng_s)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(want_c))


def test_wide_stage2_topk_and_retrieve_match_reference():
    """Stage II with its top-k at B = 128 (the reference's jnp ``rerank``
    and ``lax.top_k``): estimates within rtol 1e-4 / atol 1e-3, the same
    winners; ``retrieve`` end to end gives the reference's index sets."""
    w = _wide()
    pt, pj = w["pt"], w["pj"]
    C, k = pt.candidate_count(w["n"]), pt.top_k
    got = TR.retrieve(w["mt"].centroid_ids, w["mt"].codes, w["mt"].weights,
                      w["qt"], _t(w["enc"]), pt, C, k)
    valid = jnp.asarray(_valid(w))[:, None, None, :]
    meta_b = jax.tree.map(lambda a: a[:, :, None], w["mj"])
    want = _jit(JR.retrieve, 3, 4, 5)(meta_b, w["qj"], valid, pj, C, k)
    np.testing.assert_array_equal(got.cand_indices.numpy(),
                                  np.asarray(want.cand_indices))
    est_j = np.asarray(_jit(JR.rerank, 4)(meta_b, w["qj"], want.cand_indices,
                                          valid, pj))
    est_t = TR.rerank(w["mt"].codes, w["mt"].weights, w["qt"],
                      got.cand_indices, _t(w["enc"]), pt)
    np.testing.assert_allclose(est_t.numpy(), est_j, rtol=1e-4, atol=1e-3)
    order_t = np.argsort(got.indices.numpy(), -1)
    order_j = np.argsort(np.asarray(want.indices), -1)
    np.testing.assert_array_equal(
        np.take_along_axis(got.indices.numpy(), order_t, -1),
        np.take_along_axis(np.asarray(want.indices), order_j, -1))
    np.testing.assert_allclose(
        np.take_along_axis(got.scores.numpy(), order_t, -1),
        np.take_along_axis(np.asarray(want.scores), order_j, -1),
        rtol=1e-4, atol=1e-3)
    rows = got.indices.numpy() + np.arange(w["b"])[:, None, None,
                                                   None] * w["n"]
    np.testing.assert_array_equal(got.phys_rows.numpy(), rows)


def test_wide_k_only_decode_gather_matches_plain_gathers():
    """The K-only decode gather over the latent (b, n, 1, 576): sink,
    window and the 16 heads' winner rows, the reference's slices and
    ``take_along_axis``; the V parts None."""
    w = _wide()
    lat = _t(w["lat"][:, 0, :, None])                       # (b, n, 1, D)
    sink, W = 8, 64
    ws = np.array([100, 320], np.int32)
    idx = np.random.RandomState(3).randint(
        0, w["n"], (w["b"], 1, w["H"], 20)).astype(np.int32)
    phys = idx + np.arange(w["b"])[:, None, None, None] * w["n"]
    k_d, v_d, k_r, v_r = gather_decode_paged(
        lat, None, row_tables(w["b"], "cpu"), _t(ws), sink, W,
        _t(phys.astype(np.int32)))
    assert v_d is None and v_r is None
    la = w["lat"][:, 0]                                     # (b, n, D)
    for r in range(w["b"]):
        np.testing.assert_array_equal(k_d[r, :sink, 0].numpy(), la[r, :sink])
        np.testing.assert_array_equal(k_d[r, sink:, 0].numpy(),
                                      la[r, ws[r]:ws[r] + W])
    want = np.take_along_axis(la[:, None, None], idx[..., None], axis=-2)
    np.testing.assert_array_equal(k_r.numpy(), want)
