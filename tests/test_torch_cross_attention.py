"""The cross-attention families' modules in the port against the
reference, in float32 on the same numpy inputs (CPU): whisper-large-v3
(``audio``: an encoder, a cross sublayer in every decoder layer) and
llama-3.2-vision-11b (``vlm``: a gated cross layer every 5th).

* ``layer_plan`` of both, full and smoke, field for field (``cross`` and
  ``causal`` included);
* ``media_stub`` and ``sinusoidal_positions`` bit-identical;
* ``full_attention``, the dense oracle, with and without a mask;
* ``encoder_fwd`` at whisper-smoke within 1e-5, from float32 and from
  bfloat16 weights (the port casts them up where the reference's float32
  frames promote them);
* ``attn_cross`` within 1e-5, with and without qk-norm;
* one decode step of a cross layer (vision, gate non-zero) and of a
  whisper layer (its cross sublayer over the full media) within 1e-5;
* the prefill's ``media_kv`` of every layer within 1e-6;
* ``params_from_jax`` and ``load_npz`` carrying the encoder stack,
  ``enc_final_norm``, ``cross``, ``norm_cross`` and the 0-d
  ``cross_gate`` exactly, in the tree's dtypes; a tree of another encoder
  depth refused;
* ``prefill`` and three ``decode_step``s of both smoke configs within 1e-4
  of the reference's (its ``tests/test_arch_smoke.py::
  test_prefill_and_decode``), with seeded non-zero gates, and the same
  greedy tokens;
* the slot-local media entries of the caches, paged and contiguous;
* the serving CLI on each new architecture.

The cross gates are zero at init in both packages (tanh(0) = 0), so every
comparison that runs a vision cross layer sets them to seeded values
first: with a zero gate the layer adds nothing, whatever it computes."""
import contextlib
import dataclasses
import functools
import io

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
from repro.data import media_stub as j_media_stub  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import serve as JSV  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import cache as TCC  # noqa: E402
from repro_torch.data import media_stub  # noqa: E402
from repro_torch.launch import serve as TLS  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import serve as TSV  # noqa: E402

ARCH = {"vlm": "llama-3.2-vision-11b", "audio": "whisper-large-v3"}
BATCH, SEQ, N_MAX = 2, 64, 256


def _t(a):
    return torch.from_numpy(np.array(a))           # writable copy


def _cfgs(family, dtype="float32"):
    arch = ARCH[family]
    return (dataclasses.replace(JC.smoke(arch), dtype=dtype),
            dataclasses.replace(TC.smoke(arch), dtype=dtype))


def _media(cfg, seed=0, batch=BATCH):
    return media_stub(batch, TSV.media_len(cfg), cfg.d_model, seed=seed)


def _seed_gates(tree, seed=3):
    """The reference's tree with every ``cross_gate`` set to seeded values
    in (0.3, 0.9) (tanh of them is far from 0), in the gate's dtype."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        if jax.tree_util.keystr(path).endswith("['cross_gate']"):
            return jnp.asarray(rng.uniform(0.3, 0.9, a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(leaf, tree)


@functools.lru_cache(maxsize=None)
def _params(family, dtype="float32", key=1):
    """The reference's smoke params (PRNGKey(``key``), gates seeded) and
    the port's copies."""
    cfg_j, cfg_t = _cfgs(family, dtype)
    pj = _seed_gates(JM.init_params(cfg_j, jax.random.PRNGKey(key)))
    return cfg_j, cfg_t, pj, convert.params_from_jax(jax.device_get(pj),
                                                     cfg_t, device="cpu")


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_layer_plan_matches_reference(family):
    """Stages, repeats and every LayerDef field, AttnSpec included, at full
    size and smoke size."""
    arch = ARCH[family]
    for cfg_j, cfg_t in ((JC.get(arch), TC.get(arch)),
                         (JC.smoke(arch), TC.smoke(arch))):
        plan_j, plan_t = JM.layer_plan(cfg_j), TM.layer_plan(cfg_t)
        assert [(s.repeat, len(s.layers)) for s in plan_t] == \
            [(s.repeat, len(s.layers)) for s in plan_j]
        for sj, st in zip(plan_j, plan_t):
            for lj, lt in zip(sj.layers, st.layers):
                assert dataclasses.asdict(lt) == dataclasses.asdict(lj)
    (st,) = TM.layer_plan(TC.get(arch))
    if family == "vlm":
        assert st.repeat == 8 and [ld.mixer for ld in st.layers] == \
            ["attn"] * 4 + ["cross"]
        cross = st.layers[-1]
        assert not cross.attn.causal and not cross.use_pariskv
        assert all(ld.attn.causal and ld.use_pariskv
                   for ld in st.layers[:-1])
    else:
        (ld,) = st.layers
        assert st.repeat == 32 and ld.cross and ld.use_pariskv
        assert ld.attn.causal


def test_media_stub_and_positions_bit_identical():
    for args in ((2, 64, 256, 0), (1, 1600, 64, 3), (3, 7, 5, 11)):
        np.testing.assert_array_equal(media_stub(*args),
                                      j_media_stub(*args))
    for n, d in ((64, 256), (1500, 1280), (7, 6)):
        np.testing.assert_array_equal(TL.sinusoidal_positions(n, d),
                                      JL.sinusoidal_positions(n, d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_fwd_matches_reference(dtype):
    """Whisper-smoke's two encoder layers over 64 stub frames: float32 in
    both packages (bfloat16 weights promoted by the float32 frames)."""
    cfg_j, cfg_t, pj, pt = _params("audio", dtype)
    feats = _media(cfg_t, seed=4)
    want = np.asarray(JM.encoder_fwd(pj, cfg_j, jnp.asarray(feats)))
    got = TM.encoder_fwd(pt, cfg_t, _t(feats))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_full_attention_matches_reference():
    """The dense oracle with GQA (8 query heads on 2 kv heads), with no
    mask and with a (b, H, S, T) mask that hides a seeded half of the
    keys (every row keeps one)."""
    from repro.core import attention as JA
    from repro_torch.core import attention as TA
    rng = np.random.RandomState(8)
    q = rng.randn(2, 9, 8, 16).astype(np.float32)
    k, v = (rng.randn(2, 21, 2, 16).astype(np.float32) for _ in range(2))
    mask = rng.rand(2, 8, 9, 21) < 0.5
    mask[..., 0] = True
    for m in (None, mask):
        want = JA.full_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), None if m is None
                                 else jnp.asarray(m), sm_scale=0.25)
        got = TA.full_attention(_t(q), _t(k), _t(v), None if m is None
                                else _t(m), sm_scale=0.25)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_attn_cross_matches_reference(qk_norm):
    """A vision cross layer's attention: queries from 11 states of two
    rows, keys and values from 64 media tokens (qk-norm with seeded scales
    in the second case)."""
    cfg_j, cfg_t, pj, pt = _params("vlm")
    ld_j = JM.layer_plan(cfg_j)[0].layers[-1]
    ld_t = TM.layer_plan(cfg_t)[0].layers[-1]
    spec_j = dataclasses.replace(ld_j.attn, qk_norm=qk_norm)
    spec_t = dataclasses.replace(ld_t.attn, qk_norm=qk_norm)
    p_j = dict(jax.tree.map(lambda a: a[0], pj["stages"][0]["l4"])["attn"])
    p_t = dict(pt["layers"][4]["attn"])
    rng = np.random.RandomState(6)
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            s = (0.5 * rng.randn(cfg_t.head_dim)).astype(np.float32)
            p_j[name], p_t[name] = jnp.asarray(s), _t(s)
    x = rng.randn(2, 11, cfg_t.d_model).astype(np.float32)
    media = _media(cfg_t, seed=5)
    want = JL.attn_cross(p_j, jnp.asarray(x), jnp.asarray(media), spec_j)
    got = TL.attn_cross(p_t, _t(x), _t(media), spec_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _decode_layer(family, li):
    """One decode step of layer ``li`` of the family's smoke model in both
    packages, over full-length random media K/V (and, for whisper's
    self-attention, a random contiguous store read densely, the
    full-attention baseline, so that the step is deterministic) →
    (reference x_t, port x_t)."""
    cfg_j, cfg_t, pj, pt = _params(family)
    plan = JM.layer_plan(cfg_j)[0]
    ld_j = plan.layers[li % len(plan.layers)]
    ld_t = TM.layer_defs(cfg_t)[li]
    rep, i = divmod(li, len(plan.layers))
    p_j = jax.tree.map(lambda a: a[rep], pj["stages"][0][f"l{i}"])
    p_t = pt["layers"][li]
    G, hd, T = cfg_t.num_kv_heads, cfg_t.head_dim, TSV.media_len(cfg_t)
    rng = np.random.RandomState(7 + li)
    x = rng.randn(3, cfg_t.d_model).astype(np.float32)
    km, vm = (rng.randn(3, T, G, hd).astype(np.float32) for _ in range(2))
    pos = np.array([5, 40, 63], np.int32)
    regions_j = JCC.CacheRegions(jnp.asarray(pos - 1),
                                 jnp.zeros((3,), jnp.int32))
    regions_t = TCC.CacheRegions(_t(pos - 1),
                                 torch.zeros(3, dtype=torch.int32))
    cache_j = {"media_kv": (jnp.asarray(km), jnp.asarray(vm))}
    cache_t = {"media_kv": (_t(km), _t(vm))}
    if ld_t.mixer == "cross":
        cache_t["cross"] = True
    else:
        ks, vs = (rng.randn(3, 128, G, hd).astype(np.float32)
                  for _ in range(2))
        cache_j["kv"] = JCC.init_layer_cache(3, 128, G, hd, cfg_j.pariskv,
                                             jnp.float32)._replace(
            k=jnp.asarray(ks), v=jnp.asarray(vs))
        kv_t = TCC.init_layer_cache(3, 128, G, hd, cfg_t.pariskv,
                                    torch.float32, "cpu")
        kv_t.k.copy_(_t(ks))
        kv_t.v.copy_(_t(vs))
        cache_t["kv"] = kv_t
        ld_j = JSV.dataclasses_replace_nopk(ld_j)
    signs_j = JSV.rotation_signs(cfg_j)
    want, _ = JSV._layer_decode(p_j, jnp.asarray(x), ld_j, cfg_j, cache_j,
                                regions_j, signs_j, 64,
                                jnp.zeros((3,), bool))
    got = TSV._layer_decode(p_t, _t(x), ld_t, cfg_t, cache_t, regions_t,
                            TSV.rotation_signs(cfg_t, "cpu"), 64,
                            torch.zeros(3, dtype=torch.bool), False, None,
                            None, None, False, True)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("family,li", [("vlm", 4), ("audio", 1)])
def test_cross_decode_step_matches_reference(family, li):
    """The vision cross layer (gate non-zero, the whole layer: gated cross
    attention and MLP) and a whisper layer (dense self-attention, the
    cross sublayer, MLP), one query row per batch row over the full media
    length."""
    want, got = _decode_layer(family, li)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _prefills(family):
    """Both packages' prefill of two 64-token prompts with stub media, and
    three greedy decode steps → ((ref logits, ref state), (port logits,
    port state)) per step, the prefill's first."""
    cfg_j, cfg_t, pj, pt = _params(family)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg_t.vocab_size, (BATCH, SEQ)).astype(np.int32)
    media = _media(cfg_t, seed=1)
    lg_j, st_j = JSV.prefill(pj, cfg_j, jnp.asarray(toks), N_MAX,
                             jnp.asarray(media))
    lg_t, st_t = TSV.prefill(pt, cfg_t, toks, N_MAX, device="cpu",
                             media=media)
    out = [(np.asarray(lg_j), lg_t.numpy())]
    media_kv = ([jax.device_get(st_j.caches)], [
        tuple(t.clone() for t in lc["media_kv"]) for lc in st_t.caches
        if "media_kv" in lc])
    tok_j = jnp.argmax(lg_j, -1).astype(jnp.int32)
    tok_t = lg_t.argmax(-1).to(torch.int32)
    for _ in range(3):
        lg_j, st_j = JSV.decode_step(pj, cfg_j, tok_j, st_j)
        lg_t, st_t = TSV.decode_step(pt, cfg_t, tok_t, st_t)
        out.append((np.asarray(lg_j), lg_t.numpy()))
        tok_j = jnp.argmax(lg_j, -1).astype(jnp.int32)
        tok_t = lg_t.argmax(-1).to(torch.int32)
    return out, media_kv, st_t


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_prefill_media_kv_matches_reference(family):
    """Every cross layer's (vision) or sublayer's (whisper) media K/V after
    the prefill, in the config's dtype (float32 here)."""
    cfg_j, cfg_t = _cfgs(family)
    _, (caches_j, kv_t), _ = _prefills(family)
    want = []
    (stage,) = JM.layer_plan(cfg_j)
    for r in range(stage.repeat):
        for i in range(len(stage.layers)):
            lc = caches_j[0][0][f"l{i}"]
            if "media_kv" in lc:
                want.append(tuple(np.asarray(t)[r] for t in lc["media_kv"]))
    n_cross = (cfg_t.num_layers // cfg_t.cross_attn_period
               if family == "vlm" else cfg_t.num_layers)
    assert len(kv_t) == len(want) == n_cross
    for got, ref in zip(kv_t, want):
        for g, w in zip(got, ref):
            assert g.shape == (BATCH, TSV.media_len(cfg_t),
                               cfg_t.num_kv_heads, cfg_t.head_dim)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_prefill_and_decode_matches_reference(family):
    """The reference's ``test_prefill_and_decode`` on both packages: the
    prefill's logits and three decode steps' within 1e-4 (and their
    greedy tokens equal), finite, each row at position SEQ - 1 + 3."""
    steps, _, st_t = _prefills(family)
    for want, got in steps:
        assert got.shape == (BATCH, _cfgs(family)[1].vocab_size)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_array_equal(st_t.regions.pos.numpy(),
                                  np.full((BATCH,), SEQ - 1 + 3))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("route", ["params_from_jax", "load_npz"])
def test_convert_carries_encoder_and_cross_params(route, tmp_path):
    """bfloat16 smoke trees of both families (gates seeded): every leaf of
    the port's params equals the reference's slice exactly, in its dtype —
    the encoder layer by layer, ``enc_final_norm``, the cross layers'
    0-d ``cross_gate``, whisper's ``cross`` and ``norm_cross``."""
    for family in ("vlm", "audio"):
        cfg_j, cfg_t, pj, _ = _params(family, "bfloat16", key=0)
        if route == "params_from_jax":
            pt = convert.params_from_jax(jax.device_get(pj), cfg_t,
                                         device="cpu")
        else:
            path = str(tmp_path / f"{family}.npz")
            save_checkpoint(path, pj)
            pt = convert.load_npz(path, cfg_t, device="cpu")
        pairs = [(pt["layers"][li], jax.tree.map(
            lambda a, r=r: a[r], pj["stages"][0][f"l{i}"]))
            for li, (r, i) in enumerate(
                (r, i) for r in range(JM.layer_plan(cfg_j)[0].repeat)
                for i in range(len(JM.layer_plan(cfg_j)[0].layers)))]
        if family == "audio":
            assert len(pt["encoder"]) == cfg_t.encoder_layers
            pairs += [(pt["encoder"][r], jax.tree.map(lambda a, r=r: a[r],
                                                      pj["encoder"]))
                      for r in range(cfg_t.encoder_layers)]
            pairs.append(({"n": pt["enc_final_norm"]},
                          {"n": pj["enc_final_norm"]}))
        names = set()
        for got, want in pairs:
            want = dict(_leaves(jax.device_get(want)))
            got = dict(_leaves(got))
            assert set(got) == set(want)
            for path, w in want.items():
                g = got[path]
                names.update(path)
                assert tuple(g.shape) == w.shape, path
                assert g.dtype == torch.bfloat16, path
                np.testing.assert_array_equal(
                    g.float().numpy(), np.asarray(w, np.float32))
        if family == "vlm":
            gates = [float(pt["layers"][li]["cross_gate"])
                     for li in range(4, cfg_t.num_layers, 5)]
            assert gates and all(g > 0.29 for g in gates)
            assert pt["layers"][4]["cross_gate"].dim() == 0
        else:
            assert {"cross", "norm_cross", "norm_attn", "wq"} <= names
    short = dataclasses.replace(cfg_t, encoder_layers=1)
    with pytest.raises(ValueError, match="encoder layers"):
        convert.params_from_jax(jax.device_get(pj), short, device="cpu")


def test_caches_keep_media_slot_local():
    """The media K/V beside the pool: a whisper entry holds its pool, its
    histogram and ``media_kv``; a vision cross entry holds ``media_kv``
    alone, tagged ``cross``, and every pool walk skips it; on a
    head-sharded rank the media keeps every head; admission copies a
    prefill's media into the slot's row whole."""
    _, vlm = _cfgs("vlm")
    _, aud = _cfgs("audio")
    caches = TSV.make_paged_caches(vlm, 2, 8, 32, "cpu", n_max=256)
    assert TSV.pool_layers(vlm) == [True] * 4 + [False]
    assert [set(lc) for lc in caches] == [{"kv", "hist"}] * 4 + [
        {"media_kv", "cross"}]
    assert TSV.pool_entries(caches) == caches[:4]
    assert TSV.is_cross(caches[4]) and not TSV.is_pool(caches[4])
    assert [t.shape for t in caches[4]["media_kv"]] == [(2, 64, 2, 64)] * 2

    class Half:
        shards = 2

    ac = TSV.make_paged_caches(aud, 2, 8, 32, "cpu", num_device_blocks=4,
                               dist=Half)
    assert [set(lc) for lc in ac] == [{"kv", "hist", "fetch",
                                       "media_kv"}] * 2
    assert TSV.pool_entries(ac) == ac
    assert ac[0]["kv"].k.shape[2] == 2                   # half the heads
    assert ac[0]["media_kv"][0].shape == (2, 64, 4, 64)  # every head

    st = TSV.init_paged_slot_state(vlm, 2, 8, 32, device="cpu", n_max=256)
    one = TSV.make_caches(vlm, 1, 64, "cpu")
    for t in one[4]["media_kv"]:
        t.copy_(torch.randn(t.shape))
    regions = TCC.CacheRegions(torch.tensor([19], dtype=torch.int32),
                               torch.tensor([0], dtype=torch.int32))
    TSV.admit_paged(st, 1, torch.full((2,), 8, dtype=torch.int32), one,
                    regions, 3, 4, vlm.pariskv)
    for big, small in zip(st.caches[4]["media_kv"], one[4]["media_kv"]):
        np.testing.assert_array_equal(big[1].numpy(), small[0].numpy())
        assert (big[0] == 0).all()
    slot = TSV.init_slot_state(vlm, 2, 64, device="cpu")
    TSV.admit_slot(slot, 0, one, regions, 3, 4)
    np.testing.assert_array_equal(slot.caches[4]["media_kv"][0][0].numpy(),
                                  one[4]["media_kv"][0][0].numpy())
    with pytest.raises(ValueError, match="media"):
        TSV.prefill(_params("vlm")[3], vlm, np.zeros((1, 8), np.int32), 64,
                    device="cpu")


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_cli_serves_each_cross_arch(family):
    """``python -m repro_torch.launch.serve --arch <arch> --smoke --device
    cpu``: every request carries the stub media and gets its tokens."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        TLS.main(["--arch", ARCH[family], "--smoke", "--device", "cpu",
                  "--requests", "2", "--prompt-len", "40", "--gen", "4",
                  "--n-max", "128"])
    lines = out.getvalue().splitlines()
    assert [ln.split(":")[0] for ln in lines[:2]] == ["req 0", "req 1"]
    assert all(len(eval(ln.split("out[:8]=")[1])) == 4 for ln in lines[:2])
    assert "ParisKV/slots" in lines[-1]
