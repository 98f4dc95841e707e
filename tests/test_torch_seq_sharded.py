"""The sequence-sharded contiguous decode in the port
(``decode_step(dist=SeqShardDist)``, ``layers.distributed_retrieve_fetch``)
against the reference's ``decode_step(dist=(mesh, "seq", None))`` on 2 and
4 shards, on the CPU, in float32.

The reference's sharded path is not its one-device path (each shard takes
its own candidate budget, ``C_loc = min(candidate_count(n_loc), n_loc)``),
so the port is held to the reference's sharded path: winners exactly, K/V
rows bit for bit, attention outputs within 1e-5, logits within 1e-4.

The reference runs once per module in a subprocess that forces four host
devices (``XLA_FLAGS``, set before JAX is imported: ``tests/conftest.py``
imports JAX for the whole suite) on a ``jax.sharding.Mesh`` of
``jax.devices()[:s]`` (``jax.make_mesh`` gives explicit axes, which the
reference's ``decode_append`` refuses under this JAX), and writes an
``.npz``. Meanwhile the port runs in gloo ranks (``launch_local``; every
case of a shard count in one spawn), from the reference's parameters
(``params_from_jax``) and the same numpy inputs:

(a) ``distributed_retrieve_fetch`` on constructed metadata: the sink in
    shard 0, a shard wholly past ``enc_end``, shards with fewer valid keys
    than k, metadata repeated in every shard (score ties across shards,
    which the merge breaks toward the lower shard), and a sampled bucket
    histogram (``hist_sample``: its stride taken from n_loc);
(b) ``attn_decode_pariskv(dist=)``: y, and each rank's shard of the cache
    after the append;
(c) ``decode_step(dist=)`` of qwen2-smoke (2 and 4 shards), gemma2-smoke
    and hymba-smoke (2), teacher-forced with seeded tokens for 34 steps
    from a one-device prefill of two rows (136 and 110 tokens, n_max 256),
    so that a promoted block, [120, 136), straddles the shard boundary at
    128: logits at every step and every layer's winners;
(d) the refusals: n_max not a multiple of the shards, paged caches (the
    reference's text), the full-attention baseline.
"""
import concurrent.futures
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores, and torch's
# spinning OpenMP pool would otherwise slow each of them many times over
torch.set_num_threads(1)

# JAX and the reference are imported inside the helpers that use them: the
# spawned ranks import this module and should start without them
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import cache as TCC  # noqa: E402
from repro_torch.distributed import SeqShardDist, launch_local  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import serve as TSV  # noqa: E402
from repro_torch.models.model import layer_defs  # noqa: E402

ARCH = "qwen2-1.5b"
SHARDS = (2, 4)
# (c): qwen2 on both shard counts; gemma2 (its local layers' rings whole on
# every rank) and hymba (the ParisKV half of its hybrid layers) on two
DECODE_RUNS = (("qwen2-1.5b", 2), ("qwen2-1.5b", 4), ("gemma2-27b", 2),
               ("hymba-1.5b", 2))
N = 256                          # n_max of every case
B_ROWS = 2
TIMEOUT_S = 60.0
LENS = (136, 110)                # (c): LEFT-aligned prompt lengths
STEPS = 34                       # (c): promotions at steps 16 and 32
# the weights ×3, so that logits and attention are far from uniform; hymba
# keeps its init: with ×3 its one-device decode already drifts up to 7.1e-4
# from the reference's over these 34 steps (SSD state in float32, summed in
# another order), against ~1e-6 at ×1
PARAM_SCALE = {"hymba-1.5b": 1.0}
# (a): (enc_end, pos) per row; every case also runs (b) at its regions
CASES = {
    "sink_in_shard0": ((200, 150), (230, 190)),
    "past_enc_end": ((40, 100), (90, 140)),
    "few_valid": ((136, 70), (180, 115)),
    "ties": ((248, 256), (255, 255)),
    "sampled_hist": ((200, 150), (230, 190)),
}
# cases whose bucket histogram is sampled (pcfg.hist_sample): the stride is
# n_loc // hist_sample on a shard, 4 on 2 shards and 2 on 4
HIST_SAMPLE = {"sampled_hist": 32}


def _cfg_t(arch: str = ARCH):
    return dataclasses.replace(TC.smoke(arch), dtype="float32")


def _case_pcfg(pcfg, name: str):
    return dataclasses.replace(pcfg, hist_sample=HIST_SAMPLE.get(name, 0))


def _case_arrays(name: str) -> dict:
    """Seeded inputs of one retrieval case: a (B_ROWS, N) cache of float32
    K/V and random metadata, queries, and the decode input x_t."""
    cfg = _cfg_t()
    G, hd = cfg.num_kv_heads, cfg.head_dim
    Hg = cfg.num_heads // G
    nb = cfg.pariskv.num_subspaces(hd)
    rng = np.random.RandomState(sorted(CASES).index(name) + 11)
    enc, pos = (np.asarray(v, np.int32) for v in CASES[name])
    a = dict(k=rng.randn(B_ROWS, N, G, hd).astype(np.float32),
             v=rng.randn(B_ROWS, N, G, hd).astype(np.float32),
             ids=rng.randint(0, 256, (B_ROWS, G, N, nb)).astype(np.uint8),
             codes=rng.randint(0, 2 ** 32, (B_ROWS, G, N, nb),
                               dtype=np.uint64).astype(np.uint32),
             w=rng.uniform(0.1, 2.0, (B_ROWS, G, N, nb)).astype(np.float32),
             q=rng.randn(B_ROWS, G, Hg, hd).astype(np.float32),
             x=rng.randn(B_ROWS, cfg.d_model).astype(np.float32),
             enc_end=enc, pos=pos)
    if name == "ties":              # every shard of 64 positions the same
        for f in ("ids", "codes", "w"):
            a[f] = np.tile(a[f][:, :, :N // 4], (1, 1, 4, 1))
    return a


def _prompt_and_forced(vocab: int):
    rng = np.random.RandomState(5)
    prompt = np.zeros((B_ROWS, max(LENS)), np.int32)
    for i, n in enumerate(LENS):
        prompt[i, :n] = rng.randint(0, vocab, n)
    forced = rng.randint(0, vocab, (STEPS, B_ROWS)).astype(np.int32)
    return prompt, forced


# ----------------------------------------------------------- reference ----
def _reference_params(cfg_j, arch: str = ARCH):
    import jax
    from repro.models import model as JM
    pj = JM.init_params(cfg_j, jax.random.PRNGKey(3))
    scale = PARAM_SCALE.get(arch, 3.0)
    return jax.tree.map(lambda t: t * scale, pj)


def _reference_main(out_path: str) -> None:
    """The reference's side of every case on 2- and 4-device meshes (run
    in a subprocess with four forced host devices) → ``out_path`` .npz."""
    import jax
    import jax.numpy as jnp
    from repro import configs as JC
    from repro.core import cache as JCC
    from repro.models import layers as JL
    from repro.models import model as JM
    from repro.models import serve as JSV

    cfg = dataclasses.replace(JC.smoke(ARCH), dtype="float32")
    pcfg = cfg.pariskv
    pj = _reference_params(cfg)
    signs = JSV.rotation_signs(cfg)
    p0 = jax.tree.map(lambda t: t[0], pj["stages"][0]["l0"]["attn"])
    spec = JM.layer_plan(cfg)[0].layers[0].attn
    fetch = jax.jit(JL.distributed_retrieve_fetch, static_argnums=(3, 5, 6, 7))
    decode = jax.jit(JL.attn_decode_pariskv, static_argnums=(4, 5, 7, 8))
    out = {}
    for s in SHARDS:
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:s]), ("seq",))
        for name in CASES:
            a = _case_arrays(name)
            lc = JCC.LayerKVCache(*(jnp.asarray(a[f]) for f in
                                    ("k", "v", "ids", "codes", "w")))
            reg = JCC.CacheRegions(pos=jnp.asarray(a["pos"]),
                                   enc_end=jnp.asarray(a["enc_end"]))
            pc = _case_pcfg(pcfg, name)
            top, k_ret, v_ret = fetch(
                jnp.asarray(a["q"]), lc, reg, pc, signs, mesh, "seq", None)
            y, lc2 = decode(
                p0, jnp.asarray(a["x"]), lc, reg, spec, pc, signs,
                pc.candidate_count(N), (mesh, "seq", None))
            for f, t in (("top", top), ("k_ret", k_ret), ("v_ret", v_ret),
                         ("y", y), ("k_after", lc2.k), ("v_after", lc2.v)):
                out[f"a.{name}.{s}.{f}"] = np.asarray(t)

    for arch, s in DECODE_RUNS:
        cfg = dataclasses.replace(JC.smoke(arch), dtype="float32")
        pj = _reference_params(cfg, arch)
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:s]), ("seq",))
        # the winners are recorded by an unordered callback (an ordered one
        # is refused on more than one device), so each record carries its
        # layer (stage, index in the stage), fixed when the step is traced;
        # a layer's repeats run in scan order, so they arrive in order
        plan = JM.layer_plan(cfg)
        where = [(si, i) for si, st_ in enumerate(plan)
                 for i in range(len(st_.layers))]
        traced, rec = {"layer": -1}, {}
        orig_fetch, orig_layer = JL.distributed_retrieve_fetch, \
            JSV._layer_decode

        def layer_decode(*args, **kw):
            traced["layer"] += 1
            return orig_layer(*args, **kw)

        def recording(*args, **kw):
            res = orig_fetch(*args, **kw)
            key = where[traced["layer"]]
            jax.debug.callback(lambda i, key=key: rec.setdefault(
                key, []).append(np.asarray(i)), res[0])
            return res

        def traced_step(p, t, st_):
            traced["layer"] = -1
            return JSV.decode_step(p, cfg, t, st_, dist=(mesh, "seq", None))
        JL.distributed_retrieve_fetch = recording
        JSV._layer_decode = layer_decode
        try:
            prompt, forced = _prompt_and_forced(cfg.vocab_size)
            _, st = JSV.prefill(pj, cfg, jnp.asarray(prompt), N,
                                lengths=jnp.asarray(LENS, jnp.int32))
            step = jax.jit(traced_step)
            logits, winners = [], []
            for t in range(STEPS):
                lg, st = step(pj, jnp.asarray(forced[t]), st)
                logits.append(np.asarray(lg))
                jax.effects_barrier()
                assert traced["layer"] == len(where) - 1, traced
                for si, stage in enumerate(plan):   # the port's layer order
                    keys = [(si, i) for i in range(len(stage.layers))
                            if (si, i) in rec]
                    assert all(len(rec[k]) == stage.repeat for k in keys)
                    winners.extend(rec[k][r] for r in range(stage.repeat)
                                   for k in keys)
                rec.clear()
        finally:
            JL.distributed_retrieve_fetch = orig_fetch
            JSV._layer_decode = orig_layer
        out[f"c.{arch}.{s}.logits"] = np.stack(logits)
        out[f"c.{arch}.{s}.winners"] = np.stack(winners)
        out[f"c.{arch}.{s}.enc_end"] = np.asarray(st.regions.enc_end)
    np.savez(out_path, **out)


# ---------------------------------------------------------------- port ----
def _rank(rank: int, shards: int, params) -> dict:
    """One gloo rank of ``shards``: (a) and (b) on every case, then (c)
    (``params`` by arch)."""
    torch.set_num_threads(1)
    cfg = _cfg_t()
    pcfg = cfg.pariskv
    d = SeqShardDist.from_process_group(shards)
    signs = TSV.rotation_signs(cfg, "cpu")
    spec = layer_defs(cfg)[0].attn
    out = {}
    for name in CASES:
        a = _case_arrays(name)
        t = {f: torch.from_numpy(a[f]) for f in a if f != "codes"}
        t["codes"] = torch.from_numpy(a["codes"].view(np.int32))
        reg = TCC.CacheRegions(pos=t["pos"], enc_end=t["enc_end"])

        def shard():
            full = TCC.LayerKVCache(*(t[f].clone() for f in
                                      ("k", "v", "ids", "codes", "w")))
            st = TSV.seq_shard_state(TSV.ServeState([{"kv": full}], reg), d)
            return st.caches[0]["kv"]
        pc = _case_pcfg(pcfg, name)
        res, rows = TL.distributed_retrieve_fetch(t["q"], shard(), reg, pc,
                                                  signs, d)
        kv = shard()
        y, _ = TL.attn_decode_pariskv(params[ARCH]["layers"][0]["attn"],
                                      t["x"], kv, reg, spec, pc, signs,
                                      pc.candidate_count(N), d)
        out[name] = dict(top=res.indices.numpy(),
                         rows={f: getattr(rows, f).numpy()
                               for f in rows._fields},
                         y=y.numpy(), k_after=kv.k.numpy(),
                         v_after=kv.v.numpy())

    for arch in (a for a, s in DECODE_RUNS if s == shards):
        cfg = _cfg_t(arch)
        prompt, forced = _prompt_and_forced(cfg.vocab_size)
        _, st1 = TSV.prefill(params[arch], cfg, prompt, N,
                             lengths=list(LENS), device="cpu")
        st = TSV.seq_shard_state(st1, d)
        logits, winners = [], []
        for step in range(STEPS):
            rec = []
            lg, st = TSV.decode_step(params[arch], cfg,
                                     torch.from_numpy(forced[step]), st,
                                     record=rec, dist=d)
            logits.append(lg.numpy())
            winners.extend(r.indices.numpy() for r in rec)
        out[arch] = dict(logits=np.stack(logits), winners=np.stack(winners),
                         enc_end=st.regions.enc_end.numpy(),
                         n_loc=[tuple(lc["kv"].k.shape) for lc in st.caches
                                if isinstance(lc.get("kv"),
                                              TCC.LayerKVCache)],
                         whole=[tuple(lc["kv"][0].shape)
                                for lc in st.caches if lc.get("ring")])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's ranks, run at once."""
    import jax
    from repro import configs as JC
    from repro_torch.models import convert

    path = str(tmp_path_factory.mktemp("seqshard") / "ref.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(tests), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [src, tests, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import test_torch_seq_sharded as t; "
         f"t._reference_main({path!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        pt = {arch: convert.params_from_jax(
            jax.device_get(_reference_params(dataclasses.replace(
                JC.smoke(arch), dtype="float32"), arch)), _cfg_t(arch),
            device="cpu") for arch in {a for a, _ in DECODE_RUNS}}
        with concurrent.futures.ThreadPoolExecutor(len(SHARDS)) as pool:
            futs = {s: pool.submit(launch_local, _rank, s, "gloo",
                                   timeout_s=TIMEOUT_S, args=(s, pt))
                    for s in SHARDS}
            port = {s: f.result() for s, f in futs.items()}
        log, _ = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log.decode()[-4000:]
    with np.load(path) as ref:
        return dict(ref), port


def _cache_rows(a: np.ndarray, rank: int, shards: int) -> np.ndarray:
    n_loc = N // shards
    return a[:, rank * n_loc:(rank + 1) * n_loc]


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_distributed_retrieve_fetch(runs, case, shards):
    """Winners exactly and winner rows bit for bit on every rank; the sink
    and window rows are the cache's own."""
    ref, port = runs
    a = _case_arrays(case)
    cfg = _cfg_t()
    sink, W = cfg.pariskv.sink_size, TCC.window_size(cfg.pariskv)
    ws = np.clip(a["pos"] + 2 - W, 0, N - W)
    for rank, out in enumerate(port[shards]):
        np.testing.assert_array_equal(out[case]["top"],
                                      ref[f"a.{case}.{shards}.top"],
                                      err_msg=f"winners, rank {rank}")
        rows = out[case]["rows"]
        for f in ("k_ret", "v_ret"):
            np.testing.assert_array_equal(
                rows[f].view(np.int32),
                ref[f"a.{case}.{shards}.{f}"].view(np.int32),
                err_msg=f"{f}, rank {rank}")
        for f, src in (("k", a["k"]), ("v", a["v"])):
            np.testing.assert_array_equal(rows[f"{f}_sink"], src[:, :sink])
            np.testing.assert_array_equal(
                rows[f"{f}_loc"],
                np.stack([src[i, s:s + W] for i, s in enumerate(ws)]))
    if case == "ties":
        # identical shards: the merge keeps lax.top_k's shard-major order
        assert (ref[f"a.{case}.{shards}.top"] >= N // shards).any()


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_attn_decode_pariskv_dist(runs, case, shards):
    """y within 1e-5; each rank's shard of the cache after the append is
    the reference's slice of it: the appended row (its K/V computed by
    each package's projection) within 1e-5 on the rank that owns its
    position, every other row bit for bit."""
    ref, port = runs
    at = np.minimum(_case_arrays(case)["pos"] + 1, N - 1)
    for rank, out in enumerate(port[shards]):
        np.testing.assert_allclose(out[case]["y"],
                                   ref[f"a.{case}.{shards}.y"], atol=1e-5,
                                   rtol=0, err_msg=f"rank {rank}")
        n_loc = N // shards
        for f in ("k_after", "v_after"):
            got = out[case][f]
            want = _cache_rows(ref[f"a.{case}.{shards}.{f}"], rank, shards)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
            rows, pos = np.nonzero((got != want).any(axis=(2, 3)))
            assert set(zip(rows, pos + rank * n_loc)) <= set(
                enumerate(at)), f"{f}, rank {rank}: rows {rows}, {pos}"


@pytest.mark.parametrize("arch,shards", DECODE_RUNS)
def test_decode_step_dist(runs, arch, shards):
    """Teacher-forced ``decode_step(dist=)``: every rank's logits within
    1e-4 of the reference's at every step, and every ParisKV layer's
    winners exactly, through two promotions, the second one a block
    straddling a shard boundary; a local layer's ring stays whole."""
    ref, port = runs
    want = ref[f"c.{arch}.{shards}.winners"]
    cfg = _cfg_t(arch)
    n_pk = sum(ld.mixer in ("attn", "hybrid") and ld.use_pariskv
               for ld in layer_defs(cfg))
    assert want.shape[0] == STEPS * n_pk
    # two promotions per row from LENS - 32: the second block of row 0 is
    # [120, 136), across the boundary at 128 on both shard counts
    np.testing.assert_array_equal(ref[f"c.{arch}.{shards}.enc_end"], LENS)
    for rank, out in enumerate(port[shards]):
        c = out[arch]
        assert c["n_loc"] == [(B_ROWS, N // shards, cfg.num_kv_heads,
                               cfg.head_dim)] * n_pk
        assert all(shape[1] == min(cfg.sliding_window, N)
                   for shape in c["whole"])
        np.testing.assert_array_equal(c["enc_end"], LENS)
        np.testing.assert_allclose(c["logits"],
                                   ref[f"c.{arch}.{shards}.logits"],
                                   atol=1e-4, rtol=1e-4,
                                   err_msg=f"rank {rank}")
        np.testing.assert_array_equal(c["winners"], want,
                                      err_msg=f"rank {rank}")
        np.testing.assert_array_equal(c["logits"],
                                      port[shards][0][arch]["logits"])


def test_refusals():
    """n_max not a multiple of the shards; a SeqShardDist with paged
    caches (the reference's refusal text); the full-attention baseline;
    no process group."""
    import jax
    import jax.numpy as jnp
    from repro import configs as JC
    from repro.core import cache as JCC
    from repro.models import model as JM
    from repro.models import serve as JSV
    from repro_torch.models.model import init_params

    cfg = _cfg_t()
    params = init_params(cfg, seed=0, device="cpu")
    _, st = TSV.prefill(params, cfg, np.zeros((1, 16), np.int32), 96,
                        device="cpu")
    with pytest.raises(ValueError, match=r"n_max=96 .* 5 sequence shards"):
        TSV.seq_shard_state(st, SeqShardDist(0, 5))
    tok = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(TSV.UnsupportedShardedConfig,
                       match=r"full-attention baseline") as err:
        TSV.decode_step(params, cfg, tok, TSV.seq_shard_state(
            st, SeqShardDist(0, 2)), use_pariskv=False,
            dist=SeqShardDist(0, 2))
    assert err.value.feature.startswith("the full-attention baseline")

    cfg_j = dataclasses.replace(JC.smoke(ARCH), dtype="float32")
    pj = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("seq",))
    regions = JCC.CacheRegions(pos=jnp.zeros((1,), jnp.int32),
                               enc_end=jnp.zeros((1,), jnp.int32))
    with pytest.raises(AssertionError) as want:
        JSV.decode_step(pj, cfg_j, jnp.zeros((1,), jnp.int32),
                        JSV.ServeState([], regions), dist=(mesh, "seq", None),
                        block_tables=jnp.zeros((1, 2), jnp.int32))
    with pytest.raises(ValueError) as got:
        TSV.decode_step(params, cfg, tok, st, dist=SeqShardDist(0, 2),
                        block_tables=torch.zeros((1, 2), dtype=torch.int32))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="seq_shards=2 needs a "
                                         "torch.distributed process group"):
        SeqShardDist.from_process_group(2)
