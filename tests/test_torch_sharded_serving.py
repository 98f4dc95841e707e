"""Head-sharded paged serving in the port (``PagedServingEngine(mesh_shards=
N)`` over ``torch.distributed``) against one device, on the CPU: each case
spawns its ranks once (``distributed.launch_local``, gloo, a 60 s timeout
that fails the test instead of hanging the run).

* Retrieval: the reference's 80-step drift loop
  (``tests/test_sharded_serving.py``, same sizes, seeds and checkpoints)
  runs in JAX; at each checkpoint 4 ranks each take their head of the
  pool, histogram and query and run ``retrieve_paged_fused_sharded``.
  Every gathered field equals the port's one-device
  ``retrieve_paged_fused`` exactly, and the reference's
  ``retrieve_paged_fused`` exactly in its integer fields and to float32
  reassociation in the Stage-II estimates (the bar of
  ``tests/test_torch_retrieval.py``).
* Engines, in float32 at the reference's ``_run_engine`` shape (n_max 256,
  2 slots, blocks of 64, chunks of 4, requests (33, 6), (48, 9), (70, 5)):
  stablelm-1.6b smoke (G = 4) on 4 ranks and qwen2-1.5b smoke (G = 2) on
  2, fused, meta view, ``prefill_budget=8``, prefix sharing (three
  prompts behind one 64-token prefix), a mid-flight cancel and an
  ``engine.slot`` quarantine. Every rank emits the same tokens, equal to
  the reference's one-device ``PagedServingEngine`` (and, fused, its
  contiguous ``ServingEngine``) and to the port's one-device engine, with
  the same block counters and fault log; each rank's pool, metadata and
  histograms hold G / N heads.
* The gates (no spawn): uneven heads, no process group, offload with
  shards; and ``launch_local`` failing fast on a rank that raises or
  hangs."""
import concurrent.futures
import dataclasses
import functools
import multiprocessing
import time

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
from repro_torch.core import encode as TE  # noqa: E402
from repro_torch.core import retrieval as TR  # noqa: E402
from repro_torch.core.config import ParisKVConfig as TP  # noqa: E402
from repro_torch.distributed import (RankError, ShardDist,  # noqa: E402
                                     launch_local)
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import serve as TSV  # noqa: E402
from repro_torch.serving import (FaultPlan, FaultSpec,  # noqa: E402
                                 PagedServingEngine, Request)

TIMEOUT_S = 60.0
GEOM = dict(n_max=256, max_batch=2, block_size=64, chunk_size=4)
SPECS = [(33, 6), (48, 9), (70, 5)]      # (prompt len, max_new), seed 7
# three prompts behind one 64-token prefix (one shareable block)
SHARE_SPECS = [(80, 6), (96, 9), (140, 5)]
CANCEL_SPECS = [(33, 24), (48, 9), (70, 5)]
QUARANTINE = [dict(site="engine.slot", kind="fail", match={"uid": 0})]
CASES = {
    "fused": dict(),
    "fallback": dict(kw={"fused": False}),
    "chunked": dict(kw={"prefill_budget": 8}),
    "share": dict(specs=SHARE_SPECS, shared=True,
                  kw={"prefill_budget": 8, "share_prefixes": True}),
    "cancel": dict(specs=CANCEL_SPECS, cancel_after=2),
    "quarantine": dict(faults=QUARANTINE),
}
MODELS = {"stablelm-1.6b": 4, "qwen2-1.5b": 2}     # model → ranks


def _prompts(specs, vocab, shared):
    rng = np.random.RandomState(7)
    out = [rng.randint(0, vocab, size=(n,)).astype(np.int32)
           for n, _ in specs]
    if shared:
        for p in out[1:]:
            p[:64] = out[0][:64]
    return out


def _drive(eng, req_cls, specs, vocab, shared=False, cancel_after=None):
    """Submit the requests, serve them (cancelling uid 0 after
    ``cancel_after`` chunks) → {uid: (tokens, cancelled, failed)}."""
    for i, (p, (_, mn)) in enumerate(zip(_prompts(specs, vocab, shared),
                                         specs)):
        eng.submit(req_cls(uid=i, prompt=p, max_new_tokens=mn))
    eng.start()
    chunks = 0
    while eng.pending():
        if chunks == cancel_after:
            eng.cancel(0)
        eng.step_serve()
        chunks += 1
    return {r.uid: (np.asarray(r.output).tolist(), r.cancelled, r.failed)
            for r in eng._done}


def _serve(cfg, params, shards: int, specs=SPECS, kw=None,
           cancel_after=None, faults=None, shared=False) -> dict:
    """One port engine run (one device, or this rank of ``shards``)."""
    plan = None if faults is None else FaultPlan(
        [FaultSpec(**f) for f in faults])
    eng = PagedServingEngine(cfg, params, **GEOM, mesh_shards=shards,
                             faults=plan, device="cpu", **(kw or {}))
    out = _drive(eng, Request, specs, cfg.vocab_size, shared, cancel_after)
    if shards > 1:
        eng.verify_invariants()
    lc = eng._state.caches[0]
    return dict(
        out=out, blocks_consumed=eng.blocks_consumed,
        shared_block_hits=eng.shared_block_hits,
        quarantined=[r.uid for r in eng.quarantined],
        fired=None if plan is None else [
            (e.site, e.kind, e.visit, e.ctx) for e in plan.fired()],
        heads={lc["kv"].k.shape[2], lc["kv"].meta_ids.shape[1],
               lc["hist"].shape[1]})


def _serve_rank(rank, cfg, params, shards, cases):
    torch.set_num_threads(1)
    return {name: _serve(cfg, params, shards, **case)
            for name, case in cases.items()}


def _jax_serve(cfg, params, specs=SPECS, kw=None, cancel_after=None,
               faults=None, shared=False, paged=True):
    from repro.serving import PagedServingEngine, Request, ServingEngine
    from repro.serving.faults import FaultPlan, FaultSpec
    plan = None if faults is None else FaultPlan(
        [FaultSpec(**f) for f in faults])
    extra = {} if plan is None else dict(faults=plan)
    if paged:
        eng = PagedServingEngine(cfg, params, **GEOM, **extra, **(kw or {}))
    else:
        eng = ServingEngine(cfg, params, n_max=GEOM["n_max"],
                            max_batch=GEOM["max_batch"],
                            chunk_size=GEOM["chunk_size"], **extra,
                            **(kw or {}))
    out = _drive(eng, Request, specs, cfg.vocab_size, shared, cancel_after)
    return dict(out=out, quarantined=[r.uid for r in eng.quarantined],
                fired=None if plan is None else [
                    (e.site, e.kind, e.visit, e.ctx) for e in plan.fired()])


@functools.lru_cache(maxsize=None)
def _params(model):
    """The reference's float32 smoke config and params (×8, so that greedy
    outputs vary), and the port's copies."""
    import jax
    from repro import configs as JC
    from repro.models import model as JM
    cfg_j = dataclasses.replace(JC.smoke(model), dtype="float32")
    cfg_t = dataclasses.replace(TC.smoke(model), dtype="float32")
    pj = jax.tree.map(lambda a: a * 8.0,
                      JM.init_params(cfg_j, jax.random.PRNGKey(0)))
    return cfg_j, pj, cfg_t, convert.params_from_jax(jax.device_get(pj),
                                                     cfg_t, device="cpu")


def _jax_ref(model, case):
    """One case on the reference's one-device paged engine ("contiguous":
    the fused case on its contiguous engine)."""
    cfg_j, pj = _params(model)[:2]
    if case == "contiguous":
        return _jax_serve(cfg_j, pj, paged=False)
    return _jax_serve(cfg_j, pj, **CASES[case])


@pytest.fixture(scope="module")
def started():
    """Every process this module needs, started at once and run while the
    tests read their results: each model's ranks (``_serve_rank``), the
    reference's engine runs and the drift loop (four processes), and,
    once the drift loop is done, the retrieval ranks."""
    params = {model: _params(model) for model in MODELS}
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ThreadPoolExecutor(len(MODELS) + 1) as threads, \
            concurrent.futures.ProcessPoolExecutor(
                4, mp_context=spawn) as procs:
        drift = procs.submit(_drift_checkpoints)

        def retrieval():
            points = drift.result(timeout=3 * TIMEOUT_S)
            return points, launch_local(_retrieve_rank, R_SHARDS, "gloo",
                                        TIMEOUT_S, args=(points,))
        yield dict(
            params=params, retrieval=threads.submit(retrieval),
            refs={model: {case: procs.submit(_jax_ref, model, case)
                          for case in (*CASES, "contiguous")}
                  for model in MODELS},
            ranks={model: threads.submit(
                launch_local, _serve_rank, shards, "gloo", TIMEOUT_S,
                args=(params[model][2], params[model][3], shards, CASES))
                for model, shards in MODELS.items()})


@pytest.fixture(scope="module")
def served(started):
    """model → its ranks' runs of every case, the port's one-device runs
    (served here) and the reference's (the contiguous engine's under
    "contiguous"), each served once."""
    cache = {}

    def get(model):
        if model not in cache:
            _, _, cfg_t, pt = started["params"][model]
            single = {name: _serve(cfg_t, pt, 1, **case)
                      for name, case in CASES.items()}
            cache[model] = dict(
                ranks=started["ranks"][model].result(), single=single,
                jax={case: ref.result(timeout=3 * TIMEOUT_S)
                     for case, ref in started["refs"][model].items()},
                G=cfg_t.num_kv_heads, shards=MODELS[model])
        return cache[model]
    return get


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("model", list(MODELS))
def test_sharded_engine_matches_one_device(served, model, case):
    """Every rank's tokens (and cancel / failure flags) equal the
    reference's one-device paged engine's and the port's one-device
    engine's; block counters, quarantines and the fault log equal the
    port's one-device run's (and the reference's, where it has them);
    each rank holds G / N heads of the pool, metadata and histograms."""
    runs = served(model)
    single, want = runs["single"][case], runs["jax"][case]
    assert single["out"] == want["out"], "one-device port vs reference"
    for rank, got in enumerate(runs["ranks"]):
        got = got[case]
        assert got["out"] == want["out"], f"rank {rank}"
        for key in ("blocks_consumed", "shared_block_hits"):
            assert got[key] == single[key], (rank, key)
        assert got["quarantined"] == single["quarantined"] \
            == want["quarantined"], rank
        assert got["fired"] == single["fired"] == want["fired"], rank
        assert got["heads"] == {runs["G"] // runs["shards"]}, rank
    if case == "share":
        assert single["shared_block_hits"] > 0
    if case == "cancel":
        assert want["out"][0][1] and 0 < len(want["out"][0][0]) < 24
    if case == "quarantine":
        assert want["quarantined"] == [0] and want["out"][0][2]


@pytest.mark.parametrize("model", list(MODELS))
def test_sharded_matches_contiguous_reference(served, model):
    """The sharded paged engine also equals the reference's contiguous
    one-device ``ServingEngine`` end to end."""
    runs = served(model)
    want = runs["jax"]["contiguous"]["out"]
    for rank, got in enumerate(runs["ranks"]):
        assert got["fused"]["out"] == want, f"rank {rank}"


# ----------------------------------------------------------- retrieval ----
R_CFG = dict(sink_size=16, local_size=64, update_interval=32, top_k=32,
             min_candidates=64)
R_D, R_G, R_H = 64, 4, 8
R_SHARDS = 4


def _drift_checkpoints():
    """The reference's drift loop (``tests/test_sharded_serving.py``): at
    each checkpoint the pool metadata, tables, histogram, region ends and
    encoded query as numpy, and the one-device ``retrieve_paged_fused``
    result."""
    import jax
    import jax.numpy as jnp
    from repro.core import cache as JCC
    from repro.core import encode as JE
    from repro.core import retrieval as JR
    from repro.core import srht as JS
    from repro.core.config import ParisKVConfig as JP
    cfg = JP(**R_CFG)
    signs = jnp.asarray(JS.rademacher_signs(cfg.padded_dim(R_D),
                                            cfg.srht_seed))
    bs, nblk, num_blocks, b = 32, 8, 20, 2
    lens = np.asarray([128, 40], np.int32)
    n_max = bs * nblk
    S = int(lens.max())
    k = jax.random.normal(jax.random.PRNGKey(0), (b, S, R_G, R_D)) \
        * jnp.linspace(2.0, 0.2, R_D)
    v = jax.random.normal(jax.random.PRNGKey(1), (b, S, R_G, R_D))
    pool = JCC.init_paged_cache(num_blocks, bs, R_G, R_D, cfg)
    perm = np.random.RandomState(0).permutation(num_blocks)
    bt = np.stack([perm[i * nblk:(i + 1) * nblk] for i in range(b)]
                  ).astype(np.int32)
    regions, hists = None, []
    # jitted: eager JAX would compile every primitive apart
    prefill = jax.jit(JCC.prefill_write, static_argnums=(3,))
    scatter = jax.jit(JCC.paged_scatter_prefill)
    for i in range(b):
        c1 = JCC.init_layer_cache(1, n_max, R_G, R_D, cfg)
        c1, r1 = prefill(c1, k[i:i + 1], v[i:i + 1], cfg, signs,
                         lengths=jnp.asarray(lens[i:i + 1]))
        stacked = scatter(
            JCC.PagedLayerKVCache(*jax.tree.map(lambda a: a[None], pool)),
            jax.tree.map(lambda a: a[None], c1), jnp.asarray(bt[i]))
        pool = jax.tree.map(lambda a: a[0], stacked)
        hists.append(JCC.bucket_hist_from_meta(c1.meta_ids, r1, cfg))
        regions = (r1 if regions is None else JCC.CacheRegions(
            pos=jnp.concatenate([regions.pos, r1.pos]),
            enc_end=jnp.concatenate([regions.enc_end, r1.enc_end])))
    hist = jnp.concatenate(hists)
    btj = jnp.asarray(bt)
    C = cfg.candidate_count(n_max)

    @jax.jit
    def step_fn(pool, hist, regions, kt):
        pool = JCC.paged_decode_append(pool, btj, kt, kt, regions.pos + 1)
        regions = regions._replace(pos=regions.pos + 1)
        return JCC.paged_maybe_promote_hist(pool, hist, btj, regions, cfg,
                                            signs)

    ref_fn = jax.jit(lambda pool, qt, hist, enc: JR.retrieve_paged_fused(
        pool, btj, qt, hist, enc, cfg, C, cfg.top_k))
    rng = jax.random.PRNGKey(2)
    promotions, points = 0, []
    for step in range(80):
        rng, sub, qr = jax.random.split(rng, 3)
        kt = jax.random.normal(sub, (b, R_G, R_D))
        enc_before = np.asarray(regions.enc_end).copy()
        pool, hist, regions = step_fn(pool, hist, regions, kt)
        promotions += int((np.asarray(regions.enc_end) != enc_before).any())
        if step % 16 == 0 or step == 79:
            q = jax.random.normal(qr, (b, R_G, R_H // R_G, R_D))
            qt = JE.encode_query(q, cfg, signs)
            ref = ref_fn(pool, qt, hist, regions.enc_end)
            points.append(dict(
                step=step, C=C, bt=bt,
                pool=[np.asarray(a) for a in pool],
                hist=np.asarray(hist),
                enc=np.array(regions.enc_end),
                q_norm=np.asarray(qt.q_norm), q_sub=np.asarray(qt.q_sub),
                ref={f: np.asarray(getattr(ref, f))
                     for f in JR.PagedRetrievalResult._fields}))
    assert promotions >= 2, "the loop never exercised post-promotion drift"
    return points


def _retrieval_inputs(pt, heads=slice(None)):
    """One checkpoint's port inputs, on KV heads ``heads``."""
    k, v, ids, codes, w = pt["pool"]
    pool = TCC.PagedLayerKVCache(
        torch.from_numpy(k[:, :, heads].astype(np.float32)),
        torch.from_numpy(v[:, :, heads].astype(np.float32)),
        torch.from_numpy(ids[:, heads].copy()),
        torch.from_numpy(codes[:, heads].view(np.int32).copy()),
        torch.from_numpy(w[:, heads].copy()))
    qt = TE.QueryTransform(torch.from_numpy(pt["q_norm"][:, heads].copy()),
                           torch.from_numpy(pt["q_sub"][:, heads].copy()))
    return (pool, torch.from_numpy(pt["bt"]), qt,
            torch.from_numpy(pt["hist"][:, heads].copy()),
            torch.from_numpy(pt["enc"]))


def _retrieve_rank(rank, points):
    torch.set_num_threads(1)
    dist = ShardDist.from_process_group(R_SHARDS)
    g0, g1 = dist.head_range(R_G)
    cfg = TP(**R_CFG)
    out = []
    for pt in points:
        res = TR.retrieve_paged_fused_sharded(
            *_retrieval_inputs(pt, slice(g0, g1)), cfg, pt["C"], cfg.top_k,
            dist)
        out.append({f: getattr(res, f).numpy() for f in res._fields})
    # bf16 and bool leaves cross the gather bit for bit too
    x = torch.arange(6, dtype=torch.float32).reshape(1, 2, 3) + 1e-3 * rank
    got = dist.all_gather_heads(x.to(torch.bfloat16), 1)
    want = torch.cat([torch.arange(6, dtype=torch.float32).reshape(1, 2, 3)
                      + 1e-3 * r for r in range(R_SHARDS)], 1)
    assert torch.equal(got, want.to(torch.bfloat16))
    flags = dist.all_gather_heads(torch.tensor([[rank % 2 == 0]]), 1)
    assert flags.tolist() == [[r % 2 == 0 for r in range(R_SHARDS)]]
    return out


def test_sharded_retrieval_matches_one_device_across_drift(started):
    points, ranks = started["retrieval"].result()
    cfg = TP(**R_CFG)
    for i, pt in enumerate(points):
        one = TR.retrieve_paged_fused(*_retrieval_inputs(pt), cfg, pt["C"],
                                      cfg.top_k)
        ref = pt["ref"]
        for rank, got in enumerate(ranks):
            msg = f"rank {rank}, step {pt['step']}"
            for f in one._fields:
                np.testing.assert_array_equal(got[i][f],
                                              getattr(one, f).numpy(),
                                              err_msg=f"{f}, {msg}")
            for f in ("indices", "block_ids", "phys_rows", "cand_indices",
                      "coarse_scores"):
                np.testing.assert_array_equal(got[i][f], ref[f],
                                              err_msg=f"{f} vs JAX, {msg}")
            # Stage-II estimates: float32 sums in another order
            np.testing.assert_allclose(got[i]["scores"], ref["scores"],
                                       rtol=1e-5, atol=1e-4, err_msg=msg)


# --------------------------------------------------------------- gates ----
@pytest.fixture(scope="module")
def stablelm():
    cfg = dataclasses.replace(TC.smoke("stablelm-1.6b"), dtype="float32")
    from repro_torch.models.model import init_params
    return cfg, init_params(cfg, seed=0, device="cpu")


def test_uneven_head_split_rejected(stablelm):
    """A shard count that does not divide num_kv_heads is refused up front
    (before any process-group lookup)."""
    cfg = dataclasses.replace(TC.smoke("qwen2-1.5b"), dtype="float32")
    from repro_torch.models.model import init_params
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="num_kv_heads"):
        PagedServingEngine(cfg, params, n_max=128, max_batch=1,
                           block_size=64, mesh_shards=4, device="cpu")


def test_missing_process_group_names_torchrun(stablelm):
    cfg, params = stablelm
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="torchrun.*init_process_group"):
        PagedServingEngine(cfg, params, n_max=128, max_batch=1,
                           block_size=64, mesh_shards=2, device="cpu")


def test_mesh_plus_offload_rejected(stablelm):
    cfg, params = stablelm
    assert TSV.sharded_supported(cfg)
    with pytest.raises(TSV.UnsupportedShardedConfig, match="offload"):
        PagedServingEngine(cfg, params, n_max=128, max_batch=1,
                           block_size=64, offload=True, mesh_shards=2,
                           device="cpu")


def _raise_on_rank_1(rank, *_):
    if rank == 1:
        raise KeyError("rank 1 fails")
    torch.distributed.barrier()             # rank 0 waits for rank 1


def _hang(rank):
    time.sleep(60)


@pytest.mark.parametrize("fn,match", [
    (_raise_on_rank_1, "KeyError: 'rank 1 fails'"),
    (_hang, "did not finish")])
def test_launch_local_fails_fast(fn, match):
    """A rank that raises fails the launch at once with its traceback,
    and a hung rank at the timeout; no rank outlives the call."""
    t0 = time.monotonic()
    with pytest.raises(RankError, match=match):
        launch_local(fn, 2, "gloo", timeout_s=5.0)
    assert time.monotonic() - t0 < 30


def _slow(seconds):
    """Unpickled in each spawned rank before it starts: a slow start."""
    time.sleep(seconds)


class _SlowStart:
    def __reduce__(self):
        return _slow, (6.0,)


@pytest.mark.parametrize("backend,args,match", [
    ("no-such-backend", (), "no-such-backend"),
    ("gloo", (_SlowStart(),), "KeyError: 'rank 1 fails'")],
    ids=["raises", "slow"])
def test_launch_local_start(backend, args, match):
    """The start (spawn, import, rendezvous) has a bound of its own:
    a rank that raises while joining the group fails the launch at once
    with its traceback, and a start slower than ``timeout_s`` is not a
    hang — the clock of ``fn`` starts when every rank has joined."""
    t0 = time.monotonic()
    with pytest.raises(RankError, match=match) as err:
        launch_local(_raise_on_rank_1, 2, backend, timeout_s=5.0, args=args)
    assert time.monotonic() - t0 < 30
    assert "_rank_main" in str(err.value)
