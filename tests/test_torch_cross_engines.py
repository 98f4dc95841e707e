"""whisper-large-v3 and llama-3.2-vision-11b on the port's engines against
the reference, in float32 at smoke size, with the reference's parameters
(×8, so that greedy outputs vary) carried across by ``params_from_jax``.
Every request carries its own stub media (``media_stub``, one seed per
uid). The vision model's cross layer would add nothing a greedy token
could show: its gate is zero at init (tanh(0) = 0), the stub's 0.02 media
give it a near-uniform softmax whose mixture averages the media out, and
the ×8 MLPs before it grow the residual to an rms of ~1,500 against its
output's ~6. So its gate is seeded in (0.3, 0.9), its media scaled to
unit variance (a projected patch embedding's scale), and its value and
output projections a further ×16, which brings its output to the
residual's order: then the media steer the tokens (the last test).

The engine shape is the gemma tests' (n_max 256, 2 slots, blocks of 64,
chunks of 4) with prompts of 90, 40 and 120 tokens:

* the fused paged engine, the meta view, the slot engine and the wave
  engine, each equal per uid to the reference's same engine;
* the offloaded engine (blocks of 16, 10 of 32 staged) equal to the
  reference's resident one, its winners read from both tiers while the
  media K/V stay on the device;
* two gloo ranks (``mesh_shards=2``, fused): every rank equal to one
  device and to the reference (the media and the cross attention
  replicated on both ranks);
* chunked prefill and prefix sharing refused with the reference's
  ``ValueError`` and message;
* a clean ``FaultPlan`` on the offloaded vision engine logging the
  reference's visits, all at the four ParisKV layers' entries, never the
  cross layer's;
* the same prompt with two different media giving different tokens, on
  the port and on the reference.

One reference engine run per case, all of them at once in a few threads
of the module fixture (JAX compiles each engine's steps anew, and XLA
compiles outside the interpreter lock). The ranks import this module, so
JAX and the reference are imported inside the helpers that use them."""
import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores, and torch's
# spinning OpenMP pool would otherwise slow each of them many times over
torch.set_num_threads(1)

from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import media_stub  # noqa: E402
from repro_torch.distributed import launch_local  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import serve as TSV  # noqa: E402
from repro_torch.serving import (PagedServingEngine, Request,  # noqa: E402
                                 ServingEngine, WaveServingEngine)

TIMEOUT_S = 90.0
GEOM = dict(n_max=256, max_batch=2, block_size=64, chunk_size=4)
SPECS = [(90, 6), (40, 8), (120, 5)]      # (prompt len, max_new), seed 7
CASES = {
    "fused": ("paged", {}),
    "metaview": ("paged", {"fused": False}),
    "slot": ("slot", {}),
    "wave": ("wave", {}),
}
MODELS = {"whisper": "whisper-large-v3", "vision": "llama-3.2-vision-11b"}
OFFLOAD = dict(GEOM, block_size=16, offload=True, num_blocks=32,
               num_device_blocks=10)
SHARDS = 2
MEDIA_SCALE = {"audio": 1.0, "vlm": 50.0}
THREADS = 6                   # reference engine runs at once
CROSS_VO_SCALE = 16.0         # the vision cross layer's wv and wo, beyond ×8
FAULT = dict(site="fetch.gather", kind="delay", delay_s=0.0, count=None,
             match={"kind": "heads"})


def _prompts(vocab: int):
    rng = np.random.RandomState(7)
    return [rng.randint(0, vocab, size=(n,)).astype(np.int32)
            for n, _ in SPECS]


def _media(cfg, uid: int, seed0: int = 20):
    """Request ``uid``'s stub media (T, d), at the model's scale."""
    return media_stub(1, TSV.media_len(cfg), cfg.d_model,
                      seed=seed0 + uid)[0] * MEDIA_SCALE[cfg.family]


def _engine(kind, cfg, params, kw, ref: bool):
    """The reference's (``ref``) or the port's engine of ``kind``."""
    if ref:
        from repro.serving import (PagedServingEngine as P,
                                   ServingEngine as S,
                                   WaveServingEngine as W)
        dev = {}
    else:
        P, S, W, dev = (PagedServingEngine, ServingEngine, WaveServingEngine,
                        {"device": "cpu"})
    if kind == "paged":
        return P(cfg, params, **GEOM, **kw, **dev)
    if kind == "slot":
        return S(cfg, params, n_max=GEOM["n_max"],
                 max_batch=GEOM["max_batch"],
                 chunk_size=GEOM["chunk_size"], **kw, **dev)
    return W(cfg, params, n_max=GEOM["n_max"], max_batch=GEOM["max_batch"],
             **kw, **dev)


def _run(eng, req_cls, cfg, seed0: int = 20) -> dict:
    """Submit the requests (uid = index, media of seed ``seed0`` + uid),
    serve them → {uid: tokens}."""
    for i, (p, (_, gen)) in enumerate(zip(_prompts(cfg.vocab_size), SPECS)):
        eng.submit(req_cls(uid=i, prompt=p, max_new_tokens=gen,
                           media=_media(cfg, i, seed0)))
    return {r.uid: np.asarray(r.output).tolist() for r in eng.run()}


@functools.lru_cache(maxsize=None)
def _params(model):
    """The reference's float32 smoke config and params (×8; the cross
    gates seeded in (0.3, 0.9), the cross layers' wv and wo ×16 more),
    and the port's copies."""
    import jax
    import jax.numpy as jnp
    from repro import configs as JC
    from repro.models import model as JM
    arch = MODELS[model]
    cfg_j = dataclasses.replace(JC.smoke(arch), dtype="float32")
    cfg_t = dataclasses.replace(TC.smoke(arch), dtype="float32")
    rng = np.random.RandomState(11)

    cross = f"['l{cfg_j.cross_attn_period - 1}']['attn']"

    def leaf(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("['cross_gate']"):
            return jnp.asarray(rng.uniform(0.3, 0.9, a.shape), jnp.float32)
        if cfg_j.family == "vlm" and key.endswith(
                (cross + "['wv']", cross + "['wo']")):
            return a * 8.0 * CROSS_VO_SCALE
        return a * 8.0
    pj = jax.tree_util.tree_map_with_path(
        leaf, JM.init_params(cfg_j, jax.random.PRNGKey(0)))
    return cfg_j, pj, cfg_t, convert.params_from_jax(jax.device_get(pj),
                                                     cfg_t, device="cpu")


def _reference(model, case):
    """The reference's engine of ``case`` (of ``CASES``, or "faults": the
    offloaded engine under a clean ``FAULT`` plan) → {(model, case):
    {uid: tokens}}; "faults" gives (tokens, the plan), and the slot
    engine also serves the media of seeds 40 + uid, as (model, "media")."""
    from repro.serving import Request as JRequest
    cfg_j, pj = _params(model)[:2]
    if case == "faults":
        from repro.serving import PagedServingEngine as JEngine
        from repro.serving.faults import FaultPlan as JPlan
        from repro.serving.faults import FaultSpec as JSpec
        plan = JPlan([JSpec(**FAULT)])
        return {(model, case): (_run(JEngine(cfg_j, pj, faults=plan,
                                             **OFFLOAD), JRequest, cfg_j),
                                plan)}
    kind, kw = CASES[case]
    eng = _engine(kind, cfg_j, pj, kw, ref=True)
    out = {(model, case): _run(eng, JRequest, cfg_j)}
    if case == "slot":               # the same engine, its steps compiled
        out[(model, "media")] = _run(eng, JRequest, cfg_j, seed0=40)
    return out


def _port(model, case):
    _, _, cfg_t, pt = _params(model)
    kind, kw = CASES[case]
    return _run(_engine(kind, cfg_t, pt, kw, ref=False), Request, cfg_t)


def _rank(rank, models):
    torch.set_num_threads(1)
    return {model: _run(PagedServingEngine(cfg, params, **GEOM,
                                           mesh_shards=SHARDS, device="cpu"),
                        Request, cfg)
            for model, (cfg, params) in models.items()}


@pytest.fixture(scope="module")
def runs():
    """Both models' two-rank run started first (it runs while the
    reference's engines are served here), then the reference's run of
    every case of every model, each once, ``THREADS`` at a time."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        models = dict(zip(MODELS, pool.map(lambda m: _params(m)[2:],
                                           MODELS)))
    jobs = [(m, c) for m in MODELS for c in CASES]
    jobs.append(("vision", "faults"))
    with concurrent.futures.ThreadPoolExecutor(1) as thread, \
            concurrent.futures.ThreadPoolExecutor(THREADS) as pool:
        ranks = thread.submit(launch_local, _rank, SHARDS, "gloo", TIMEOUT_S,
                              args=(models,))
        futs = [pool.submit(_reference, *job) for job in jobs]
        want = {k: v for f in futs for k, v in f.result().items()}
        yield dict(want=want, ranks=ranks.result())


@pytest.mark.parametrize("model,case", [(m, c) for m in MODELS
                                        for c in CASES])
def test_engines_match_reference(runs, model, case):
    got = _port(model, case)
    assert got == runs["want"][(model, case)]
    assert [len(got[u]) for u in sorted(got)] == [n for _, n in SPECS]
    assert len({t for toks in got.values() for t in toks}) > 5


@pytest.mark.parametrize("model", MODELS)
def test_offloaded_matches_reference_resident(runs, model):
    """The offloaded engine emits the resident engine's tokens, which are
    the reference's, with winners read from both tiers; the host pool
    pages the ParisKV layers only (every whisper layer, four of the
    vision model's five)."""
    _, _, cfg, pt = _params(model)
    eng = PagedServingEngine(cfg, pt, **OFFLOAD, device="cpu")
    assert len(eng._names) == sum(TSV.pool_layers(cfg)) == \
        (cfg.num_layers if model == "whisper" else 4)
    got = _run(eng, Request, cfg)
    assert got == runs["want"][(model, "fused")]
    done = eng._done
    assert sum(r.staging_misses for r in done) > 0
    assert sum(r.staging_hits for r in done) > 0


@pytest.mark.parametrize("model", MODELS)
def test_sharded_matches_one_device(runs, model):
    """Two gloo ranks, each holding half the pool's KV heads and the
    media at every head: each rank's tokens equal one device's and the
    reference's."""
    single = _port(model, "fused")
    for rank, got in enumerate(runs["ranks"]):
        assert got[model] == single == runs["want"][(model, "fused")], \
            f"rank {rank}"


@pytest.mark.parametrize("model", MODELS)
def test_chunked_and_sharing_refused_as_reference(model):
    """Chunked prefill and prefix sharing refuse both families with the
    reference's ``ValueError`` and message (media K/V come from one
    encoder pass); offload and head sharding are allowed, as there."""
    from repro.models import serve as JSV
    from repro.serving import PagedServingEngine as JEngine
    from repro.serving import ServingEngine as JSlot
    cfg_j, pj, cfg_t, pt = _params(model)
    assert TSV.fill_support_reason(cfg_t) == JSV.fill_support_reason(cfg_j)
    assert TSV.share_support_reason(cfg_t) == JSV.share_support_reason(cfg_j)
    assert "one encoder pass" in TSV.fill_support_reason(cfg_t)
    assert TSV.offload_support_reason(cfg_t) is None
    assert TSV.sharded_support_reason(cfg_t) is None
    for make_j, make_t, kw in (
            (JSlot, ServingEngine, dict(prefill_budget=8)),
            (JEngine, PagedServingEngine, dict(prefill_budget=8)),
            (JEngine, PagedServingEngine,
             dict(prefill_budget=8, share_prefixes=True))):
        with pytest.raises(ValueError) as want:
            make_j(cfg_j, pj, n_max=256, max_batch=1, **kw)
        with pytest.raises(ValueError, match="one encoder pass") as got:
            make_t(cfg_t, pt, n_max=256, max_batch=1, device="cpu", **kw)
        assert str(got.value) == str(want.value)


def test_vision_fault_plan_visits_pool_layers_as_reference(runs):
    """The offloaded vision engine under a clean fault plan (delay 0 at
    every winner fetch): the plan logs the reference's visits, at the four
    ParisKV layers' entries only (``s0.l0``–``s0.l3``; the cross layer
    ``s0.l4`` fetches nothing), and the tokens are the reference's."""
    from repro_torch.serving import FaultPlan, FaultSpec
    _, _, cfg_t, pt = _params("vision")
    want, jplan = runs["want"][("vision", "faults")]
    tplan = FaultPlan([FaultSpec(**FAULT)])
    got = _run(PagedServingEngine(cfg_t, pt, faults=tplan, device="cpu",
                                  **OFFLOAD), Request, cfg_t)
    assert got == want

    def log(plan):
        return [(e.site, e.kind, e.visit, e.ctx) for e in plan.fired()]
    assert log(tplan) == log(jplan)
    assert {e.ctx["name"] for e in tplan.fired()} == {
        f"s0.l{i}" for i in range(4)}


@pytest.mark.parametrize("model", MODELS)
def test_media_changes_tokens(runs, model):
    """The same three prompts with the media of other seeds: the port's
    slot engine emits other tokens, as the reference's does, and each
    side's equal the other's."""
    _, _, cfg_t, pt = _params(model)
    got = _run(_engine("slot", cfg_t, pt, {}, ref=False), Request, cfg_t,
               seed0=40)
    want = runs["want"]
    assert got == want[(model, "media")]
    assert want[(model, "media")] != want[(model, "slot")]
    for uid in range(len(SPECS)):
        assert got[uid] != want[(model, "slot")][uid], uid
