"""mamba2-780m and hymba-1.5b on the port's engines against the reference,
in float32 at smoke size, with the reference's parameters (their weights
×8, so that greedy outputs vary; the SSD constants ``A_log``, ``D`` and
``dt_bias`` as drawn) carried across by ``params_from_jax``.

The engine shape is the cross-attention tests' (n_max 256, 2 slots,
blocks of 64, chunks of 4) with prompts of 90, 40 and 120 tokens:

* hymba on the fused paged engine, the meta view, the slot engine with
  ParisKV and with ``use_pariskv=False`` (whose hybrid layers retrieve
  all the same, as the reference's do), the wave engine and the
  offloaded engine (blocks of 16, 10 of 32 staged), each equal per uid
  to the reference's same engine. The wave engine prefills a
  right-aligned batch with no lengths, so its pads are real tokens to the
  recurrence: a padded request's tokens differ from the slot engine's,
  on both sides;
* hymba on two gloo ranks (``mesh_shards=2``) of a smoke variant whose
  two KV heads split: every rank equal to one device and to the
  reference's one-device paged engine (the SSM replicated, whole, on
  both ranks);
* a clean ``FaultPlan`` on the offloaded hymba engine logging the
  reference's visits;
* mamba2 on the slot and wave engines equal to the reference's, and
  refused by every paged engine at construction
  (``UnsupportedPagedConfig``), where the reference's resident engine
  fails at its first step and its offloaded engine fails every request
  after one token;
* chunked prefill and prefix sharing refused on both with the
  reference's ``ValueError`` and message.

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
from repro_torch.distributed import launch_local  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import serve as TSV  # noqa: E402
from repro_torch.serving import (PagedServingEngine, Request,  # noqa: E402
                                 ServingEngine, WaveServingEngine)

TIMEOUT_S = 90.0
GEOM = dict(n_max=256, max_batch=2, block_size=64, chunk_size=4)
SPECS = [(90, 6), (40, 8), (120, 5)]      # (prompt len, max_new), seed 7
OFFLOAD = dict(GEOM, block_size=16, offload=True, num_blocks=32,
               num_device_blocks=10)
CASES = {
    "fused": ("paged", {}),
    "metaview": ("paged", {"fused": False}),
    "slot": ("slot", {}),
    "slot_full": ("slot", {"use_pariskv": False}),
    "wave": ("wave", {}),
    "offload": ("paged", OFFLOAD),
}
MODELS = {"hymba": "hymba-1.5b", "mamba2": "mamba2-780m",
          # hymba-smoke with 4 query and 2 KV heads (d_model 256): its
          # KV heads split over two ranks
          "hymba2": "hymba-1.5b"}
MODEL_CASES = {"hymba": tuple(CASES), "mamba2": ("slot", "wave")}
SHARDS = 2
THREADS = 6                   # reference engine runs at once
FAULT = dict(site="fetch.gather", kind="delay", delay_s=0.0, count=None,
             match={"kind": "heads"})
SSD_CONSTANTS = ("['A_log']", "['D']", "['dt_bias']")


def _prompts(vocab: int):
    rng = np.random.RandomState(7)
    return [rng.randint(0, vocab, size=(n,)).astype(np.int32)
            for n, _ in SPECS]


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
        return P(cfg, params, **{**GEOM, **kw}, **dev)
    if kind == "slot":
        return S(cfg, params, n_max=GEOM["n_max"],
                 max_batch=GEOM["max_batch"],
                 chunk_size=GEOM["chunk_size"], **kw, **dev)
    return W(cfg, params, n_max=GEOM["n_max"], max_batch=GEOM["max_batch"],
             **kw, **dev)


def _run(eng, req_cls, cfg) -> dict:
    """Submit the requests (uid = index), serve them → {uid: tokens}."""
    for i, (p, (_, gen)) in enumerate(zip(_prompts(cfg.vocab_size), SPECS)):
        eng.submit(req_cls(uid=i, prompt=p, max_new_tokens=gen))
    return {r.uid: np.asarray(r.output).tolist() for r in eng.run()}


def _cfg(model, package):
    cfg = dataclasses.replace(package.smoke(MODELS[model]), dtype="float32")
    if model == "hymba2":
        cfg = dataclasses.replace(cfg, num_heads=4, num_kv_heads=2,
                                  d_model=256)
    return cfg


@functools.lru_cache(maxsize=None)
def _params(model):
    """The reference's float32 smoke config and params (×8 but the SSD
    constants), and the port's copies."""
    import jax
    from repro import configs as JC
    from repro.models import model as JM
    cfg_j, cfg_t = _cfg(model, JC), _cfg(model, TC)

    def leaf(path, a):
        if jax.tree_util.keystr(path).endswith(SSD_CONSTANTS):
            return a
        return a * 8.0
    pj = jax.tree_util.tree_map_with_path(
        leaf, JM.init_params(cfg_j, jax.random.PRNGKey(0)))
    return cfg_j, pj, cfg_t, convert.params_from_jax(jax.device_get(pj),
                                                     cfg_t, device="cpu")


def _reference(model, case):
    """The reference's engine of ``case`` (of ``CASES``; "faults": the
    offloaded engine under a clean ``FAULT`` plan; "failed": its engines
    on mamba2, which has no pool) → {(model, case): result}."""
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
    if case == "failed":
        from repro.serving import PagedServingEngine as JEngine
        try:
            _run(JEngine(cfg_j, pj, **GEOM), JRequest, cfg_j)
            resident = None
        except ValueError as exc:
            resident = str(exc)
        eng = JEngine(cfg_j, pj, **OFFLOAD)
        for i, (p, (_, gen)) in enumerate(zip(_prompts(cfg_j.vocab_size),
                                              SPECS)):
            eng.submit(JRequest(uid=i, prompt=p, max_new_tokens=gen))
        offload = {r.uid: (r.failed, len(r.output)) for r in eng.run()}
        return {(model, case): (resident, offload)}
    kind, kw = CASES[case]
    return {(model, case): _run(_engine(kind, cfg_j, pj, kw, ref=True),
                                JRequest, cfg_j)}


def _port(model, case):
    _, _, cfg_t, pt = _params(model)
    kind, kw = CASES[case]
    return _run(_engine(kind, cfg_t, pt, kw, ref=False), Request, cfg_t)


def _rank(rank, cfg, params):
    torch.set_num_threads(1)
    return _run(PagedServingEngine(cfg, params, **GEOM, mesh_shards=SHARDS,
                                   device="cpu"), Request, cfg)


@pytest.fixture(scope="module")
def runs():
    """hymba2's two-rank run started first (it runs while the reference's
    engines are served here), then the reference's run of every case of
    every model, each once, ``THREADS`` at a time."""
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        list(pool.map(_params, MODELS))
    _, _, cfg2, p2 = _params("hymba2")
    jobs = [(m, c) for m, cases in MODEL_CASES.items() for c in cases]
    jobs += [("hymba2", "fused"), ("hymba", "faults"), ("mamba2", "failed")]
    with concurrent.futures.ThreadPoolExecutor(1) as thread, \
            concurrent.futures.ThreadPoolExecutor(THREADS) as pool:
        ranks = thread.submit(launch_local, _rank, SHARDS, "gloo", TIMEOUT_S,
                              args=(cfg2, p2))
        futs = [pool.submit(_reference, *job) for job in jobs]
        want = {k: v for f in futs for k, v in f.result().items()}
        yield dict(want=want, ranks=ranks.result())


@pytest.mark.parametrize("model,case", [(m, c) for m, cases in
                                        MODEL_CASES.items() for c in cases])
def test_engines_match_reference(runs, model, case):
    got = _port(model, case)
    assert got == runs["want"][(model, case)]
    assert [len(got[u]) for u in sorted(got)] == [n for _, n in SPECS]
    assert len({t for toks in got.values() for t in toks}) > 5


def test_wave_pads_reach_the_recurrence(runs):
    """The wave engine's right-aligned batch has no lengths, so hymba's
    40-token prompt's 50 pad zeros (its wave's longest prompt has 90) run
    through the SSD recurrence and its attention: its tokens differ from
    the slot engine's on both sides (and each side's equal the other's),
    while the 90-token prompt, which has no pads, and the 120-token one,
    alone in its wave, keep theirs. (mamba2's pad state decays away
    within the 40 real tokens here: its wave and slot tokens agree.)"""
    want = runs["want"]
    wave, slot = want[("hymba", "wave")], want[("hymba", "slot")]
    assert wave[1] != slot[1]
    assert wave[0] == slot[0] and wave[2] == slot[2]
    assert want[("mamba2", "wave")] == want[("mamba2", "slot")]


def test_offloaded_reads_both_tiers(runs):
    """The offloaded hymba engine (its tokens the reference's offloaded
    engine's, which are its resident engine's) reads winners from both
    tiers and pages each hybrid layer's attention half."""
    _, _, cfg, pt = _params("hymba")
    eng = PagedServingEngine(cfg, pt, **OFFLOAD, device="cpu")
    assert len(eng._names) == sum(TSV.pool_layers(cfg)) == cfg.num_layers
    got = _run(eng, Request, cfg)
    assert got == runs["want"][("hymba", "offload")] == \
        runs["want"][("hymba", "fused")]
    assert sum(r.staging_misses for r in eng._done) > 0
    assert sum(r.staging_hits for r in eng._done) > 0


def test_sharded_matches_one_device(runs):
    """Two gloo ranks, each holding one of hymba2's two KV heads of the
    pool and the SSM state whole: each rank's tokens equal one device's
    and the reference's one-device paged engine's."""
    single = _port("hymba2", "fused")
    assert len(runs["ranks"]) == SHARDS
    for rank, got in enumerate(runs["ranks"]):
        assert got == single == runs["want"][("hymba2", "fused")], \
            f"rank {rank}"


def test_fault_plan_visits_as_reference(runs):
    """The offloaded hymba engine under a clean fault plan (delay 0 at
    every winner fetch): the plan logs the reference's visits, all at the
    stage's one entry name ``s0.l0`` (its repeats share it), and the
    tokens are the reference's."""
    from repro_torch.serving import FaultPlan, FaultSpec
    _, _, cfg_t, pt = _params("hymba")
    want, jplan = runs["want"][("hymba", "faults")]
    tplan = FaultPlan([FaultSpec(**FAULT)])
    got = _run(PagedServingEngine(cfg_t, pt, faults=tplan, device="cpu",
                                  **OFFLOAD), Request, cfg_t)
    assert got == want

    def log(plan):
        return [(e.site, e.kind, e.visit, e.ctx) for e in plan.fired()]
    assert log(tplan) == log(jplan) and log(tplan)
    assert {e.ctx["name"] for e in tplan.fired()} == {"s0.l0"}


@pytest.mark.parametrize("kw", [{}, {"fused": False}, {"offload": True},
                                {"mesh_shards": 2}],
                         ids=["fused", "metaview", "offload", "sharded"])
def test_mamba2_refused_by_paged_engines(kw):
    """mamba2 has no ParisKV layer, so nothing to page: every paged engine
    raises ``UnsupportedPagedConfig`` at construction, naming stage 0,
    layer 0, mixer 'ssm' (head sharding before it looks for a process
    group)."""
    _, _, cfg, pt = _params("mamba2")
    with pytest.raises(TSV.UnsupportedPagedConfig,
                       match="no ParisKV attention layer to page") as err:
        PagedServingEngine(cfg, pt, **{**GEOM, **kw}, device="cpu")
    assert (err.value.stage, err.value.layer, err.value.mixer) == (0, 0,
                                                                   "ssm")


def test_reference_paged_engines_fail_on_mamba2(runs):
    """What the port refuses up front, the reference fails at run time:
    its resident paged engine raises ``ValueError`` at its first step, its
    offloaded engine fails every request after one token."""
    resident, offload = runs["want"][("mamba2", "failed")]
    assert resident == "no PagedLayerKVCache leaf in caches"
    assert offload == {u: (True, 1) for u in range(len(SPECS))}


@pytest.mark.parametrize("model", ["hymba", "mamba2"])
def test_chunked_and_sharing_refused_as_reference(model):
    """Chunked prefill and prefix sharing refuse both families with the
    reference's ``ValueError`` and message (an SSD recurrence has no
    chunk-resumable prefill; the layer named ``stage 0 layer 0``)."""
    from repro.models import serve as JSV
    from repro.serving import PagedServingEngine as JEngine
    from repro.serving import ServingEngine as JSlot
    cfg_j, pj, cfg_t, pt = _params(model)
    assert TSV.fill_support_reason(cfg_t) == JSV.fill_support_reason(cfg_j)
    assert TSV.share_support_reason(cfg_t) == JSV.share_support_reason(cfg_j)
    mixer = "hybrid" if model == "hymba" else "ssm"
    assert (f"stage 0 layer 0 mixer '{mixer}' has no chunk-resumable "
            f"prefill") in TSV.fill_support_reason(cfg_t)
    cases = [(JSlot, ServingEngine, dict(prefill_budget=8)),
             (JEngine, PagedServingEngine,
              dict(prefill_budget=8, share_prefixes=True))]
    if model == "hymba":            # mamba2's paged engine refuses first
        cases.append((JEngine, PagedServingEngine, dict(prefill_budget=8)))
    for make_j, make_t, kw in cases:
        with pytest.raises(ValueError) as want:
            make_j(cfg_j, pj, n_max=256, max_batch=1, **kw)
        with pytest.raises(ValueError, match="chunk-resumable") as got:
            make_t(cfg_t, pt, n_max=256, max_batch=1, device="cpu", **kw)
        assert str(got.value) == str(want.value)
