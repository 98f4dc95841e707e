"""gemma2 and gemma3 on the port's engines against the reference, in
float32 at smoke size, with the reference's parameters (×8, so that greedy
outputs vary; gemma3's zero-initialized qk-norm scales set to seeded
values, so that qk-norm is not the identity) carried across by
``params_from_jax``.

The engine shape is the reference's (n_max 256, 2 slots, blocks of 64,
chunks of 4) and the prompts (90, 6), (40, 8), (130, 5) wrap the smoke
window of 64 in prefill and in decode:

* gemma2-smoke (one local and one global layer): the fused paged engine,
  the meta view, the slot engine, the wave engine, and chunked prefill at
  budget 8 and at budget 100 (a chunk longer than the ring), each equal
  to the reference's same engine per uid; the offloaded engine (blocks of
  16, 10 of 32 staged) equal to the reference's resident one; sharing
  refused with the reference's message; two gloo ranks
  (``mesh_shards=2``) fused and chunked, every rank equal to one device
  and to the reference;
* gemma2-smoke offloaded and chunked under a clean fault plan: the plan
  logs the reference's visits, all at the global layer's entry;
* gemma3-smoke (five local layers and one global, qk-norm): fused paged
  and chunked;
* gemma3-smoke at head_dim 256 (B = 32 subspaces, Hg = 2): fused paged,
  Stage I, the cut and ``bucket_count`` at B = 32 end to end.

One reference engine run per case. The ranks import this module, so JAX
and the reference are imported inside the helpers that use them."""
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
SPECS = [(90, 6), (40, 8), (130, 5)]      # (prompt len, max_new), seed 7
# case → (engine, its options)
CASES = {
    "fused": ("paged", {}),
    "metaview": ("paged", {"fused": False}),
    "slot": ("slot", {}),
    "wave": ("wave", {}),
    "chunked": ("paged", {"prefill_budget": 8}),
    "chunked_wrap": ("paged", {"prefill_budget": 100}),
}
# model → the cases run on it
MODELS = {
    "gemma2": ("gemma2-27b", {}, list(CASES)),
    "gemma3": ("gemma3-12b", {}, ["fused", "chunked"]),
    "gemma3_hd256": ("gemma3-12b", {"head_dim": 256}, ["fused"]),
}
SHARDED = ("fused", "chunked")
SHARDS = 2


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
        return P(cfg, params, **GEOM, **kw, **dev)
    if kind == "slot":
        return S(cfg, params, n_max=GEOM["n_max"],
                 max_batch=GEOM["max_batch"],
                 chunk_size=GEOM["chunk_size"], **kw, **dev)
    return W(cfg, params, n_max=GEOM["n_max"], max_batch=GEOM["max_batch"],
             **kw, **dev)


def _run(eng, req_cls, vocab: int) -> dict:
    """Submit the requests (uid = index), serve them → {uid: tokens}."""
    for i, (p, (_, gen)) in enumerate(zip(_prompts(vocab), SPECS)):
        eng.submit(req_cls(uid=i, prompt=p, max_new_tokens=gen))
    return {r.uid: np.asarray(r.output).tolist() for r in eng.run()}


@functools.lru_cache(maxsize=None)
def _params(model):
    """The reference's float32 smoke config and params (×8, qk-norm
    scales seeded), and the port's copies."""
    import jax
    import jax.numpy as jnp
    from repro import configs as JC
    from repro.models import model as JM
    arch, extra, _ = MODELS[model]
    cfg_j = dataclasses.replace(JC.smoke(arch), dtype="float32", **extra)
    cfg_t = dataclasses.replace(TC.smoke(arch), dtype="float32", **extra)
    rng = np.random.RandomState(11)

    def leaf(path, a):
        if jax.tree_util.keystr(path).endswith(("['q_norm']", "['k_norm']")):
            return jnp.asarray(0.5 * rng.standard_normal(a.shape),
                               jnp.float32)
        return a * 8.0
    pj = jax.tree_util.tree_map_with_path(
        leaf, JM.init_params(cfg_j, jax.random.PRNGKey(0)))
    return cfg_j, pj, cfg_t, convert.params_from_jax(jax.device_get(pj),
                                                     cfg_t, device="cpu")


def _reference(model, case):
    """One reference engine run of ``case`` → {uid: tokens}."""
    from repro.serving import Request as JRequest
    cfg_j, pj = _params(model)[:2]
    kind, kw = CASES[case]
    return _run(_engine(kind, cfg_j, pj, kw, ref=True), JRequest,
                cfg_j.vocab_size)


def _port(model, case, shards: int = 1, **extra):
    _, _, cfg_t, pt = _params(model)
    kind, kw = CASES[case]
    kw = {**kw, **extra}
    if shards > 1:
        kw["mesh_shards"] = shards
    return _run(_engine(kind, cfg_t, pt, kw, ref=False), Request,
                cfg_t.vocab_size)


def _rank(rank, cfg, params, cases):
    torch.set_num_threads(1)
    out = {}
    for case in cases:
        kind, kw = CASES[case]
        eng = PagedServingEngine(cfg, params, **GEOM, **kw,
                                 mesh_shards=SHARDS, device="cpu")
        out[case] = _run(eng, Request, cfg.vocab_size)
    return out


@pytest.fixture(scope="module")
def runs():
    """gemma2-smoke's two-rank run started first (it runs while the
    reference's engines are served here), then the reference's run of
    every case of every model, each once."""
    _, _, cfg_t, pt = _params("gemma2")
    with concurrent.futures.ThreadPoolExecutor(1) as thread:
        ranks = thread.submit(launch_local, _rank, SHARDS, "gloo", TIMEOUT_S,
                              args=(cfg_t, pt, SHARDED))
        want = {(model, case): _reference(model, case)
                for model, (_, _, cases) in MODELS.items() for case in cases}
        yield dict(want=want, ranks=ranks.result())


@pytest.mark.parametrize("model,case", [
    (model, case) for model, (_, _, cases) in MODELS.items()
    for case in cases])
def test_engines_match_reference(runs, model, case):
    got = _port(model, case)
    assert got == runs["want"][(model, case)]
    assert [len(got[u]) for u in sorted(got)] == [n for _, n in SPECS]
    assert len({t for toks in got.values() for t in toks}) > 5


def test_gemma2_offloaded_matches_reference_resident(runs):
    """The offloaded engine emits the resident engine's tokens, which are
    the reference's, with winners read from both tiers. Blocks of 16 (10
    of 32 staged): a decoding slot pins its sink and window blocks, so
    blocks of 64 would keep every block staged."""
    _, _, cfg, pt = _params("gemma2")
    eng = PagedServingEngine(cfg, pt, **{**GEOM, "block_size": 16},
                             offload=True, num_blocks=32,
                             num_device_blocks=10, device="cpu")
    for i, (p, (_, gen)) in enumerate(zip(_prompts(cfg.vocab_size), SPECS)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=gen))
    done = eng.run()
    assert {r.uid: r.output.tolist() for r in done} == \
        runs["want"][("gemma2", "fused")]
    assert sum(r.staging_misses for r in done) > 0
    assert sum(r.staging_hits for r in done) > 0


@pytest.mark.parametrize("case", SHARDED)
def test_gemma2_sharded_matches_one_device(runs, case):
    single = _port("gemma2", case)
    for rank, got in enumerate(runs["ranks"]):
        assert got[case] == single == runs["want"][("gemma2", case)], \
            f"rank {rank}"


def test_sharing_refuses_ring_layers_as_reference():
    """Sharing refuses a local layer's slot-local ring with the reference's
    ``ValueError`` and message."""
    from repro.models import serve as JSV
    from repro.serving import PagedServingEngine as JEngine
    cfg_j, pj, cfg_t, pt = _params("gemma2")
    assert TSV.share_support_reason(cfg_t) == JSV.share_support_reason(cfg_j)
    assert "ring buffer" in TSV.share_support_reason(cfg_t)
    assert TSV.fill_supported(cfg_t) and TSV.sharded_supported(cfg_t)
    assert TSV.offload_support_reason(cfg_t) is None
    kw = dict(n_max=256, max_batch=1, prefill_budget=8, share_prefixes=True)
    with pytest.raises(ValueError) as want:
        JEngine(cfg_j, pj, **kw)
    with pytest.raises(ValueError, match="ring buffer") as got:
        PagedServingEngine(cfg_t, pt, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_gemma2_fault_plan_visits_global_layers_as_reference():
    """The offloaded engine under a clean fault plan (delay 0 at every
    fetch) with chunked prefill: the plan logs the reference's visits —
    only the global layer's entry fetches (``s0.l1``: winner heads each
    decode step, fill prefix rows each mixed step); the local layer's ring
    fetches nothing — and the tokens are the reference's."""
    from repro.serving import PagedServingEngine as JEngine
    from repro.serving import Request as JRequest
    from repro.serving.faults import FaultPlan as JPlan
    from repro.serving.faults import FaultSpec as JSpec
    from repro_torch.serving import FaultPlan, FaultSpec
    cfg_j, pj, cfg_t, pt = _params("gemma2")
    specs = [dict(site="fetch.gather", kind="delay", delay_s=0.0, count=None,
                  match={"kind": k}) for k in ("heads", "rows")]
    kw = dict(GEOM, block_size=16, offload=True, num_blocks=32,
              num_device_blocks=10, prefill_budget=8)
    jplan, tplan = (JPlan([JSpec(**s) for s in specs]),
                    FaultPlan([FaultSpec(**s) for s in specs]))
    want = _run(JEngine(cfg_j, pj, faults=jplan, **kw), JRequest,
                cfg_j.vocab_size)
    got = _run(PagedServingEngine(cfg_t, pt, faults=tplan, device="cpu",
                                  **kw), Request, cfg_t.vocab_size)
    assert got == want

    def log(plan):
        return [(e.site, e.kind, e.visit, e.ctx) for e in plan.fired()]
    assert log(tplan) == log(jplan)
    assert {e.ctx["name"] for e in tplan.fired()} == {"s0.l1"}
    assert {e.ctx["kind"] for e in tplan.fired()} == {"heads", "rows"}
