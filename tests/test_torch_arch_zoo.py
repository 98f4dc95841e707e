"""The architectures this slice adds to the port — llama3.1-8b and qwen3-8b
(plain dense, untied embeddings) and grok-1 (a mixture of experts on every
layer, attention and final-logit softcaps) — against the reference, in
float32 at smoke size, with the reference's parameters (×8, so that greedy
outputs vary) carried across by ``params_from_jax``:

* the layer plan, the configs in ``ARCHS``, and the refusals
  (deepseek-v2's MLA, ``UnsupportedPagedConfig`` with the reference's
  fields and message);
* engine tokens per uid at the reference's engine shape (n_max 256, 2
  slots, blocks of 64, chunks of 4, requests (33, 6), (48, 9), (70, 5)):
  llama31-smoke and qwen3-smoke on the fused paged engine; grok-smoke on
  the fused paged engine, the meta view, the slot engine, the wave
  engine, chunked prefill (``prefill_budget=8``: every chunk's capacity
  follows its 8 tokens, so these tokens differ from solo prefill's, as in
  the reference) and prefix sharing (three prompts behind one 64-token
  prefix), each equal to the reference's same engine; the offloaded
  engine equal to the reference's resident one;
* grok-smoke over two gloo ranks (``mesh_shards=2``) fused, chunked and
  sharing: every rank's tokens equal the reference's and the port's one
  device's.

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
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import serve as TSV  # noqa: E402
from repro_torch.serving import (PagedServingEngine, Request,  # noqa: E402
                                 ServingEngine, WaveServingEngine)

TIMEOUT_S = 60.0
GEOM = dict(n_max=256, max_batch=2, block_size=64, chunk_size=4)
SPECS = [(33, 6), (48, 9), (70, 5)]      # (prompt len, max_new), seed 7
SHARE_SPECS = [(80, 6), (96, 9), (140, 5)]   # behind one 64-token prefix
# case → (engine, its options, shared prefix)
GROK_CASES = {
    "fused": ("paged", {}, False),
    "metaview": ("paged", {"fused": False}, False),
    "slot": ("slot", {}, False),
    "wave": ("wave", {}, False),
    "chunked": ("paged", {"prefill_budget": 8}, False),
    "share": ("paged", {"prefill_budget": 8, "share_prefixes": True}, True),
}
SHARDED = ("fused", "chunked", "share")
SHARDS = 2


def _prompts(vocab: int, shared: bool):
    rng = np.random.RandomState(7)
    specs = SHARE_SPECS if shared else SPECS
    out = [rng.randint(0, vocab, size=(n,)).astype(np.int32)
           for n, _ in specs]
    if shared:
        for p in out[1:]:
            p[:64] = out[0][:64]
    return out, specs


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


def _run(eng, req_cls, vocab: int, shared: bool) -> dict:
    """Submit the requests (uid = index), serve them → {uid: tokens}."""
    prompts, specs = _prompts(vocab, shared)
    for i, (p, (_, gen)) in enumerate(zip(prompts, specs)):
        eng.submit(req_cls(uid=i, prompt=p, max_new_tokens=gen))
    return {r.uid: np.asarray(r.output).tolist() for r in eng.run()}


def _reference(arch, case):
    """One reference engine run of ``case`` → {uid: tokens}."""
    from repro.serving import Request as JRequest
    cfg_j, pj = _params(arch)[:2]
    kind, kw, shared = GROK_CASES[case]
    return _run(_engine(kind, cfg_j, pj, kw, ref=True), JRequest,
                cfg_j.vocab_size, shared)


def _port(cfg, params, case, shards: int = 1, **extra):
    kind, kw, shared = GROK_CASES[case]
    kw = {**kw, **extra}
    if shards > 1:
        kw["mesh_shards"] = shards
    return _run(_engine(kind, cfg, params, kw, ref=False), Request,
                cfg.vocab_size, shared)


def _rank(rank, cfg, params, cases):
    torch.set_num_threads(1)
    return {case: _port(cfg, params, case, SHARDS) for case in cases}


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's float32 smoke config and params (×8), and the
    port's copies."""
    import jax
    from repro import configs as JC
    from repro.models import model as JM
    cfg_j = dataclasses.replace(JC.smoke(arch), dtype="float32")
    cfg_t = dataclasses.replace(TC.smoke(arch), dtype="float32")
    pj = jax.tree.map(lambda a: a * 8.0,
                      JM.init_params(cfg_j, jax.random.PRNGKey(0)))
    return cfg_j, pj, cfg_t, convert.params_from_jax(jax.device_get(pj),
                                                     cfg_t, device="cpu")


@pytest.fixture(scope="module")
def grok():
    """grok-smoke: the two-rank run started first (it runs while the
    reference's engines are served here), the reference's run of every
    case, each once."""
    _, _, cfg_t, pt = _params("grok-1-314b")
    with concurrent.futures.ThreadPoolExecutor(1) as thread:
        ranks = thread.submit(launch_local, _rank, SHARDS, "gloo", TIMEOUT_S,
                              args=(cfg_t, pt, SHARDED))
        want = {case: _reference("grok-1-314b", case) for case in GROK_CASES}
        yield dict(cfg=cfg_t, params=pt, want=want, ranks=ranks.result())


def test_archs_and_layer_plans():
    assert set(TC.ARCHS) == {"qwen2-1.5b", "stablelm-1.6b", "llama3.1-8b",
                             "qwen3-8b", "grok-1-314b", "gemma2-27b",
                             "gemma3-12b", "whisper-large-v3",
                             "llama-3.2-vision-11b", "mamba2-780m",
                             "hymba-1.5b", "deepseek-v2-lite-16b"}
    from repro import configs as JC
    assert set(TC.ARCHS) == set(JC.ARCHS)
    for arch in TC.ARCHS:
        assert dataclasses.asdict(TC.get(arch)) == dataclasses.asdict(
            JC.get(arch))
        assert dataclasses.asdict(TC.smoke(arch)) == dataclasses.asdict(
            JC.smoke(arch))
    (stage,) = TM.layer_plan(TC.get("grok-1-314b"))
    assert stage.repeat == 64 and len(stage.layers) == 1
    ld = stage.layers[0]
    assert (ld.mixer, ld.ffn, ld.d_ff, ld.use_pariskv) == (
        "attn", "moe", 32_768, True)
    assert ld.attn.softcap == 30.0
    for arch in ("llama3.1-8b", "qwen3-8b"):
        (stage,) = TM.layer_plan(TC.get(arch))
        assert stage.layers[0].ffn == "mlp"
    deepseek = dataclasses.replace(TC.smoke("grok-1-314b"),
                                   name="deepseek-style", kv_lora_rank=64)
    from repro.models import model as JM
    assert [dataclasses.asdict(ld) for st in TM.layer_plan(deepseek)
            for ld in st.layers] == [
        dataclasses.asdict(ld) for st in JM.layer_plan(
            dataclasses.replace(JC.smoke("grok-1-314b"),
                                name="deepseek-style", kv_lora_rank=64))
        for ld in st.layers]
    assert dataclasses.asdict(TC.get("deepseek-v2-lite-16b")) == \
        dataclasses.asdict(JC.get("deepseek-v2-lite-16b"))
    with pytest.raises(NotImplementedError, match="not one of"):
        TC.get("deepseek-v3")
    for arch in ("mamba2-780m", "hymba-1.5b", "deepseek-v2-lite-16b"):
        plan_j, plan_t = JM.layer_plan(JC.get(arch)), TM.layer_plan(
            TC.get(arch))
        assert [(s.repeat, len(s.layers)) for s in plan_t] == \
            [(s.repeat, len(s.layers)) for s in plan_j]
        for sj, st in zip(plan_j, plan_t):
            for lj, lt in zip(sj.layers, st.layers):
                assert dataclasses.asdict(lt) == dataclasses.asdict(lj)


def test_unsupported_paged_config_matches_reference(monkeypatch):
    """The paged pool refuses an MLA layer with the reference's exception:
    the same fields and message as the reference's ``make_paged_caches``
    on deepseek-v2-lite (whose first MLA layer is stage 0, layer 0)."""
    from repro import configs as JC
    from repro.models import serve as JSV
    cfg_j = JC.smoke("deepseek-v2-lite-16b")
    with pytest.raises(JSV.UnsupportedPagedConfig) as want:
        JSV.make_paged_caches(cfg_j, 2, 8, 64, 256)
    cfg_t = dataclasses.replace(TC.smoke("qwen2-1.5b"), name=cfg_j.name)
    mla = TM.LayerDef("mla", None)
    monkeypatch.setattr(TSV, "layer_plan", lambda cfg: (
        TM.StageDef((mla,), 1), TM.StageDef((mla,), 1)))
    with pytest.raises(TSV.UnsupportedPagedConfig) as got:
        TSV.make_paged_caches(cfg_t, 2, 8, 64, "cpu")
    assert isinstance(got.value, NotImplementedError)
    for key in ("config_name", "stage", "layer", "mixer"):
        assert getattr(got.value, key) == getattr(want.value, key), key
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ["llama3.1-8b", "qwen3-8b"])
def test_dense_configs_match_reference(arch):
    from repro.serving import PagedServingEngine as JEngine
    from repro.serving import Request as JRequest
    cfg_j, pj, cfg_t, pt = _params(arch)
    want = _run(JEngine(cfg_j, pj, **GEOM), JRequest, cfg_j.vocab_size,
                False)
    got = _run(PagedServingEngine(cfg_t, pt, device="cpu", **GEOM), Request,
               cfg_t.vocab_size, False)
    assert got == want
    assert len({t for toks in got.values() for t in toks}) > 5


@pytest.mark.parametrize("case", list(GROK_CASES))
def test_grok_engines_match_reference(grok, case):
    got = _port(grok["cfg"], grok["params"], case)
    assert got == grok["want"][case]
    assert [len(got[u]) for u in sorted(got)] == [
        n for _, n in (SHARE_SPECS if case == "share" else SPECS)]


def test_grok_chunked_differs_from_solo(grok):
    """Capacity follows each prefill's padded token count, so chunked and
    solo prefill route a prompt differently and emit other tokens — in the
    reference as in the port (the tests above hold each to its twin)."""
    assert grok["want"]["chunked"] != grok["want"]["fused"]


def test_grok_offloaded_matches_reference_resident(grok):
    """The offloaded engine (2 of 8 blocks staged) emits the resident
    engine's tokens, which are the reference's."""
    got = _port(grok["cfg"], grok["params"], "fused", offload=True,
                num_blocks=8, num_device_blocks=2)
    assert got == grok["want"]["fused"]


@pytest.mark.parametrize("case", SHARDED)
def test_grok_sharded_matches_one_device(grok, case):
    single = _port(grok["cfg"], grok["params"], case)
    for rank, got in enumerate(grok["ranks"]):
        assert got[case] == single == grok["want"][case], f"rank {rank}"
