"""deepseek-v2-lite on the port's engines against the reference, in float32
at smoke size (3 layers: a dense MLA layer, then two MLA layers with a
mixture of experts and a shared expert; latent 64 + 32, B = 16, Hg = 4),
with the reference's parameters (×8, so that greedy outputs vary) carried
across by ``params_from_jax``.

The engine shape is the state-space tests' (n_max 256, 2 slots, chunks of
4) with prompts of 90, 40 and 120 tokens; the 40-token request decodes 20
tokens, past its first promotion:

* the slot engine with ParisKV and with ``use_pariskv=False`` (whose MLA
  layers retrieve and promote all the same, as the reference's do: no
  full-attention baseline for this architecture) and the wave engine,
  each equal per uid to the reference's same engine at the same batch
  shape. The reference's MLA prefill takes no lengths, so the wave
  engine's right-aligned pads are real tokens to it: parity holds per
  engine, never wave against slot;
* every paged engine (fused, meta view, offloaded) refusing at
  construction with ``UnsupportedPagedConfig``, the reference's fields
  and message (the reference's resident engine raises it when it builds
  its pool); ``mesh_shards=2`` refusing with ``UnsupportedShardedConfig``
  naming 'mla', as the reference's ``test_mesh_plus_mla_rejected``;
* the offload and shard reasons equal to the reference's strings;
* chunked prefill and prefix sharing refused with the reference's
  ``ValueError`` and message;
* the serving CLI on the CPU.

One reference engine run per case, all at once in a few threads of the
module fixture (XLA compiles outside the interpreter lock)."""
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
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import serve as TSV  # noqa: E402
from repro_torch.serving import (PagedServingEngine, Request,  # noqa: E402
                                 ServingEngine, WaveServingEngine)

ARCH = "deepseek-v2-lite-16b"
GEOM = dict(n_max=256, max_batch=2, chunk_size=4)
SPECS = [(90, 6), (40, 20), (120, 5)]      # (prompt len, max_new), seed 7
CASES = {"slot": ("slot", {}), "slot_full": ("slot", {"use_pariskv": False}),
         "wave": ("wave", {})}
PAGED = {"fused": {}, "metaview": {"fused": False},
         "offload": {"offload": True, "num_blocks": 16,
                     "num_device_blocks": 4}}


def _prompts(vocab: int):
    rng = np.random.RandomState(7)
    return [rng.randint(0, vocab, size=(n,)).astype(np.int32)
            for n, _ in SPECS]


def _cfg(package, dtype="float32"):
    return dataclasses.replace(package.smoke(ARCH), dtype=dtype)


@functools.lru_cache(maxsize=None)
def _params():
    """The reference's float32 smoke config and params (×8), and the
    port's copies."""
    import jax
    from repro import configs as JC
    from repro.models import model as JM
    cfg_j, cfg_t = _cfg(JC), _cfg(TC)
    pj = jax.tree.map(lambda a: a * 8.0,
                      JM.init_params(cfg_j, jax.random.PRNGKey(0)))
    return cfg_j, pj, cfg_t, convert.params_from_jax(jax.device_get(pj),
                                                     cfg_t, device="cpu")


def _engine(kind, cfg, params, kw, ref: bool):
    """The reference's (``ref``) or the port's engine of ``kind``."""
    if ref:
        from repro.serving import ServingEngine as S, WaveServingEngine as W
        dev = {}
    else:
        S, W, dev = ServingEngine, WaveServingEngine, {"device": "cpu"}
    if kind == "slot":
        return S(cfg, params, **GEOM, **kw, **dev)
    return W(cfg, params, n_max=GEOM["n_max"], max_batch=GEOM["max_batch"],
             **kw, **dev)


def _run(eng, req_cls, cfg) -> dict:
    """Submit the requests (uid = index), serve them → {uid: tokens}."""
    for i, (p, (_, gen)) in enumerate(zip(_prompts(cfg.vocab_size), SPECS)):
        eng.submit(req_cls(uid=i, prompt=p, max_new_tokens=gen))
    return {r.uid: np.asarray(r.output).tolist() for r in eng.run()}


def _reference(case):
    from repro.serving import Request as JRequest
    cfg_j, pj = _params()[:2]
    kind, kw = CASES[case]
    return case, _run(_engine(kind, cfg_j, pj, kw, ref=True), JRequest,
                      cfg_j)


def _reference_paged_error():
    """The reference's resident paged engine on deepseek: the
    ``UnsupportedPagedConfig`` it raises when it builds its pool."""
    from repro.models import serve as JSV
    from repro.serving import PagedServingEngine as JEngine
    cfg_j, pj = _params()[:2]
    try:
        eng = JEngine(cfg_j, pj, block_size=64, **GEOM)
        eng.start()
    except JSV.UnsupportedPagedConfig as exc:
        return "paged", exc
    return "paged", None


@pytest.fixture(scope="module")
def want():
    _params()
    with concurrent.futures.ThreadPoolExecutor(len(CASES) + 1) as pool:
        futs = [pool.submit(_reference, case) for case in CASES]
        futs.append(pool.submit(_reference_paged_error))
        return dict(f.result() for f in futs)


@pytest.mark.parametrize("case", list(CASES))
def test_engines_match_reference(want, case):
    _, _, cfg_t, pt = _params()
    kind, kw = CASES[case]
    got = _run(_engine(kind, cfg_t, pt, kw, ref=False), Request, cfg_t)
    assert got == want[case]
    assert [len(got[u]) for u in sorted(got)] == [n for _, n in SPECS]
    assert len({t for toks in got.values() for t in toks}) > 5


def test_baseline_retrieves_and_promotes(want):
    """``use_pariskv=False`` does not turn an MLA layer dense, in the
    reference as in the port: its tokens are the ParisKV engine's, and the
    20-token request promotes in both."""
    assert want["slot_full"] == want["slot"]
    _, _, cfg_t, pt = _params()
    eng = ServingEngine(cfg_t, pt, use_pariskv=False, device="cpu", **GEOM)
    _run(eng, Request, cfg_t)
    promoted = {r.uid: r.promotions for r in eng._done}
    assert promoted[1] >= 1


def test_wave_pads_reach_the_prefill(want):
    """The wave engine's 40-token prompt carries 50 pad zeros (its wave's
    longest prompt has 90), encoded like tokens by the MLA prefill: its
    tokens differ from the slot engine's, on both sides."""
    assert want["wave"][1] != want["slot"][1]
    assert want["wave"][0] == want["slot"][0]


@pytest.mark.parametrize("case", list(PAGED))
def test_paged_engines_refuse_as_reference(want, case):
    """Every paged engine refuses deepseek at construction with
    ``UnsupportedPagedConfig``: the reference's fields (stage 0, layer 0,
    mixer 'mla') and message."""
    _, _, cfg_t, pt = _params()
    ref = want["paged"]
    assert ref is not None
    with pytest.raises(TSV.UnsupportedPagedConfig) as got:
        PagedServingEngine(cfg_t, pt, block_size=64, **GEOM,
                           **PAGED[case], device="cpu")
    for key in ("config_name", "stage", "layer", "mixer"):
        assert getattr(got.value, key) == getattr(ref, key), key
    assert str(got.value) == str(ref)


def test_mesh_shards_refused_naming_mla():
    """As the reference's ``test_mesh_plus_mla_rejected``: two shards of
    deepseek raise ``UnsupportedShardedConfig`` matching 'mla', before any
    process group is looked for, with the reference's reason."""
    from repro import configs as JC
    from repro.models import serve as JSV
    _, _, cfg_t, pt = _params()
    with pytest.raises(TSV.UnsupportedShardedConfig, match="mla") as got:
        PagedServingEngine(cfg_t, pt, block_size=64, **GEOM, mesh_shards=2,
                           device="cpu")
    assert got.value.feature == "mesh_shards=2"
    assert JSV.sharded_support_reason(JC.smoke(ARCH)) in str(got.value)


def test_offload_and_shard_reasons_equal_reference():
    from repro import configs as JC
    from repro.models import serve as JSV
    cfg_j, cfg_t = JC.smoke(ARCH), TC.smoke(ARCH)
    for fn in ("offload_support_reason", "sharded_support_reason",
               "fill_support_reason", "share_support_reason"):
        want = getattr(JSV, fn)(cfg_j)
        assert want is not None and "mla" in want, fn
        assert getattr(TSV, fn)(cfg_t) == want, fn
    assert not TSV.offload_support_reason(TC.smoke("qwen2-1.5b"))
    assert not TSV.sharded_support_reason(TC.smoke("qwen2-1.5b"))


def test_chunked_and_sharing_refused_as_reference():
    """Chunked prefill (slot and paged engines) and prefix sharing refuse
    deepseek with the reference's ``ValueError`` and message (an MLA
    mixer has no chunk-resumable prefill, ``stage 0 layer 0``)."""
    from repro.serving import PagedServingEngine as JEngine
    from repro.serving import ServingEngine as JSlot
    cfg_j, pj, cfg_t, pt = _params()
    for make_j, make_t, kw in (
            (JSlot, ServingEngine, dict(prefill_budget=8)),
            (JEngine, PagedServingEngine,
             dict(prefill_budget=8, share_prefixes=True))):
        with pytest.raises(ValueError) as ref:
            make_j(cfg_j, pj, n_max=256, max_batch=1, **kw)
        with pytest.raises(ValueError,
                           match="stage 0 layer 0 mixer 'mla' has no "
                                 "chunk-resumable prefill") as got:
            make_t(cfg_t, pt, n_max=256, max_batch=1, device="cpu", **kw)
        assert str(got.value) == str(ref.value)


def test_cli_serves_deepseek(capsys):
    """``launch.serve --arch deepseek-v2-lite-16b --smoke`` on the CPU,
    slot and wave engines: the same ``out[:8]`` per request."""
    from repro_torch.launch import serve as CLI
    outs = []
    for extra in ([], ["--wave"]):
        CLI.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                  "--requests", "2", "--prompt-len", "40", "--gen", "4",
                  "--n-max", "128", *extra])
        outs.append([ln.split("out[:8]=")[1] for ln in
                     capsys.readouterr().out.splitlines()
                     if "out[:8]=" in ln])
    assert len(outs[0]) == 2 and outs[0] == outs[1]
