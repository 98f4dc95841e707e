"""The port's contiguous ``ServingEngine`` against the JAX reference's on
the qwen2 smoke config in float32, weights carried across by
``params_from_jax``: identical greedy tokens per uid for ParisKV and the
full-attention baseline at weight scales 1 and 8, on a staggered workload
long enough to promote; slot reuse after eviction with a request whose
prompt + gen == n_max (its frozen row's next append clamps); EOS in the
middle of a chunk; mid-flight cancellation."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

CFG_J = dataclasses.replace(JC.smoke("qwen2-1.5b"), dtype="float32")
CFG_T = dataclasses.replace(TC.smoke("qwen2-1.5b"), dtype="float32")
# window 48 = local 32 + interval 16: the last two promote mid-decode
SPECS = [(33, 6), (48, 30), (70, 20)]
ENGINE = dict(n_max=256, max_batch=2, chunk_size=4)


@pytest.fixture(scope="module")
def workload():
    pj = JM.init_params(CFG_J, jax.random.PRNGKey(2))
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, CFG_J.vocab_size, size=(s,)).astype(np.int32)
               for s, _ in SPECS]
    return pj, prompts


def _params(pj, scale=1.0):
    pj = jax.tree.map(lambda a: a * scale, pj)
    return pj, convert.params_from_jax(jax.device_get(pj), CFG_T,
                                       device="cpu")


def _serve(eng, make_request, specs, prompts):
    for i, ((_, gen), p) in enumerate(zip(specs, prompts)):
        eng.submit(make_request(uid=i, prompt=p, max_new_tokens=gen))
    return {r.uid: r for r in eng.run()}


@pytest.mark.parametrize("scale", [1.0, 8.0])
@pytest.mark.parametrize("use_pariskv", [True, False])
def test_slot_engine_tokens_match_reference(workload, use_pariskv, scale):
    pj, prompts = workload
    pj, params = _params(pj, scale)
    want = _serve(JEngine(CFG_J, pj, use_pariskv=use_pariskv, **ENGINE),
                  JRequest, SPECS, prompts)
    eng = ServingEngine(CFG_T, params, use_pariskv=use_pariskv,
                        device="cpu", **ENGINE)
    got = _serve(eng, Request, SPECS, prompts)
    assert sorted(got) == [0, 1, 2]
    for uid, (_, gen) in enumerate(SPECS):
        np.testing.assert_array_equal(got[uid].output, want[uid].output,
                                      err_msg=f"request {uid}")
        assert got[uid].output.shape == (gen,)
        assert got[uid].ttft_s > 0 and len(got[uid].token_times) == gen
    assert got[1].promotions >= 1 and got[2].promotions >= 1
    if scale > 1:
        assert len(set(np.concatenate([r.output for r in got.values()]))) > 5
    assert eng.peak_concurrency == 2
    assert int(eng.nonfinite_logits) == 0


def test_slot_reuse_after_eviction_matches_reference(workload):
    """More requests than slots: finished slots are re-admitted mid-flight
    (mirrors the reference's ``test_engine_slot_reuse_after_eviction``).
    Request 1 fills its slot exactly (prompt + gen == n_max) and finishes
    while the other slot decodes, so its frozen row appends at n_max."""
    pj, _ = workload
    pj, params = _params(pj, 8.0)
    rng = np.random.RandomState(3)
    gens = [3, 20, 11, 7, 5, 2]
    sizes = [24, 256 - 20, 40, 48, 56, 64]
    specs = list(zip(sizes, gens))
    prompts = [rng.randint(0, CFG_T.vocab_size, size=(s,)).astype(np.int32)
               for s in sizes]
    want = _serve(JEngine(CFG_J, pj, **ENGINE), JRequest, specs, prompts)
    got = _serve(ServingEngine(CFG_T, params, device="cpu", **ENGINE),
                 Request, specs, prompts)
    assert sorted(got) == list(range(len(specs)))
    for uid, gen in enumerate(gens):
        assert got[uid].output.shape == (gen,)
        np.testing.assert_array_equal(got[uid].output, want[uid].output,
                                      err_msg=f"request {uid}")


def test_eos_mid_chunk_and_cancel(workload):
    """An eos id taken from the middle of a reference output stops that
    request inside a chunk on both engines; cancelling a request in flight
    keeps its partial output and frees its slot for the queue."""
    pj, prompts = workload
    pj, params = _params(pj, 8.0)
    free = _serve(JEngine(CFG_J, pj, **ENGINE), JRequest, SPECS, prompts)
    eos = int(free[1].output[5])
    want = _serve(JEngine(CFG_J, pj, eos_id=eos, **ENGINE), JRequest, SPECS,
                  prompts)
    got = _serve(ServingEngine(CFG_T, params, eos_id=eos, device="cpu",
                               **ENGINE), Request, SPECS, prompts)
    for uid in want:
        np.testing.assert_array_equal(got[uid].output, want[uid].output,
                                      err_msg=f"request {uid}")
    assert len(got[1].output) <= 6 and got[1].output[-1] == eos

    eng = ServingEngine(CFG_T, params, device="cpu", **ENGINE)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=40))
    eng.start()
    eng.step_serve()
    eng.cancel(0)
    while eng.pending():
        eng.step_serve()
    done = {r.uid: r for r in eng._done}
    assert done[0].cancelled and 0 < len(done[0].output) < 40
    assert len(done[1].output) == 40 and len(done[2].output) == 40
    assert int(eng._state.remaining.abs().sum()) == 0
