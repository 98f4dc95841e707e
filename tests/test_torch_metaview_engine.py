"""The port's ``PagedServingEngine(fused=False)`` — the meta-view
fallback, retrieval over the materialized logical metadata view — against
the JAX reference's, and the three-way identity the reference asserts
(``tests/test_paged_fused.py::test_paged_engine_fused_token_identity``)
inside the port: fused == meta-view == contiguous slot engine, token for
token (qwen2 smoke config, float32)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import PagedServingEngine as JPaged  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import (PagedServingEngine, Request,  # noqa: E402
                                 ServingEngine)

CFG_J = dataclasses.replace(JC.smoke("qwen2-1.5b"), dtype="float32")
CFG_T = dataclasses.replace(TC.smoke("qwen2-1.5b"), dtype="float32")
SPECS = [(33, 6), (48, 30), (70, 20)]
SLOT = dict(n_max=256, max_batch=2, chunk_size=4)
PAGED = dict(SLOT, block_size=64)


@pytest.fixture(scope="module")
def workload():
    pj = JM.init_params(CFG_J, jax.random.PRNGKey(4))
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, CFG_J.vocab_size, size=(s,)).astype(np.int32)
               for s, _ in SPECS]
    return pj, prompts


def _serve(eng, make_request, prompts):
    for i, ((_, gen), p) in enumerate(zip(SPECS, prompts)):
        eng.submit(make_request(uid=i, prompt=p, max_new_tokens=gen))
    return {r.uid: r for r in eng.run()}


@pytest.mark.parametrize("num_blocks", [None, 3])
@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_meta_view_tokens_match_reference(workload, scale, num_blocks):
    """Ample pool and a 3-block pool whose admissions wait for blocks."""
    pj, prompts = workload
    pj = jax.tree.map(lambda a: a * scale, pj)
    want = _serve(JPaged(CFG_J, pj, fused=False, num_blocks=num_blocks,
                         **PAGED), JRequest, prompts)
    eng = PagedServingEngine(
        CFG_T, convert.params_from_jax(jax.device_get(pj), CFG_T,
                                       device="cpu"),
        fused=False, num_blocks=num_blocks, device="cpu", **PAGED)
    got = {}
    for i, ((_, gen), p) in enumerate(zip(SPECS, prompts)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=gen))
    eng.start()
    while eng.pending():
        eng.step_serve()
        eng.verify_hist()          # the fallback maintains the histogram too
    got = {r.uid: r for r in eng._done}
    for uid, (_, gen) in enumerate(SPECS):
        np.testing.assert_array_equal(got[uid].output, want[uid].output,
                                      err_msg=f"request {uid}")
        assert got[uid].output.shape == (gen,)
    assert got[1].promotions >= 1 and got[2].promotions >= 1
    assert len(eng._free) == eng.num_blocks


@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_fused_meta_view_and_slot_engines_are_token_identical(workload,
                                                              scale):
    pj, prompts = workload
    params = convert.params_from_jax(
        jax.device_get(jax.tree.map(lambda a: a * scale, pj)), CFG_T,
        device="cpu")
    ref = _serve(ServingEngine(CFG_T, params, device="cpu", **SLOT), Request,
                 prompts)
    for fused in (True, False):
        got = _serve(PagedServingEngine(CFG_T, params, fused=fused,
                                        device="cpu", **PAGED),
                     Request, prompts)
        for uid in ref:
            np.testing.assert_array_equal(
                got[uid].output, ref[uid].output,
                err_msg=f"request {uid} (fused={fused})")
            assert got[uid].promotions == ref[uid].promotions
