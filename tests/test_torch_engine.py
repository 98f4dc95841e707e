"""The port's ``PagedServingEngine`` against the JAX reference's on the
qwen2 smoke config in float32: identical greedy tokens per uid on the
staggered-admission workload (ample and backpressured pools), with the
reference's parameters carried across by ``params_from_jax`` and by an
npz checkpoint round trip through ``load_npz``; plus the allocator's
accounting, cancellation, the options that are not ported yet and the
device rule of every engine."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores, and torch's
# spinning OpenMP pool would otherwise slow each of them many times over
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.ckpt.npz import save_checkpoint  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import (PagedServingEngine, Request,  # noqa: E402
                                 ServingEngine, WaveServingEngine)

CFG_J = dataclasses.replace(JC.smoke("qwen2-1.5b"), dtype="float32")
CFG_T = dataclasses.replace(TC.smoke("qwen2-1.5b"), dtype="float32")
SPECS = [(33, 6), (48, 9), (70, 5)]
ENGINE = dict(n_max=256, max_batch=2, block_size=64, chunk_size=4)


@pytest.fixture(scope="module")
def workload():
    pj = JM.init_params(CFG_J, jax.random.PRNGKey(2))
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, CFG_J.vocab_size, size=(s,)).astype(np.int32)
               for s, _ in SPECS]
    return pj, prompts


def _serve(eng, make_request, prompts):
    for i, ((_, gen), p) in enumerate(zip(SPECS, prompts)):
        eng.submit(make_request(uid=i, prompt=p, max_new_tokens=gen))
    return {r.uid: r for r in eng.run()}


@pytest.mark.parametrize("scale", [1.0, 8.0])
@pytest.mark.parametrize("num_blocks", [None, 3])
def test_staggered_admission_tokens_match_reference(workload, num_blocks,
                                                    scale):
    """Ample pool and a 3-block pool that serializes admissions; weights
    at the init scale (near-constant greedy outputs, as the reference's
    own test) and scaled ×8 (varied outputs)."""
    pj, prompts = workload
    pj = jax.tree.map(lambda a: a * scale, pj)
    ref = JEngine(CFG_J, pj, num_blocks=num_blocks, **ENGINE)
    want = _serve(ref, JRequest, prompts)
    eng = PagedServingEngine(
        CFG_T, convert.params_from_jax(jax.device_get(pj), CFG_T,
                                       device="cpu"),
        num_blocks=num_blocks, device="cpu", **ENGINE)
    got = _serve(eng, Request, prompts)
    assert sorted(got) == [0, 1, 2]
    for uid, (_, gen) in enumerate(SPECS):
        np.testing.assert_array_equal(got[uid].output, want[uid].output,
                                      err_msg=f"request {uid}")
        assert got[uid].output.shape == (gen,)
        assert got[uid].ttft_s > 0 and len(got[uid].token_times) == gen
    if scale > 1:
        assert len(set(np.concatenate([r.output for r in got.values()]))) > 5
    assert len(eng._free) == eng.num_blocks
    assert eng.peak_concurrency == ref.peak_concurrency


def test_eos_early_exit_and_single_token_match_reference(workload):
    """An eos id taken from the middle of a reference output stops that
    request early on both engines; a one-token request finishes at its
    prefill."""
    pj, prompts = workload
    pj = jax.tree.map(lambda a: a * 8.0, pj)
    free = _serve(JEngine(CFG_J, pj, **ENGINE), JRequest, prompts)
    eos = int(free[1].output[3])
    params = convert.params_from_jax(jax.device_get(pj), CFG_T, device="cpu")
    runs = []
    for make, req, kw in ((JEngine, JRequest, {}),
                          (PagedServingEngine, Request, {"device": "cpu"})):
        eng = make(CFG_J if make is JEngine else CFG_T,
                   pj if make is JEngine else params, eos_id=eos,
                   **kw, **ENGINE)
        out = _serve(eng, req, prompts)
        eng.submit(req(uid=7, prompt=prompts[0], max_new_tokens=1))
        out.update({r.uid: r for r in eng.run()})
        runs.append(out)
    want, got = runs
    assert len(got[1].output) <= 4 and got[1].output[-1] == eos
    for uid in (0, 1, 2, 7):
        np.testing.assert_array_equal(got[uid].output, want[uid].output,
                                      err_msg=f"request {uid}")
    assert got[7].output.shape == (1,)


def test_npz_round_trip_serves_the_same_tokens(workload, tmp_path):
    pj, prompts = workload
    pj = jax.tree.map(lambda a: a * 8.0, pj)
    path = str(tmp_path / "params.npz")
    save_checkpoint(path, pj, step=7)
    loaded = convert.load_npz(path, CFG_T, device="cpu")
    direct = convert.params_from_jax(jax.device_get(pj), CFG_T, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(direct)):
        assert torch.equal(a, b)
    want = _serve(JEngine(CFG_J, pj, **ENGINE), JRequest, prompts)
    got = _serve(PagedServingEngine(CFG_T, loaded, device="cpu", **ENGINE),
                 Request, prompts)
    for uid in want:
        np.testing.assert_array_equal(got[uid].output, want[uid].output)
    # bfloat16 leaves travel as uint16 views tagged __bf16__
    cfg_bf = JC.smoke("qwen2-1.5b")
    pb = JM.init_params(cfg_bf, jax.random.PRNGKey(1))
    save_checkpoint(str(tmp_path / "bf16.npz"), pb)
    lb = convert.load_npz(str(tmp_path / "bf16.npz"), TC.smoke("qwen2-1.5b"),
                          device="cpu")
    assert lb["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        lb["embed"].float().numpy(),
        np.asarray(pb["embed"]).astype(np.float32))


def test_block_accounting_backpressure_and_hist_audit(workload):
    """Admission is gated by unreserved blocks, not free slots; every
    block returns to the free list; the incremental histograms equal a
    recompute at every chunk boundary."""
    pj, _ = workload
    params = convert.params_from_jax(jax.device_get(pj), CFG_T, device="cpu")
    eng = PagedServingEngine(CFG_T, params, n_max=256, max_batch=3,
                             block_size=64, num_blocks=3, chunk_size=4,
                             device="cpu")
    rng = np.random.RandomState(3)
    gens, sizes = [5, 7, 30], [30, 40, 100]
    for i, (s, gen) in enumerate(zip(sizes, gens)):
        eng.submit(Request(uid=i, max_new_tokens=gen, prompt=rng.randint(
            0, CFG_T.vocab_size, size=(s,)).astype(np.int32)))
    assert eng.blocks_needed(eng.queue[2]) == 3
    eng.start()
    while eng.pending():
        eng.step_serve()
        eng.verify_hist()
    done = {r.uid: r for r in eng._done}
    assert sorted(done) == [0, 1, 2]
    for uid, r in done.items():
        assert r.output.shape == (gens[uid],)
    assert done[2].promotions >= 1            # 100 + 30 crosses a window
    assert eng.peak_concurrency == 2          # block-bound, not slot-bound
    assert len(eng._free) == eng.num_blocks
    assert int(eng.nonfinite_logits) == 0
    with pytest.raises(ValueError, match="never run"):
        eng.submit(Request(uid=9, prompt=np.zeros(200, np.int32),
                           max_new_tokens=50))
    assert not eng.queue


def test_cancel_mid_flight_reclaims_blocks_and_hist(workload):
    pj, prompts = workload
    params = convert.params_from_jax(jax.device_get(pj), CFG_T, device="cpu")
    eng = PagedServingEngine(CFG_T, params, device="cpu", **ENGINE)
    for i, p in enumerate(prompts[:2]):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=40))
    eng.start()
    eng.step_serve()
    slot = next(s for s, r in enumerate(eng._slots) if r and r.uid == 0)
    blocks = list(eng._alloc[slot])
    eng.cancel(0)
    eng.step_serve()
    assert eng._slots[slot] is None or eng._slots[slot].uid != 0
    pool = eng._state.caches[0]["kv"]
    assert all(int(pool.k[b].abs().sum()) == 0 or b in sum(
        eng._alloc.values(), []) for b in blocks)
    while eng.pending():
        eng.step_serve()
    done = {r.uid: r for r in eng._done}
    assert done[0].cancelled and 0 < len(done[0].output) < 40
    assert len(done[1].output) == 40
    assert len(eng._free) == eng.num_blocks
    assert all(int(lc["hist"].abs().sum()) == 0 for lc in eng._state.caches)


@pytest.mark.parametrize("option,exc,item", [
    (dict(mesh_shards=2), ValueError, "torchrun"),
    (dict(mesh_shards=2, offload=True), NotImplementedError,
     "resident engine")])
def test_options_not_ported_raise_with_roadmap_item(workload, option, exc,
                                                    item):
    """Every engine option is ported; those this process cannot run raise
    naming what to do instead: head sharding (ROADMAP A11, ported) without
    a process group names torchrun, and with offload the resident
    engine."""
    pj, _ = workload
    params = convert.params_from_jax(jax.device_get(pj), CFG_T, device="cpu")
    with pytest.raises(exc, match=item):
        PagedServingEngine(CFG_T, params, device="cpu", **option, **ENGINE)


def test_engine_needs_a_card_or_an_explicit_cpu(workload):
    pj, _ = workload
    params = convert.params_from_jax(jax.device_get(pj), CFG_T, device="cpu")
    engines = [lambda **kw: PagedServingEngine(CFG_T, params, **ENGINE, **kw),
               lambda **kw: ServingEngine(CFG_T, params, **kw),
               lambda **kw: WaveServingEngine(CFG_T, params, **kw)]
    for make in engines:
        make(device="cpu")
        if torch.cuda.is_available():
            with pytest.raises(ValueError, match="params live on cpu"):
                make()
            continue
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.params_from_jax(jax.device_get(pj), CFG_T)
