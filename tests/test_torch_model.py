"""Model-level parity of the port against the JAX reference on the qwen2
smoke config in float32, with the reference's parameters carried across
by ``models.convert.params_from_jax``: the building blocks, the prefill
logits, and a teacher-forced paged decode whose logits must agree at every
step and whose Stage-I candidate and winner sets must be identical for
every (step, layer)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores, and torch's
# spinning OpenMP pool would otherwise slow each of them many times over
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core import attention as JA  # noqa: E402
from repro.core import retrieval as JR  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import serve as JSV  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import attention as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import serve as TSV  # noqa: E402

CFG_J = dataclasses.replace(JC.smoke("qwen2-1.5b"), dtype="float32")
CFG_T = dataclasses.replace(TC.smoke("qwen2-1.5b"), dtype="float32")


@pytest.fixture(scope="module")
def params():
    pj = JM.init_params(CFG_J, jax.random.PRNGKey(3))
    # larger weights than the init's std 0.02 so logits and attention are
    # far from uniform (a weaker test would pass on near-constant outputs)
    pj = jax.tree.map(lambda a: a * 6.0, pj)
    return pj, convert.params_from_jax(jax.device_get(pj), CFG_T,
                                       device="cpu")


def test_blocks_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 64).astype(np.float32)
    s = rng.randn(64).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(s))), atol=1e-5)
    h = rng.randn(2, 16, 4, 64).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 116), (2, 16)).copy()
    np.testing.assert_allclose(
        TL.rope(torch.from_numpy(h), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(JL.rope(jnp.asarray(h), jnp.asarray(pos), 1e6)),
        atol=1e-5)
    q = rng.randn(1, 256, 4, 32).astype(np.float32)
    kv = rng.randn(2, 1, 256, 2, 32).astype(np.float32)
    want = JA.blockwise_causal_attention(
        jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
        sm_scale=0.3, q_chunk=64, kv_chunk=128)
    got = TA.blockwise_causal_attention(
        torch.from_numpy(q), torch.from_numpy(kv[0]), torch.from_numpy(kv[1]),
        sm_scale=0.3, q_chunk=64, kv_chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("S,q_chunk,kv_chunk,ref_chunk,softcap", [
    (200, 64, 128, 40, 0.0),     # pads to 256
    (100, 32, 48, 20, 0.0),      # kv chunk rounds up to 64, pads to 128
    (70, 16, 16, 35, 30.0),      # pads to 80, with a soft cap
])
def test_prefill_attention_ragged_length(S, q_chunk, kv_chunk, ref_chunk,
                                         softcap):
    """A length that the chunks do not divide (the reference asserts on
    it): the port pads and drops the pad rows, and must equal the
    reference run with chunks that divide S."""
    rng = np.random.RandomState(S)
    q = rng.randn(2, S, 4, 32).astype(np.float32)
    kv = rng.randn(2, 2, S, 2, 32).astype(np.float32)
    want = JA.blockwise_causal_attention(
        jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
        sm_scale=0.3, softcap=softcap, q_chunk=ref_chunk, kv_chunk=ref_chunk)
    got = TA.blockwise_causal_attention(
        torch.from_numpy(q), torch.from_numpy(kv[0]), torch.from_numpy(kv[1]),
        sm_scale=0.3, softcap=softcap, q_chunk=q_chunk, kv_chunk=kv_chunk)
    assert got.shape == (2, S, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_params_from_jax_layout(params):
    pj, pt = params
    assert len(pt["layers"]) == CFG_T.num_layers
    for li in range(CFG_T.num_layers):
        np.testing.assert_array_equal(
            pt["layers"][li]["attn"]["wq"].numpy(),
            np.asarray(pj["stages"][0]["l0"]["attn"]["wq"][li]))
    bf = convert.params_from_jax(jax.device_get(JM.init_params(
        JC.smoke("qwen2-1.5b"), jax.random.PRNGKey(0))),
        TC.smoke("qwen2-1.5b"), device="cpu")
    assert bf["embed"].dtype == torch.bfloat16
    init = TM.init_params(CFG_T, seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: a.shape, pj)
    assert tuple(init["embed"].shape) == shapes["embed"]
    assert tuple(init["layers"][0]["mlp"]["wi_up"].shape) == \
        shapes["stages"][0]["l0"]["mlp"]["wi_up"][1:]
    assert float(init["embed"].abs().max()) <= 0.04
    assert TM.param_count(init) == JM.param_count(pj)


def test_prefill_logits_match(params):
    pj, pt = params
    rng = np.random.RandomState(1)
    toks = rng.randint(0, CFG_J.vocab_size, size=(2, 64)).astype(np.int32)
    lens = np.asarray([64, 37], np.int32)          # LEFT-aligned, padded
    want, sj = JSV.prefill(pj, CFG_J, jnp.asarray(toks), 256,
                           lengths=jnp.asarray(lens))
    got, st = TSV.prefill(pt, CFG_T, toks, 256, lengths=lens, device="cpu")
    # float32 over two layers: matmuls summed in another order (atol 2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(st.regions.enc_end.numpy(),
                                  np.asarray(sj.regions.enc_end))
    kv_j = sj.caches[0]["l0"]["kv"]
    np.testing.assert_array_equal(
        st.caches[1]["kv"].meta_codes[0, :, :37].numpy(),
        np.asarray(kv_j.meta_codes[1, 0, :, :37]).view(np.int32))


def test_teacher_forced_decode_matches(params, monkeypatch):
    """Same prompt, then 24 given tokens (teacher forcing, so one flip
    cannot cascade) through the paged decode of both packages. The run
    crosses a sliding-window promotion."""
    pj, pt = params
    rng = np.random.RandomState(2)
    L, steps, n_max, bs, nb = 100, 24, 256, 64, 6
    prompt = np.zeros((1, 128), np.int32)
    prompt[0, :L] = rng.randint(0, CFG_J.vocab_size, size=L)
    forced = rng.randint(0, CFG_J.vocab_size, size=steps).astype(np.int32)
    phys = np.asarray([4, 1, nb, nb], np.int32)     # sentinels: unallocated
    bt = np.where(phys < nb, phys, -1)[None].astype(np.int32)

    recorded = []
    orig = JR.retrieve_paged_fused

    def recording(*args, **kwargs):
        res = orig(*args, **kwargs)
        jax.debug.callback(
            lambda c, i: recorded.append((np.asarray(c), np.asarray(i))),
            res.cand_indices, res.indices, ordered=True)
        return res
    monkeypatch.setattr(JR, "retrieve_paged_fused", recording)

    lg0, s1 = JSV.prefill(pj, CFG_J, jnp.asarray(prompt), n_max,
                          lengths=jnp.asarray([L]))
    st = JSV.init_paged_slot_state(CFG_J, 1, nb, bs, n_max)
    st = JSV.admit_paged(st, 0, jnp.asarray(phys), s1.caches, s1.regions,
                         jnp.int32(forced[0]), jnp.int32(steps),
                         pcfg=CFG_J.pariskv)
    step_j = jax.jit(lambda p, t, s, b_: JSV.decode_step(p, CFG_J, t, s,
                                                         block_tables=b_))
    ss = JSV.ServeState(st.caches, st.regions)
    want = []
    for t in range(steps):
        lg, ss = step_j(pj, jnp.asarray(forced[t:t + 1]), ss, jnp.asarray(bt))
        want.append(np.asarray(lg[0]))
    jax.effects_barrier()

    tg0, t1 = TSV.prefill(pt, CFG_T, prompt, n_max, lengths=[L],
                          device="cpu")
    np.testing.assert_allclose(tg0.numpy(), np.asarray(lg0), atol=2e-4,
                               rtol=1e-4)
    ts = TSV.init_paged_slot_state(CFG_T, 1, nb, bs, device="cpu")
    TSV.admit_paged(ts, 0, torch.from_numpy(phys), t1.caches, t1.regions,
                    int(forced[0]), steps, CFG_T.pariskv)
    tss = TSV.ServeState(ts.caches, ts.regions)
    got, rec_t = [], []
    for t in range(steps):
        rec = []
        lg, tss = TSV.decode_step(pt, CFG_T,
                                  torch.from_numpy(forced[t:t + 1]), tss,
                                  torch.from_numpy(bt), record=rec)
        got.append(lg[0].numpy())
        rec_t.extend(rec)
    assert int(tss.regions.enc_end[0]) > int(t1.regions.enc_end[0])
    # logits reach |40| with these weights: float32 matmuls summed in
    # another order over two layers and 24 steps differ by ~1e-5 relative
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-3,
                               rtol=1e-4)
    assert len(recorded) == len(rec_t) == steps * CFG_T.num_layers
    for i, ((cj, wj), res) in enumerate(zip(recorded, rec_t)):
        np.testing.assert_array_equal(res.cand_indices.numpy(), cj,
                                      err_msg=f"candidates, call {i}")
        np.testing.assert_array_equal(np.sort(res.indices.numpy(), -1),
                                      np.sort(wj, -1),
                                      err_msg=f"winners, call {i}")


def test_entry_points_need_a_card_or_an_explicit_cpu():
    """With no card and no ``device=`` every entry point raises instead of
    running on the CPU; with a card they default to it."""
    if torch.cuda.is_available():
        assert TM.init_params(CFG_T, device=None)["embed"].is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(CFG_T)
    pt = TM.init_params(CFG_T, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSV.prefill(pt, CFG_T, np.zeros((1, 8), np.int32), 64)
    st = TSV.init_paged_slot_state(CFG_T, 1, 2, 32, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSV.decode_chunk(pt, CFG_T, st, 1, torch.full((1, 2), -1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSV.init_paged_slot_state(CFG_T, 1, 2, 32)
