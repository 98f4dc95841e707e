"""The port's mixture-of-experts FFN (``repro_torch/models/moe.py``) against
the reference's (``repro/models/moe.py``) on the same seeded numpy inputs,
in float32 at grok-smoke width (d 256, f 512, 4 experts, top-2): the
parameter layout and dtypes (the router float32 in a bfloat16 model, also
after ``params_from_jax`` and ``load_npz``), the routing with its tie rule,
the dispatch tables in a case where tokens overflow capacity, and
``moe_fwd`` / ``moe_decode`` with and without shared experts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores, and torch's
# spinning OpenMP pool would otherwise slow each of them many times over
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.ckpt.npz import save_checkpoint  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

D, F, E, K = 256, 512, 4, 2
TOL = dict(atol=1e-5, rtol=1e-5)
# the reference as its engines run it: compiled
J_FWD = jax.jit(JMOE.moe_fwd, static_argnums=(2, 3))
J_DECODE = jax.jit(JMOE.moe_decode, static_argnums=(2,))


def _params(num_shared: int, seed: int = 0):
    """Reference MoE params as numpy (for JAX) and torch (for the port):
    the router ×8 over the init, so that routing spreads (logits of std
    ~0.8), and the experts ×3, so that outputs are of order 1 (at the
    init scale they are ~0.05, and a tolerance of 1e-5 would test
    little)."""
    pj = JMOE.init_moe(jax.random.PRNGKey(seed), D, F, E, num_shared,
                       jnp.float32)
    pj = jax.tree.map(lambda a: np.asarray(a) * 3.0, pj)
    pj["router"] = pj["router"] * (8.0 / 3.0)
    return pj, jax.tree.map(torch.from_numpy, pj)


def _x(shape, seed: int = 1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ref_tables(expert_idx, capacity: int):
    """Positions, keep and the slot table as the reference's
    ``_dispatch_gather`` computes them (``repro/models/moe.py:54-68``),
    which it does not return."""
    n, k = expert_idx.shape
    onehot = jax.nn.one_hot(expert_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(n * k, E)
    pos = ((jnp.cumsum(flat, 0) - flat).reshape(n, k, E) * onehot).sum(-1)
    keep = pos < capacity
    p_flat = jnp.where(keep, pos, capacity).reshape(-1)
    slot = jnp.full((E, capacity + 1), n, jnp.int32).at[
        expert_idx.reshape(-1), p_flat].set(
        jnp.broadcast_to(jnp.arange(n)[:, None], (n, k)).reshape(-1),
        mode="drop")[:, :capacity]
    return np.asarray(pos), np.asarray(keep), np.asarray(slot)


@pytest.mark.parametrize("num_shared", [0, 2])
def test_init_moe_layout_and_dtypes(num_shared):
    gen = torch.Generator().manual_seed(0)
    got = TMOE.init_moe(D, F, E, num_shared, torch.bfloat16, "cpu", gen)
    want = JMOE.init_moe(jax.random.PRNGKey(0), D, F, E, num_shared,
                         jnp.bfloat16)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_w) == len(jax.tree_util.tree_leaves(got))
    for path, w in flat_w:
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).split(".")[1] == str(w.dtype), path
    assert got["router"].dtype == torch.float32
    assert 0.006 < float(got["router"].abs().max()) <= 0.012


def test_router_stays_float32_through_convert(tmp_path):
    """A bfloat16 grok tree carried across keeps its float32 router (a cast
    would round the routing logits), through ``params_from_jax`` and
    through an npz checkpoint; the experts stay bfloat16."""
    cfg_j, cfg_t = JC.smoke("grok-1-314b"), TC.smoke("grok-1-314b")
    pj = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    path = str(tmp_path / "grok.npz")
    save_checkpoint(path, pj)
    for pt in (convert.params_from_jax(jax.device_get(pj), cfg_t,
                                       device="cpu"),
               convert.load_npz(path, cfg_t, device="cpu")):
        for li, layer in enumerate(pt["layers"]):
            assert layer["moe"]["router"].dtype == torch.float32
            np.testing.assert_array_equal(
                layer["moe"]["router"].numpy(),
                np.asarray(pj["stages"][0]["l0"]["moe"]["router"][li]))
            assert layer["moe"]["experts_up"].dtype == torch.bfloat16
        assert pt["embed"].dtype == torch.bfloat16
    init = TM.init_params(cfg_t, seed=0, device="cpu")
    assert init["layers"][0]["moe"]["router"].dtype == torch.float32
    assert init["layers"][0]["moe"]["experts_down"].dtype == torch.bfloat16


def test_route_matches_lax_top_k_with_ties():
    """Expert ids exact, gates and probabilities to float32 rounding; two
    identical router columns make every row's probabilities tie, and the
    lower expert index must win as in ``lax.top_k``."""
    pj, pt = _params(0)
    pj["router"][:, 3] = pj["router"][:, 1]
    pt["router"] = torch.from_numpy(pj["router"])
    xt = _x((64, D))
    probs_w, gates_w, idx_w = JMOE._route(pj, jnp.asarray(xt), K)
    probs, gates, idx = TMOE._route(pt, torch.from_numpy(xt), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_w))
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_w), **TOL)
    np.testing.assert_allclose(gates.numpy(), np.asarray(gates_w), **TOL)
    assert torch.equal(probs[:, 1], probs[:, 3])
    assert (idx == 3).sum() < (idx == 1).sum()


@pytest.mark.parametrize("num_shared", [0, 2])
def test_dispatch_tables_and_outputs_with_overflow(num_shared):
    """48 tokens × 2 slots into 4 experts of capacity 6: most (token,
    slot) pairs overflow. Positions, ``keep`` and the slot table equal the
    reference's; the outputs (dropped pairs contributing nothing) agree,
    through ``_dispatch_gather`` and through ``moe_fwd`` with a capacity
    factor that gives the same capacity."""
    pj, pt = _params(num_shared)
    xt = _x((48, D))
    _, gates_w, idx_w = JMOE._route(pj, jnp.asarray(xt), K)
    _, gates, idx = TMOE._route(pt, torch.from_numpy(xt), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_w))
    cap = 6
    pos_w, keep_w, slot_w = _ref_tables(idx_w, cap)
    pos = TMOE._positions(idx, E)
    keep = pos < cap
    np.testing.assert_array_equal(pos.numpy(), pos_w)
    np.testing.assert_array_equal(keep.numpy(), keep_w)
    np.testing.assert_array_equal(
        TMOE._slot_table(idx, pos, keep, cap, E).numpy(), slot_w)
    assert 0 < keep_w.sum() < keep_w.size / 2
    np.testing.assert_allclose(
        TMOE._dispatch_gather(pt, torch.from_numpy(xt), gates, idx,
                              cap).numpy(),
        np.asarray(JMOE._dispatch_gather(pj, jnp.asarray(xt), gates_w,
                                         idx_w, cap)), **TOL)
    x = xt.reshape(2, 24, D)
    # int(0.25 · 48 · 2 / 4) = 6 slots per expert
    out_w, aux_w = J_FWD(pj, jnp.asarray(x), K, 0.25)
    out, aux = TMOE.moe_fwd(pt, torch.from_numpy(x), K, capacity_factor=0.25)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_w), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_w), **TOL)


@pytest.mark.parametrize("num_shared", [0, 2])
@pytest.mark.parametrize("shape", [(2, 40), (1, 8)], ids=["prompt", "chunk"])
def test_moe_fwd_matches_reference(shape, num_shared):
    pj, pt = _params(num_shared, seed=3)
    x = _x(shape + (D,), seed=4)
    out_w, aux_w = J_FWD(pj, jnp.asarray(x), K, 1.25)
    out, aux = TMOE.moe_fwd(pt, torch.from_numpy(x), K)
    assert out.shape == shape + (D,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(out_w), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_w), **TOL)


@pytest.mark.parametrize("num_shared", [0, 2])
@pytest.mark.parametrize("b", [2, 9])
def test_moe_decode_matches_reference(b, num_shared):
    """Capacity max(int(2 · b · k / E), 4): 4 for two rows, 9 for nine."""
    pj, pt = _params(num_shared, seed=5)
    x = _x((b, D), seed=6)
    np.testing.assert_allclose(
        TMOE.moe_decode(pt, torch.from_numpy(x), K).numpy(),
        np.asarray(J_DECODE(pj, jnp.asarray(x), K)), **TOL)


def test_moe_fwd_bf16_keeps_dtype():
    """In bfloat16 the output keeps the input's dtype and the routing is
    the float32 routing of the same input (token identity is promised in
    float32 only)."""
    _, pt = _params(0)
    pb = {k: (v if k == "router" else v.to(torch.bfloat16))
          for k, v in pt.items()}
    x = torch.from_numpy(_x((1, 16, D))).to(torch.bfloat16)
    out, _ = TMOE.moe_fwd(pb, x, K)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    _, _, idx = TMOE._route(pb, x.reshape(16, D), K)
    _, _, idx32 = TMOE._route(pt, x.reshape(16, D).float(), K)
    assert torch.equal(idx, idx32)
