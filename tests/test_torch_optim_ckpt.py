"""The port's optimizer, data feed, checkpoints and train CLI against the
reference (CPU):

* ``adamw_update`` on the reference's parameter trees with the same
  gradients on both sides, three steps within 1e-6; the weight-decay rule
  exactly: with zero gradients only decay moves a leaf, so the moved
  leaves must be the reference's, whose per-layer norm scales, biases and
  SSM constants are stacked (L, ...) and decayed and whose 0-d per-layer
  ``cross_gate`` is not; a rule reading the port's own ndim fails here;
* ``clip_by_global_norm`` (clipped and not), ``cosine_schedule`` over
  warm-up, decay and past the end;
* ``make_batch`` equal to the reference's, sharded over hosts too;
* ``save_checkpoint`` read by the reference's ``load_checkpoint`` and the
  reference's read by the port's, bfloat16 leaves and the float32 router
  included, bit for bit, with the step;
* ``python -m repro_torch.launch.train --smoke --steps 2 --device cpu``
  prints the reference launcher's lines and writes a checkpoint both
  sides read."""
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
from repro import data as JD  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro.ckpt import npz as JCK  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import data as TD  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.ckpt import npz as TCK  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import convert  # noqa: E402

TREE_ARCHS = ("llama-3.2-vision-11b", "hymba-1.5b", "whisper-large-v3",
              "grok-1-314b")


def _tree_np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _ref_params(arch, dtype="float32", key=0):
    cfg_j = dataclasses.replace(JC.smoke(arch), dtype=dtype)
    cfg_t = dataclasses.replace(TC.smoke(arch), dtype=dtype)
    return cfg_j, cfg_t, _tree_np(JM.init_params(cfg_j,
                                                 jax.random.PRNGKey(key)))


def _like(tree, seed, scale=1.0):
    """Seeded float32 arrays in ``tree``'s shapes."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (rng.randn(*a.shape) * scale).astype(
        np.float32), tree)


def _leaves(port_tree, cfg_t, ref_tree):
    """(path, port leaf in the reference's layout, reference leaf)."""
    a = jax.tree_util.tree_flatten_with_path(
        convert.params_to_jax(port_tree, cfg_t))[0]
    b = dict((jax.tree_util.keystr(p), v) for p, v in
             jax.tree_util.tree_flatten_with_path(ref_tree)[0])
    assert len(a) == len(b)
    return [(jax.tree_util.keystr(p), np.asarray(v), np.asarray(b[
        jax.tree_util.keystr(p)])) for p, v in a]


@pytest.mark.parametrize("arch", TREE_ARCHS)
def test_adamw_update_matches_reference(arch):
    """Three updates with the same gradients on both sides (lr 1e-3):
    params and moments within 1e-6, the step count exact."""
    cfg_j, cfg_t, pj = _ref_params(arch)
    st_j = JO.adamw_init(pj)
    pt = convert.params_from_jax(pj, cfg_t, device="cpu")
    st_t = TO.adamw_init(pt)
    pj_cur = pj
    for i in range(3):
        g = _like(pj, seed=i, scale=0.01)
        pj_cur, st_j = JO.adamw_update(pj_cur, g, st_j, jnp.float32(1e-3))
        pt, st_t = TO.adamw_update(
            pt, convert.params_from_jax(g, cfg_t, device="cpu"), st_t,
            torch.tensor(1e-3))
    assert int(st_t.step) == int(st_j.step) == 3
    for tree_t, tree_j in ((pt, pj_cur), (st_t.mu, st_j.mu),
                           (st_t.nu, st_j.nu)):
        for path, a, b in _leaves(tree_t, cfg_t, _tree_np(tree_j)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=path)


@pytest.mark.parametrize("arch", TREE_ARCHS)
def test_weight_decay_follows_the_reference_stacked_shapes(arch):
    """Zero gradients: a leaf moves only by decay. Every leaf moves on
    the port exactly where it moves on the reference; per-layer norms
    move (the reference's (L, d) stacks have ndim 2), ``cross_gate`` and
    ``final_norm`` do not."""
    cfg_j, cfg_t, pj = _ref_params(arch)
    zeros = jax.tree.map(np.zeros_like, pj)
    new_j, _ = JO.adamw_update(pj, zeros, JO.adamw_init(pj),
                               jnp.float32(1e-2))
    pt = convert.params_from_jax(pj, cfg_t, device="cpu")
    new_t, _ = TO.adamw_update(
        pt, convert.params_from_jax(zeros, cfg_t, device="cpu"),
        TO.adamw_init(pt), torch.tensor(1e-2))
    moved = {}
    for (path, a, b), (_, p0, _) in zip(
            _leaves(new_t, cfg_t, _tree_np(new_j)),
            _leaves(pt, cfg_t, pj)):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-7, err_msg=path)
        moved[path] = not np.array_equal(a, p0)
        want_moved = np.asarray(b).ndim >= 2 and np.any(b)
        assert moved[path] == want_moved, path
    assert moved["['stages'][0]['l0']['norm_attn']"]
    assert not moved["['final_norm']"]
    if arch == "llama-3.2-vision-11b":
        gate = [p for p in moved if p.endswith("['cross_gate']")]
        assert gate and not any(moved[p] for p in gate)
    mask = TO.decay_mask(pt)
    assert mask["layers"][0]["norm_attn"] and not mask["final_norm"]


def test_clip_by_global_norm_matches_reference():
    cfg_j, cfg_t, pj = _ref_params("qwen2-1.5b")
    g = _like(pj, seed=7, scale=0.05)
    gt = convert.params_from_jax(g, cfg_t, device="cpu")
    for max_norm in (1.0, 1e6):
        cj, nj = JO.clip_by_global_norm(g, max_norm)
        ct, nt = TO.clip_by_global_norm(gt, max_norm)
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
        for path, a, b in _leaves(ct, cfg_t, _tree_np(cj)):
            assert a.dtype == np.float32, path
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9,
                                       err_msg=path)
    assert float(nj) > 1.0        # the first max_norm clipped


def test_cosine_schedule_matches_reference():
    """Warm-up, the cosine and past the end, within 1e-6 (float32)."""
    for step in list(range(0, 120, 3)) + [0, 9, 10, 11, 100, 10_000]:
        want = float(JO.cosine_schedule(jnp.int32(step), 3e-4, 10, 100))
        got = float(TO.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                       3e-4, 10, 100))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12,
                                   err_msg=str(step))
    assert float(TO.cosine_schedule(torch.tensor(0), 1.0, 5, 50)) == 0.0


@pytest.mark.parametrize("hosts", [1, 2])
def test_make_batch_matches_reference(hosts):
    """Three successive batches of 4 × 24 tokens (a host's 4 // hosts
    rows) equal the reference's; a batch that does not split over the
    hosts raises."""
    sj, st = JD.SyntheticLMStream(1000, seed=5), TD.SyntheticLMStream(
        1000, seed=5)
    for _ in range(3):
        tj, lj = JD.make_batch(sj, 4, 24, host_id=hosts - 1,
                               num_hosts=hosts)
        tt, lt = TD.make_batch(st, 4, 24, host_id=hosts - 1,
                               num_hosts=hosts)
        assert tt.shape == (4 // hosts, 24)
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_array_equal(tt[:, 1:], lt[:, :-1])
    with pytest.raises(ValueError):
        TD.make_batch(st, 3, 8, num_hosts=2)


@pytest.mark.parametrize("arch", ["grok-1-314b", "whisper-large-v3"])
def test_checkpoints_round_trip_with_the_reference(arch, tmp_path):
    """bf16 configs (grok's router stays float32): the port's file read by
    the reference's ``load_checkpoint`` equals the port's params bit for
    bit, the reference's file read by the port's ``load_checkpoint``
    equals ``params_from_jax``; steps kept; no temporary file left."""
    cfg_j, cfg_t, pj = _ref_params(arch, dtype="bfloat16", key=3)
    pt = convert.params_from_jax(pj, cfg_t, device="cpu")
    pt["final_norm"] = pt["final_norm"] * 1.5     # not the init's ones
    TCK.save_checkpoint(str(tmp_path / "port.npz"), pt, cfg_t, step=7)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["port.npz"]
    back_j = _tree_np(JCK.load_checkpoint(str(tmp_path / "port.npz"), pj))
    dtypes = set()
    for path, a, b in _leaves(pt, cfg_t, back_j):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32),
                                      err_msg=path)
        dtypes.add(str(b.dtype))
    assert "bfloat16" in dtypes
    assert int(np.load(tmp_path / "port.npz")["__step__"]) == 7

    JCK.save_checkpoint(str(tmp_path / "ref.npz"), pj, step=3)
    back_t = TCK.load_checkpoint(str(tmp_path / "ref.npz"), cfg_t,
                                 device="cpu")
    want = convert.params_from_jax(pj, cfg_t, device="cpu")
    for a, b in zip(jax.tree.leaves(back_t), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert back_t["layers"][0]["norm_attn"].dtype == torch.bfloat16
    if arch == "grok-1-314b":
        assert back_t["layers"][0]["moe"]["router"].dtype == torch.float32
    loaded = convert.load_npz(str(tmp_path / "port.npz"), cfg_t,
                              device="cpu")
    assert torch.equal(loaded["final_norm"], pt["final_norm"])


def test_train_cli_runs_and_writes_a_checkpoint(tmp_path, capsys):
    """Two steps of qwen2-smoke on the CPU: the reference launcher's
    lines, finite losses, and a checkpoint both sides read."""
    path = tmp_path / "ckpt" / "qwen2.npz"
    TL.main(["--smoke", "--steps", "2", "--batch", "2", "--seq", "32",
             "--device", "cpu", "--ckpt", str(path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen2-smoke params≈")
    steps = [line for line in out if line.startswith("step ")]
    assert len(steps) == 2
    assert all(np.isfinite(float(line.split()[3])) for line in steps)
    assert out[-1] == f"checkpoint → {path}"
    cfg_j, cfg_t = JC.smoke("qwen2-1.5b"), TC.smoke("qwen2-1.5b")
    like = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    JCK.load_checkpoint(str(path), like)
    params = TCK.load_checkpoint(str(path), cfg_t, device="cpu")
    assert int(np.load(path)["__step__"]) == 2
    assert params["embed"].dtype == torch.bfloat16


def test_train_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.main(["--smoke", "--steps", "1"])
