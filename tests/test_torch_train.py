"""The port's training path against the reference, in float32 on the same
numpy inputs (CPU), at smoke widths: the dense family here (qwen2-1.5b,
stablelm-1.6b, llama3.1-8b, qwen3-8b, gemma2-27b, gemma3-12b), the other
families in ``tests/test_torch_train_families.py``, which imports this
file's helpers.

For each architecture the reference's params (PRNGKey 1) reach the port
through ``params_from_jax``; one batch of 2 × 32 tokens from
``make_batch``; one reference run per architecture (``jax.jit``-compiled,
cached for the module):

* ``forward_train``'s logits and aux loss within 1e-5;
* ``lm_loss`` within 1e-5, and every gradient, mapped back to the
  reference's stacked tree by ``params_to_jax``, within 5e-5 of its
  leaf's largest |gradient| against ``jax.grad`` of the reference's
  ``lm_loss``;
* three ``train_step``s (``remat=False``, peak lr 1e-3, warm-up 1, so lr
  is 0 at step 0 and the later steps move the params): loss, grad norm
  and lr within 1e-5 at each step, and the params within 1e-5 (1 % of
  the lr) wherever the reference's gradient exceeds 1e-3 of its leaf's
  largest. Adam divides each gradient by its own size, so an element
  whose gradient is near the two sides' float noise (~6e-6 of the
  leaf's largest at qwen2-1.5b's full width on the card) may move
  differently, or either way; their count is reported;
* ``remat=True`` gives the remat-free gradients exactly;
* the mixture-of-experts archs: each MoE layer's routing on the port's
  inputs, by the port and by the reference's router on the same input;
  a flip is reported with its top-2 gap and must lie within float noise
  (gap < 1e-5).

Cross layers (llama-3.2-vision) get non-zero gates (tanh(0) = 0 would
leave their attention out of every gradient) and unit-variance media.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores, and torch's
# spinning OpenMP pool would otherwise slow each of them many times over
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.data import SyntheticLMStream as JStream  # noqa: E402
from repro.data import make_batch as j_make_batch  # noqa: E402
from repro.data import media_stub as j_media_stub  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import train as JT  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import train as TT  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

ARCHS = ("qwen2-1.5b", "stablelm-1.6b", "llama3.1-8b", "qwen3-8b",
         "gemma2-27b", "gemma3-12b")
BATCH, SEQ = 2, 32
STEPS, PEAK_LR, WARMUP = 3, 1e-3, 1
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 5e-5          # of each leaf's largest |gradient|
PARAM_ATOL = 1e-5         # 1 % of the lr
GRAD_FLOOR = 1e-3         # of each leaf's largest |gradient|
ROUTE_GAP = 1e-5


@dataclasses.dataclass
class Run:
    cfg_j: object
    cfg_t: object
    pj: dict
    batch: dict
    logits: np.ndarray
    aux: float
    loss: float
    grads: dict
    metrics: list
    params: dict


def _tree_np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def reference(arch: str) -> Run:
    """The reference's params, batch, forward, gradients and three
    ``train_step``s for ``arch``'s float32 smoke config."""
    cfg_j = dataclasses.replace(JC.smoke(arch), dtype="float32")
    cfg_t = dataclasses.replace(TC.smoke(arch), dtype="float32")
    pj = _tree_np(JM.init_params(cfg_j, jax.random.PRNGKey(1)))
    for stage in pj["stages"]:
        for layer in stage.values():
            if "cross_gate" in layer:
                layer["cross_gate"] = np.linspace(
                    0.3, 0.9, layer["cross_gate"].size,
                    dtype=np.float32).reshape(layer["cross_gate"].shape)
    tokens, labels = j_make_batch(JStream(cfg_j.vocab_size, seed=3), BATCH,
                                  SEQ)
    batch = {"tokens": tokens, "labels": labels}
    if cfg_j.family == "vlm":
        batch["media"] = j_media_stub(BATCH, cfg_j.num_media_tokens,
                                      cfg_j.d_model, 4) * 50.0
    if cfg_j.family == "audio":
        batch["media"] = j_media_stub(BATCH, cfg_j.encoder_seq,
                                      cfg_j.d_model, 4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fwd = jax.jit(lambda p, t, m: JM.forward_train(p, cfg_j, t, m,
                                                   remat=False))
    logits, aux = fwd(pj, jb["tokens"], jb.get("media"))
    vg = jax.jit(jax.value_and_grad(
        lambda p, t, y, m: JT.lm_loss(p, cfg_j, t, y, m, remat=False),
        has_aux=True))
    (_, mets), grads = vg(pj, jb["tokens"], jb["labels"], jb.get("media"))
    step = jax.jit(functools.partial(
        JT.train_step, cfg=cfg_j, peak_lr=PEAK_LR, warmup=WARMUP,
        total_steps=STEPS, remat=False))
    state, metrics = JT.TrainState(pj, j_adamw_init(pj)), []
    for _ in range(STEPS):
        state, m = step(state, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    return Run(cfg_j, cfg_t, pj, batch, np.asarray(logits), float(aux),
               float(mets["loss"]), _tree_np(grads), metrics,
               _tree_np(state.params))


def port_params(run: Run) -> dict:
    return convert.params_from_jax(run.pj, run.cfg_t, device="cpu")


def port_grads(run: Run, remat: bool):
    """(metrics, gradients in the port's tree)."""
    return TT.loss_grads(port_params(run), run.cfg_t, run.batch, remat)


def _pairs(a, *rest, path=""):
    """(path, leaf of ``a``, the same leaf of each of ``rest``) over trees
    of one structure, in ``a``'s order."""
    if isinstance(a, dict):
        for r in rest:
            assert set(a) == set(r), (path, sorted(a), sorted(r))
        for k in a:
            yield from _pairs(a[k], *(r[k] for r in rest),
                              path=f"{path}/{k}")
    elif isinstance(a, list):
        for r in rest:
            assert len(a) == len(r), path
        for i, x in enumerate(a):
            yield from _pairs(x, *(r[i] for r in rest), path=f"{path}/{i}")
    else:
        yield (path, np.asarray(a), *(np.asarray(r) for r in rest))


def check_forward(arch: str) -> None:
    run = reference(arch)
    logits, aux = TM.forward_train(port_params(run), run.cfg_t,
                                   run.batch["tokens"],
                                   run.batch.get("media"), remat=False)
    assert logits.shape == (BATCH, SEQ, run.cfg_t.vocab_size)
    np.testing.assert_allclose(logits.detach().numpy(), run.logits,
                               **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), run.aux, **LOGIT_TOL)


def check_grads(arch: str) -> None:
    run = reference(arch)
    mets, grads = port_grads(run, remat=False)
    np.testing.assert_allclose(float(mets["loss"]), run.loss, **LOGIT_TOL)
    worst = {}
    for path, g, want in _pairs(convert.params_to_jax(grads, run.cfg_t),
                                run.grads):
        assert g.shape == want.shape and g.dtype == want.dtype, path
        scale = max(float(np.abs(want).max()), 1e-30)
        worst[path] = float(np.abs(g - want).max()) / scale
    bad = {p: e for p, e in worst.items() if e > GRAD_RTOL}
    assert not bad, bad


def check_steps(arch: str) -> None:
    run = reference(arch)
    state = TT.TrainState(port_params(run), None)
    state = state._replace(opt=adamw_init(state.params))
    for i in range(STEPS):
        state, m = TT.train_step(state, run.batch, run.cfg_t,
                                 peak_lr=PEAK_LR, warmup=WARMUP,
                                 total_steps=STEPS, remat=False)
        for k in ("loss", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), run.metrics[i][k],
                                       **LOGIT_TOL, err_msg=f"step {i} {k}")
    assert int(state.opt.step) == STEPS
    below = compared = 0
    for path, p, want, g in _pairs(
            convert.params_to_jax(state.params, run.cfg_t), run.params,
            run.grads):
        keep = np.abs(g) > GRAD_FLOOR * max(float(np.abs(g).max()), 1e-30)
        below += int((~keep).sum())
        compared += int(keep.sum())
        err = np.abs(p - want)[keep]
        assert not err.size or err.max() <= PARAM_ATOL, (path, err.max())
    print(f"{arch}: params compared {compared}, below the gradient floor "
          f"{below}")
    assert compared >= 4 * below            # at least 80 % compared


def check_remat(arch: str) -> None:
    run = reference(arch)
    _, plain = port_grads(run, remat=False)
    mets, remat = port_grads(run, remat=True)
    assert torch.isfinite(mets["loss"])
    for path, a, b in _pairs(plain, remat):
        np.testing.assert_array_equal(a, b, err_msg=path)


def check_routing(arch: str, monkeypatch) -> None:
    """Record every MoE layer's input in the port's forward, then route it
    with the port's and the reference's router."""
    run = reference(arch)
    seen = []
    real = TMOE.moe_fwd

    def spy(p, x, top_k, *a, **kw):
        seen.append((p["router"].detach().clone(), x.detach().clone(),
                     top_k))
        return real(p, x, top_k, *a, **kw)
    monkeypatch.setattr(TMOE, "moe_fwd", spy)
    TM.forward_train(port_params(run), run.cfg_t, run.batch["tokens"],
                     run.batch.get("media"), remat=False)
    assert seen, "no MoE layer ran"
    flips = []
    for router, x, k in seen:
        xt = x.reshape(-1, x.shape[-1])
        probs, _, idx_t = TMOE._route({"router": router}, xt, k)
        _, _, idx_j = JMOE._route({"router": jnp.asarray(router.numpy())},
                                  jnp.asarray(xt.numpy()), k)
        top = probs.sort(-1, descending=True).values[:, :k + 1]
        gaps = (top[:, :-1] - top[:, 1:]).min(-1).values
        flipped = (idx_t.numpy() != np.asarray(idx_j)).any(-1)
        flips += [float(g) for g in gaps[torch.from_numpy(flipped)]]
    print(f"{arch}: {len(seen)} MoE layers, routing flips (top-2 gaps) "
          f"{flips}")
    assert all(g < ROUTE_GAP for g in flips), flips


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    check_steps(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    check_remat(arch)
