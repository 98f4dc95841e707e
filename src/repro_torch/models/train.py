"""Training step (port of ``repro/models/train.py``): the loss, its
gradients and an AdamW update, a function of (params, optimizer state,
batch).

Gradients come from ``torch.autograd.grad`` over detached views of the
parameters that require grad, so a step leaves no ``.grad`` behind and
the caller's tensors untouched; AdamW returns new tensors.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree_leaves, tree_map
from repro_torch.core.config import ModelConfig
from repro_torch.models.model import forward_train
from repro_torch.optim import (AdamWState, adamw_update, clip_by_global_norm,
                               cosine_schedule)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def lm_loss(params: dict, cfg: ModelConfig, tokens, labels,
            media: Optional[torch.Tensor] = None, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL from a float32 log-softmax, plus
    ``router_aux_loss_coef`` · the experts' aux loss → (total, {"loss",
    "aux"})."""
    logits, aux = forward_train(params, cfg, tokens, media, remat=remat)
    logp = F.log_softmax(logits.float(), -1)
    labels = torch.as_tensor(labels, device=logp.device).long()
    loss = -logp.gather(-1, labels[..., None])[..., 0].mean()
    total = loss + cfg.router_aux_loss_coef * aux
    return total, {"loss": loss, "aux": aux}


def loss_grads(params, cfg: ModelConfig, batch: Dict[str, Any],
               remat: bool = True
               ) -> Tuple[Dict[str, torch.Tensor], Any]:
    """``lm_loss``'s metrics ("loss", "aux", detached) and its gradients
    at ``params``, in the params' tree."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    total, metrics = lm_loss(leaves, cfg, batch["tokens"], batch["labels"],
                             batch.get("media"), remat=remat)
    grads = iter(torch.autograd.grad(total, tree_leaves(leaves)))
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), leaves))


def train_step(state: TrainState, batch: Dict[str, Any], cfg: ModelConfig,
               peak_lr: float = 3e-4, warmup: int = 100,
               total_steps: int = 10_000, remat: bool = True
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step on ``batch`` ({"tokens", "labels"} (b, s), "media" for
    the vlm and audio families): gradients, clipping to a global norm of
    1, the cosine schedule's lr at the optimizer's step (0 at step 0),
    AdamW. → (new state, metrics "loss", "aux", "grad_norm", "lr")."""
    metrics, grads = loss_grads(state.params, cfg, batch, remat)
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    lr = cosine_schedule(state.opt.step, peak_lr, warmup, total_steps)
    params, opt = adamw_update(state.params, grads, state.opt, lr)
    return TrainState(params, opt), dict(metrics, grad_norm=gnorm, lr=lr)
