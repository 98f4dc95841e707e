"""AdamW, a cosine schedule and global-norm clipping (port of
``repro/optim/adamw.py``): functional updates on the port's parameter
tree (dicts and lists of tensors) under ``torch.no_grad()``.

The moments are float32 whatever the parameter's dtype, and so are the
clipped gradients (the reference's bfloat16 gradient times its float32
scale promotes).

Weight decay follows the reference's leaf shapes. The reference decays a
leaf of two or more dimensions, and stacks every layer's leaves on a
leading axis; the port keeps one dict per layer in a list. So a leaf
inside a list counts one dimension more than it has here: every
per-layer norm scale, bias, ``dt_bias``, ``A_log`` and ``D`` is decayed,
as the reference's (L, d) or (L, h) stacks are, and only a 0-d per-layer
scalar such as ``cross_gate`` is not; ``embed``, ``unembed``,
``final_norm`` and ``enc_final_norm`` keep their own ndim.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any              # first moment (the params' tree, float32)
    nu: Any              # second moment


def decay_mask(params):
    """The tree of booleans: decayed where the reference's leaf has two
    or more dimensions, i.e. one more per list the leaf sits in (a list
    is a stacked axis in the reference's tree)."""
    def mark(tree, depth: int):
        if isinstance(tree, dict):
            return {k: mark(v, depth) for k, v in tree.items()}
        if isinstance(tree, list):
            return [mark(v, depth + 1) for v in tree]
        return tree.dim() + depth >= 2
    return mark(params, 0)


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree_map(zeros, params), tree_map(zeros, params))


def cosine_schedule(step: torch.Tensor, peak_lr: float, warmup: int,
                    total: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``min_ratio · peak_lr`` at ``total`` (float32; 0 at step 0)."""
    s = torch.as_tensor(step).float()
    warm = s / max(warmup, 1)
    prog = ((s - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup, warm, cos)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """→ (grads scaled to a global norm of at most ``max_norm``, float32;
    the norm before clipping)."""
    gn = torch.sqrt(sum((g.float() ** 2).sum() for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / gn.clamp_min(1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gn


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr: torch.Tensor,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Any, AdamWState]:
    """One AdamW step → (new params in their own dtypes, new state); the
    bias corrections ``1 - b**t`` in float32, as the reference's."""
    step = state.step + 1
    t = step.float()
    f32 = torch.float32
    bc1 = 1 - torch.tensor(b1, dtype=f32, device=t.device) ** t
    bc2 = 1 - torch.tensor(b2, dtype=f32, device=t.device) ** t

    def upd(p, g, m, v, decay):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if decay:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu,
                   decay_mask(params))
    new_p, mu, nu = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return new_p, AdamWState(step, mu, nu)
