"""ParisKV in PyTorch + CUDA: the H100 port of the JAX package ``repro``.

The package mirrors ``repro``'s module layout (``core``, ``kernels``,
``models``, ``serving``, ``configs``) so each module's counterpart is easy
to find. It imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing from ``repro``.

Device policy: entry points (engine, ``prefill``, ``decode_chunk``, param
init) run on ``cuda`` unless the caller passes ``device="cpu"``. With no
card and no ``device=`` they raise; they never drop to the CPU quietly.
Kernel wrappers dispatch on the device of the tensors they are given: the
plain PyTorch version for CPU tensors, the hand-written Hopper kernel for
CUDA tensors (or an exception — there is no fallback on the card).
"""
from __future__ import annotations

from typing import Callable, List

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` → ``torch.device``; ``None`` means the first CUDA card.

    Raises when no card is present and the caller did not ask for the CPU
    explicitly, so a missing GPU is an error rather than a silent (and
    orders of magnitude slower) CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (a parameter tree: dicts and
    lists of tensors) and the same leaves of ``rest``, trees of its
    structure; anything but a dict or a list is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out
