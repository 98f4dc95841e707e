"""Randomized Hadamard rotation (port of ``repro/core/srht.py``).

    R x = (1 / sqrt(Dp)) * H_Dp (s ⊙ pad(x))

``s`` is a fixed Rademacher sign vector (numpy, so its values are the JAX
package's bit for bit) and ``H_Dp`` the Walsh–Hadamard matrix of the next
power-of-two dimension. The FWHT runs as log2(Dp) butterfly steps in the
same order as the reference, so the rotation is bitwise reproducible on
the same device.
"""
from __future__ import annotations

import numpy as np
import torch


def rademacher_signs(dim_padded: int, seed: int) -> np.ndarray:
    """Deterministic Rademacher sign vector shared by keys and queries."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    return (rng.randint(0, 2, size=(dim_padded,)) * 2 - 1).astype(np.float32)


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized fast Walsh–Hadamard transform along the last axis."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"FWHT length must be a power of two, got {n}")
    shape = x.shape
    h = 1
    while h < n:
        y = x.reshape(shape[:-1] + (n // (2 * h), 2, h))
        a, b = y[..., 0, :], y[..., 1, :]
        x = torch.cat([a + b, a - b], dim=-1).reshape(shape)
        h *= 2
    return x


def pad_pow2(x: torch.Tensor, dim_padded: int) -> torch.Tensor:
    d = x.shape[-1]
    if d == dim_padded:
        return x
    return torch.nn.functional.pad(x, (0, dim_padded - d))


def srht_rotate(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """Apply the shared orthogonal rotation along the last axis; returns
    float32 with last dim ``len(signs)``."""
    dp = signs.shape[-1]
    y = fwht(pad_pow2(x, dp).float() * signs)
    return y * float(1.0 / np.sqrt(dp))      # applied as a float32 scalar


def srht_rotate_t(y: torch.Tensor, signs: torch.Tensor,
                  out_dim: int) -> torch.Tensor:
    """The inverse (= transpose) rotation, cut back to ``out_dim``
    features; an oracle for tests."""
    dp = signs.shape[-1]
    x = fwht(y.float()) * float(1.0 / np.sqrt(dp)) * signs
    return x[..., :out_dim]
