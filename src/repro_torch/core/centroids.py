"""Analytic sign-pattern centroids Ω = {±1/√m}^m (port of
``repro/core/centroids.py``).

Assignment is sign-bit packing: the nearest centroid of a unit direction u
has bit j set ⇔ u_j ≥ 0. A query's scores against all 2^m centroids are
its products with the (2^m × m) codebook.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def codebook(m: int) -> np.ndarray:
    """(2^m, m) centroid matrix; row id = packed sign bits. Built in float64
    and rounded to float32 once, as the reference's ``jnp.asarray`` does."""
    n = 1 << m
    ids = np.arange(n, dtype=np.uint32)[:, None]
    bits = (ids >> np.arange(m, dtype=np.uint32)[None, :]) & 1
    omega = ((bits.astype(np.float32) * 2.0) - 1.0) / np.sqrt(m)
    return omega.astype(np.float32)


def assign(u: torch.Tensor) -> torch.Tensor:
    """Unit directions (..., m) → packed sign bits (...,) uint8 (m ≤ 8)."""
    m = u.shape[-1]
    if m > 8:
        raise ValueError(f"uint8 centroid ids need m <= 8, got {m}")
    bits = (u >= 0).to(torch.int32)
    packed = bits[..., 0]
    for j in range(1, m):
        packed = packed | (bits[..., j] << j)
    return packed.to(torch.uint8)


@functools.lru_cache(maxsize=8)
def _codebook_on(m: int, device: str) -> torch.Tensor:
    """The codebook (2^m, m), copied to ``device`` once."""
    return torch.from_numpy(codebook(m)).to(device)


def centroid_scores(q_sub: torch.Tensor, m: int) -> torch.Tensor:
    """q_sub (..., B, m) → (..., B, 2^m) with entry [b, c] = ⟨q_b, ω_c⟩,
    as products and sums rather than a matmul: a GEMM's rounding depends
    on its row count, and a head-sharded rank's rows must score as one
    device's (their ranks set the tier weights)."""
    return (q_sub.float()[..., None, :]
            * _codebook_on(m, str(q_sub.device))).sum(-1)


def decode_centroid(ids: torch.Tensor, m: int) -> torch.Tensor:
    """Centroid ids (...,) → centroid vectors (..., m) float32, an oracle
    and test helper."""
    return _codebook_on(m, str(ids.device))[ids.long()]
