"""Data-independent 4-bit direction quantizer (port of
``repro/core/quantizer.py``).

Lloyd–Max levels for the analytic |u_j| prior are computed offline in numpy
(bit for bit the JAX package's). Code layout per coordinate: sign bit 3,
magnitude bits 0-2; an m=8 subspace packs into one 32-bit word, nibble j =
coordinate j. Torch has little uint32 support, so the port carries codes
as **int32 bit patterns**: nibble 7's sign lands in bit 31, and unpacking
with an arithmetic shift followed by ``& 0xF`` recovers every nibble.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

_GRID = 1 << 14


def _sqrt_beta_density(a: float, b: float, x: np.ndarray) -> np.ndarray:
    """Density of X on (0, 1) where X² ~ Beta(a, b)."""
    log_beta = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
    y = np.clip(x * x, 1e-12, 1 - 1e-12)
    fy = np.exp(-log_beta + (a - 1) * np.log(y) + (b - 1) * np.log(1 - y))
    return 2.0 * x * fy


def _lloyd_max(x: np.ndarray, f: np.ndarray, bits: int, iters: int):
    """Lloyd–Max levels of the density ``f`` on the grid ``x`` (summing to
    1): quantile starts, then centroid updates until they settle.
    → (thresholds, levels) float32."""
    n_levels = 1 << bits
    cdf = np.cumsum(f)
    qs = (np.arange(n_levels) + 0.5) / n_levels
    levels = x[np.searchsorted(cdf, qs).clip(0, _GRID - 1)]
    for _ in range(iters):
        thresholds = 0.5 * (levels[:-1] + levels[1:])
        idx = np.searchsorted(thresholds, x)
        new_levels = levels.copy()
        for t in range(n_levels):
            mask = idx == t
            w = f[mask]
            if w.sum() > 0:
                new_levels[t] = float((x[mask] * w).sum() / w.sum())
        if np.allclose(new_levels, levels, atol=1e-9):
            levels = new_levels
            break
        levels = new_levels
    thresholds = 0.5 * (levels[:-1] + levels[1:])
    return thresholds.astype(np.float32), levels.astype(np.float32)


@functools.lru_cache(maxsize=8)
def lloyd_max_levels(m: int, bits: int = 3, iters: int = 200):
    """Offline Lloyd–Max scalar quantizer for the analytic |u_j| prior.

    Returns (thresholds τ[2^bits - 1], levels a[2^bits]) as float32 numpy.
    """
    x = (np.arange(_GRID) + 0.5) / _GRID
    f = _sqrt_beta_density(0.5, (m - 1) / 2.0, x)     # |u_j|
    f /= f.sum()
    return _lloyd_max(x, f, bits, iters)


@functools.lru_cache(maxsize=16)
def radius_levels(m: int, D: int, bits: int = 2, iters: int = 200):
    """The optional radius quantizer (the paper's App. B.1.3), an ablation
    the serving path leaves out (K_r = 1): z = r² ~ Beta(m/2, (D − m)/2)
    under the rotation prior; Lloyd–Max on the density of r = √z gives
    data-independent radius centres. → (thresholds, levels) float32 numpy
    over r ∈ (0, 1), the reference's bit for bit."""
    x = (np.arange(_GRID) + 0.5) / _GRID
    f = _sqrt_beta_density(m / 2.0, (D - m) / 2.0, x)
    f /= f.sum()
    return _lloyd_max(x, f, bits, iters)


def quantize_radii(r: torch.Tensor, m: int, D: int,
                   bits: int = 2) -> torch.Tensor:
    """Radii r (...,) in (0, 1) → their quantized levels (K_r = 2^bits):
    searchsorted on the left side, as the reference."""
    tau, levels = radius_levels(m, D, bits)
    idx = torch.searchsorted(torch.from_numpy(tau).to(r.device),
                             r.float().contiguous())
    return torch.from_numpy(levels).to(r.device)[idx]


@functools.lru_cache(maxsize=16)
def level_tensors(m: int, bits: int, device: str):
    """(thresholds, levels) of ``lloyd_max_levels`` as float32 tensors on
    ``device``, copied once."""
    tau, levels = lloyd_max_levels(m, bits)
    return (torch.from_numpy(tau).to(device),
            torch.from_numpy(levels).to(device))


def quantize_magnitudes(x_abs: torch.Tensor, m: int,
                        bits: int = 3) -> torch.Tensor:
    """|u_j| → magnitude bucket (searchsorted, left side) as int32."""
    tau, _ = level_tensors(m, bits, str(x_abs.device))
    return torch.searchsorted(tau, x_abs.contiguous()).to(torch.int32)


def encode_directions(u: torch.Tensor, m: int, bits: int = 3) -> torch.Tensor:
    """Unit directions (..., B, m) → packed codes (..., B) as int32 bit
    patterns (the reference's uint32 words). Packed with bitwise OR in
    int64 — an integer ``sum`` would promote anyway — then wrapped into
    the int32 range."""
    if u.shape[-1] != m or m > 8:
        raise ValueError(f"codes pack m <= 8 coordinates, got {u.shape[-1]}")
    sign = (u >= 0).to(torch.int64)
    mag = quantize_magnitudes(u.abs(), m, bits).to(torch.int64)
    nibble = (sign << bits) | mag
    packed = nibble[..., 0]
    for j in range(1, m):
        packed = packed | (nibble[..., j] << (4 * j))
    packed = torch.where(packed >= 1 << 31, packed - (1 << 32), packed)
    return packed.to(torch.int32)


def decode_directions(codes: torch.Tensor, m: int,
                      bits: int = 3) -> torch.Tensor:
    """codes (..., B) int32 → reconstructed directions (..., B, m) float32."""
    _, lv = level_tensors(m, bits, str(codes.device))
    shifts = 4 * torch.arange(m, dtype=torch.int32, device=codes.device)
    nibbles = (codes[..., None] >> shifts) & 0xF
    sign = torch.where(((nibbles >> bits) & 1) == 1, 1.0, -1.0)
    mag = lv[(nibbles & ((1 << bits) - 1)).long()]
    return sign * mag
