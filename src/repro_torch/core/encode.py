"""Key summarization and query transform (port of ``repro/core/encode.py``).

``encode_keys`` builds the per-key metadata both retrieval stages read:

  * ``centroid_ids`` — Stage-I sign-pattern bucket ids, (..., n, B) uint8
  * ``codes``        — Stage-II 4-bit direction codes, (..., n, B) int32
                       (bit patterns of the reference's uint32 words)
  * ``weights``      — w_{i,b} = ‖k_i‖ · r_{i,b} / α_{i,b}, (..., n, B) f32

``encode_query`` applies the same normalize → rotate → split transform.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import centroids, quantizer, srht
from repro_torch.core.config import ParisKVConfig

_EPS = 1e-20


class KeyMetadata(NamedTuple):
    centroid_ids: torch.Tensor  # (..., n, B) uint8
    codes: torch.Tensor         # (..., n, B) int32
    weights: torch.Tensor       # (..., n, B) float32


class QueryTransform(NamedTuple):
    q_norm: torch.Tensor  # (...,)    ‖q‖₂
    q_sub: torch.Tensor   # (..., B, m) rotated subspace components q̃_b


def rotate_split(x: torch.Tensor, cfg: ParisKVConfig,
                 signs: torch.Tensor) -> torch.Tensor:
    """normalize → SRHT rotate → split into (..., B, m) subspaces."""
    xf = x.float()
    norm = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
    x_rot = srht.srht_rotate(xf / norm.clamp_min(_EPS), signs)
    dp = x_rot.shape[-1]
    return x_rot.reshape(x.shape[:-1] + (dp // cfg.m, cfg.m))


def encode_keys(keys: torch.Tensor, cfg: ParisKVConfig,
                signs: torch.Tensor) -> KeyMetadata:
    """Summarize raw keys (..., n, D) into retrieval metadata."""
    norm = torch.linalg.vector_norm(keys.float(), dim=-1)       # (..., n)
    sub = rotate_split(keys, cfg, signs)                        # (..., n, B, m)
    r = torch.linalg.vector_norm(sub, dim=-1)                   # (..., n, B)
    u = sub / r[..., None].clamp_min(_EPS)                      # unit dirs
    ids = centroids.assign(u)
    codes = quantizer.encode_directions(u, cfg.m, cfg.magnitude_bits)
    # alignment α = ⟨v, u⟩ (v shares u's signs ⇒ α > 0; guard anyway) and
    # weight w = ‖k‖ r / α
    v = quantizer.decode_directions(codes, cfg.m, cfg.magnitude_bits)
    alpha = (v * u).sum(-1).clamp_min(1e-4)
    weights = norm[..., None] * r / alpha
    return KeyMetadata(ids, codes, weights.float())


def encode_query(q: torch.Tensor, cfg: ParisKVConfig,
                 signs: torch.Tensor) -> QueryTransform:
    """Transform an online query (..., D) identically to the keys."""
    q_norm = torch.linalg.vector_norm(q.float(), dim=-1)
    return QueryTransform(q_norm, rotate_split(q, cfg, signs))
