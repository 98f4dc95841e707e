"""MagicPIG-style baseline (Chen et al., 2024): SimHash LSH sampling
(port of ``repro/baselines/magicpig.py``).

L hash tables of K sign bits from random Gaussian projections, built over
the (prefill) keys. A key is a candidate when it collides with the query
in at least ``min_collisions`` tables; attention is estimated over the
sampled set. Projections drawn once from the prefill distribution's scale
do not adapt to decode drift (the paper's Fig. 1(a)). As in the
reference, the tables index prefill and decode keys alike (``append``).

A signature packs its K sign bits with bitwise OR into int64, equal as a
value to the reference's uint32 word. ``make_params`` draws from a
``torch.Generator`` and cannot reproduce ``jax.random.normal``: to share
the reference's tables, build ``LSHParams`` from its projections.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core.retrieval import lax_top_k


class LSHParams(NamedTuple):
    projections: torch.Tensor  # (L, K, d) float32


class LSHTables(NamedTuple):
    params: LSHParams
    codes: torch.Tensor        # (n, L) int64: packed K-bit signatures


def make_params(d: int, L: int = 10, K: int = 10, seed: int = 0,
                device=None) -> LSHParams:
    """Gaussian projections (L, K, d) from ``seed`` on ``device`` (the
    first CUDA card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LSHParams(torch.randn((L, K, d), generator=gen, device=dev))


def _signature(x: torch.Tensor, params: LSHParams) -> torch.Tensor:
    """x (..., d) → (..., L) packed sign bits: bit j of table l is set
    where the j-th projection of table l is ≥ 0."""
    proj = params.projections
    L, K, d = proj.shape
    y = x.float() @ proj.reshape(L * K, d).T.float()
    bits = (y >= 0).to(torch.int64).reshape(x.shape[:-1] + (L, K))
    packed = bits[..., 0]
    for j in range(1, K):
        packed = packed | (bits[..., j] << j)
    return packed


def build(keys: torch.Tensor, params: LSHParams) -> LSHTables:
    return LSHTables(params, _signature(keys, params))


def append(tables: LSHTables, new_keys: torch.Tensor) -> LSHTables:
    return LSHTables(tables.params, torch.cat(
        [tables.codes, _signature(new_keys, tables.params)], 0))


def retrieve(tables: LSHTables, q: torch.Tensor, top_k: int,
             min_collisions: int = 2) -> torch.Tensor:
    """The keys matching the query's signature in ≥ ``min_collisions``
    tables, ranked by collision count; a key below that scores 0. Most
    counts tie, so ``lax.top_k``'s rule (lowest index first) decides most
    of the output. → ids (top_k,) int32."""
    q_sig = _signature(q, tables.params)                    # (L,)
    hits = (tables.codes == q_sig[None, :]).sum(-1)         # (n,)
    score = torch.where(hits >= min_collisions, hits, 0)
    return lax_top_k(score, top_k)[1].to(torch.int32)


def sampled_attention(q: torch.Tensor, keys: torch.Tensor,
                      values: torch.Tensor, tables: LSHTables, top_k: int,
                      sm_scale: float, min_collisions: int = 2
                      ) -> torch.Tensor:
    """MagicPIG's estimator restricted to the LSH candidate set: a softmax
    over the retrieved keys' scores, applied to their values (float32)."""
    idx = retrieve(tables, q, top_k, min_collisions).long()
    k_sel, v_sel = keys[idx].float(), values[idx].float()
    p = torch.softmax(k_sel @ q.float() * sm_scale, -1)
    return p @ v_sel
