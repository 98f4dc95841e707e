"""PQCache-style baseline (Zhang et al., 2025b; port of
``repro/baselines/pqcache.py``).

Product-quantization KV retrieval: coarse centroids are learned with
k-means on the prefill keys and per-subspace PQ codebooks quantize the
residuals. Its centroids go stale under decoding drift (the paper's Fig.
1): newly generated keys may fall far from every prefill-fitted centroid,
so their proxy scores are wrong and recall collapses.

The arithmetic is the reference's: squared distances as ‖x‖² − 2x·c +
‖c‖², the first minimum wins, new centroids as the one-hot product
``one.T @ x`` over the counts, an empty cluster keeps its old centroid.
The reference draws k-means' initial points with ``jax.random.permutation``;
torch cannot reproduce it, so ``kmeans`` and ``build_pq`` take the initial
indices as an optional argument and otherwise draw them from a
``torch.Generator`` seeded alike.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.retrieval import lax_top_k


def _init_points(n: int, k: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randperm(n, generator=gen)[:k].to(device)


def _sq_dist(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    return ((x * x).sum(-1)[:, None] - 2 * x @ cents.T
            + (cents * cents).sum(-1)[None])


def kmeans(x: torch.Tensor, k: int, iters: int = 20, seed: int = 0,
           init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lloyd's k-means. x (n, d) → centroids (k, d) float32, started from
    the points ``init`` (k,) (default: a permutation's first k from
    ``seed``)."""
    n = x.shape[0]
    x = x.float()
    if init is None:
        init = _init_points(n, k, seed, x.device)
    cents = x[torch.as_tensor(init, device=x.device).long()]
    for _ in range(iters):
        one = F.one_hot(_sq_dist(x, cents).argmin(-1), k).float()
        counts = one.sum(0)[:, None]
        cents = torch.where(counts > 0, (one.T @ x) / counts.clamp_min(1),
                            cents)
    return cents


def assign_clusters(keys: torch.Tensor,
                    centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid (n,) int64 of keys (n, d), the first on a tie."""
    return _sq_dist(keys.float(), centroids.float()).argmin(-1)


def coarse_retrieve(keys: torch.Tensor, centroids: torch.Tensor,
                    q: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keys ranked by their cluster's proxy score ⟨q, c⟩ (IVF-style, as
    PQCache's coarse stage): members of a cluster tie, lowest index first.
    → ids (top_k,) int32."""
    c_score = centroids.float() @ q.float()
    key_score = c_score[assign_clusters(keys, centroids)]
    return lax_top_k(key_score, top_k)[1].to(torch.int32)


class PQCodebook(NamedTuple):
    coarse: torch.Tensor         # (k_coarse, d) float32
    sub_codebooks: torch.Tensor  # (B, 256, m) PQ codebooks per subspace
    assignments: torch.Tensor    # (n,) int64 coarse cluster per key
    pq_codes: torch.Tensor       # (n, B) uint8


def build_pq(keys: torch.Tensor, n_coarse: int = 64, n_sub: int = 16,
             seed: int = 0, fit_sample: int = 32_768,
             coarse_init: Optional[torch.Tensor] = None,
             sub_init: Optional[Sequence[torch.Tensor]] = None
             ) -> PQCodebook:
    """Fit the coarse and product quantizers on the first ``fit_sample``
    keys (n, d), then assign every key. ``coarse_init`` (n_coarse,) and
    ``sub_init`` (n_sub arrays of 256) are the k-means' initial points;
    by default subspace b draws from ``seed + 1 + b``, as the reference."""
    n, d = keys.shape
    m = d // n_sub
    fit_n = min(n, fit_sample)
    coarse = kmeans(keys[:fit_n], n_coarse, seed=seed, init=coarse_init)
    assignments = assign_clusters(keys, coarse)
    subs = (keys.float() - coarse[assignments]).reshape(n, n_sub, m)
    cbs, codes = [], []
    for b in range(n_sub):
        cb = kmeans(subs[:fit_n, b], 256, iters=8, seed=seed + 1 + b,
                    init=None if sub_init is None else sub_init[b])
        cbs.append(cb)
        codes.append(assign_clusters(subs[:, b], cb))
    return PQCodebook(coarse, torch.stack(cbs), assignments,
                      torch.stack(codes, -1).to(torch.uint8))


def pq_retrieve(book: PQCodebook, q: torch.Tensor, top_k: int,
                n_probe: int = 8) -> torch.Tensor:
    """PQCache's decode path: probe the best coarse clusters, rank their
    members by the asymmetric PQ distance (ADC). A key is probed when its
    cluster scores at least the ``n_probe``-th largest cluster score, so
    clusters tied there are all probed; the others score -1e30 and tie
    among themselves. → ids (top_k,) int32."""
    qf = q.float()
    c_score = book.coarse @ qf
    B = book.pq_codes.shape[1]
    m = book.sub_codebooks.shape[-1]
    lut = (book.sub_codebooks * qf.reshape(B, 1, m)).sum(-1)  # (B, 256)
    resid = lut.gather(-1, book.pq_codes.long().T).sum(0)     # (n,)
    probe = c_score[book.assignments]
    thresh = lax_top_k(c_score, n_probe)[0][-1]
    score = torch.where(probe >= thresh, probe + resid,
                        torch.tensor(-1e30, device=qf.device))
    return lax_top_k(score, top_k)[1].to(torch.int32)
