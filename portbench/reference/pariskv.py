"""ParisKV's retrieval, written out plainly from the paper's description
(arXiv ParisKV, Algorithm 1 and App. B) in float32 PyTorch.

Nothing here imports the program. The constants that define the method
(the SRHT's sign seed, the sign-pattern codebook, the Lloyd–Max levels of
the 4-bit direction code, the collision tiers) are computed here from
the configuration's numbers, the same way the method states them.

For one query head at one decode position, over the retrieval region
[sink, enc_end) of its KV head:

1. every key is normalised, rotated by the SRHT, split into B subspaces
   of m coordinates; each subspace gets its sign-pattern centroid id, a
   4-bit code per coordinate (sign + Lloyd–Max magnitude) and the weight
   ``|k| · r_b / <v_b, u_b>``;
2. Stage I: the query's subspace scores against the 2^m centroids rank
   the centroids; walking them in that order, the cumulative count of
   region keys in each centroid's bucket (over ``rho`` · n) gives a tier,
   and the tier its weight; a key scores the sum of its buckets' weights;
3. the C best scores survive (ties to the lower position);
4. Stage II: the RSQ-IP estimate ``|q| Σ_b w_b <v_b, q_b>`` of each
   survivor; the ``top_k`` best win (ties to the lower position);
5. attention is one softmax over the sink, the winners and the local
   window.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

_EPS = 1e-20
_GRID = 1 << 14


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def signs(dim: int, seed: int) -> np.ndarray:
    """The SRHT's Rademacher signs: numpy's legacy generator seeded with
    the configuration's ``srht_seed``."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    return (rng.randint(0, 2, size=(dim,)) * 2 - 1).astype(np.float32)


def hadamard(n: int) -> np.ndarray:
    """The (n, n) Sylvester–Hadamard matrix, unnormalised."""
    h = np.ones((1, 1), np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def _lloyd_max(bits: int, m: int, iters: int = 200) -> Tuple[np.ndarray,
                                                            np.ndarray]:
    """Thresholds and levels of the Lloyd–Max quantiser of |u_j| for a
    uniform direction u in m dimensions (u_j² ~ Beta(1/2, (m-1)/2)), on a
    grid of 2^14 points, started at the quantiles."""
    x = (np.arange(_GRID) + 0.5) / _GRID
    a, b = 0.5, (m - 1) / 2.0
    log_beta = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
    y = np.clip(x * x, 1e-12, 1 - 1e-12)
    f = 2.0 * x * np.exp(-log_beta + (a - 1) * np.log(y)
                         + (b - 1) * np.log(1 - y))
    f /= f.sum()
    n = 1 << bits
    cdf = np.cumsum(f)
    levels = x[np.searchsorted(cdf, (np.arange(n) + 0.5) / n).clip(0,
                                                                _GRID - 1)]
    for _ in range(iters):
        thr = 0.5 * (levels[:-1] + levels[1:])
        idx = np.searchsorted(thr, x)
        new = levels.copy()
        for t in range(n):
            w = f[idx == t]
            if w.sum() > 0:
                new[t] = float((x[idx == t] * w).sum() / w.sum())
        done = np.allclose(new, levels, atol=1e-9)
        levels = new
        if done:
            break
    thr = 0.5 * (levels[:-1] + levels[1:])
    return thr.astype(np.float32), levels.astype(np.float32)


class Index:
    """The fixed parts of the method for one key width ``dim``."""

    def __init__(self, pk: Dict, dim: int, device):
        self.pk = pk
        self.m = int(pk["m"])
        self.dp = next_pow2(max(dim, self.m))
        self.B = self.dp // self.m
        self.nc = 1 << self.m
        s = signs(self.dp, int(pk["srht_seed"]))
        rot = hadamard(self.dp) * s[None, :] / np.sqrt(self.dp)
        # x -> rot @ pad(x): as a right product, x @ rot.T
        self.rot_t = torch.from_numpy(rot.T.astype(np.float32)).to(device)
        bits = np.arange(self.m)
        ids = np.arange(self.nc)[:, None]
        cb = ((((ids >> bits[None]) & 1) * 2.0 - 1.0)
              / np.sqrt(self.m)).astype(np.float32)
        self.codebook = torch.from_numpy(cb).to(device)        # (nc, m)
        thr, lv = _lloyd_max(int(pk["magnitude_bits"]), self.m)
        self.thr = torch.from_numpy(thr).to(device)
        self.levels = torch.from_numpy(lv).to(device)
        self.pcts = torch.tensor(pk["tier_pcts"], dtype=torch.float32,
                                 device=device)
        self.wts = torch.tensor(list(pk["tier_weights"]) + [0],
                                dtype=torch.float32, device=device)
        self.dim = dim

    # ----------------------------------------------------------- keys ----
    def split(self, x: torch.Tensor) -> torch.Tensor:
        """(..., dim) → unit, rotated, split (..., B, m) float32."""
        x = x.float()
        x = x / torch.linalg.vector_norm(x, dim=-1,
                                         keepdim=True).clamp_min(_EPS)
        x = torch.nn.functional.pad(x, (0, self.dp - self.dim))
        return (x @ self.rot_t).reshape(x.shape[:-1] + (self.B, self.m))

    def encode(self, keys: torch.Tensor):
        """keys (n, dim) → (ids (n, B) int64, summary (n, dp) float32):
        the bucket ids and, per key, the concatenation over subspaces of
        w_b · v_b (v_b the decoded code), so that a query's RSQ-IP
        estimate is |q| · <q_split, summary>."""
        norm = torch.linalg.vector_norm(keys.float(), dim=-1)
        sub = self.split(keys)
        r = torch.linalg.vector_norm(sub, dim=-1)
        u = sub / r[..., None].clamp_min(_EPS)
        pos = u >= 0
        ids = (pos.long() << torch.arange(self.m, device=u.device)).sum(-1)
        mag = torch.searchsorted(self.thr, u.abs().contiguous())
        v = torch.where(pos, 1.0, -1.0) * self.levels[mag]
        alpha = (v * u).sum(-1).clamp_min(1e-4)
        w = norm[:, None] * r / alpha
        return ids, (w[..., None] * v).reshape(keys.shape[0], self.dp)

    # -------------------------------------------------------- retrieval ---
    def winners(self, q: torch.Tensor, ids: torch.Tensor,
                summary: torch.Tensor, n_valid: int, num_candidates: int,
                top_k: int) -> torch.Tensor:
        """Queries q (Q, dim) of one KV head over its region's n_valid keys
        (ids (n, B), summary (n, dp), n >= n_valid; rows past n_valid are
        not in the region) → (Q, min(top_k, n_valid)) winner offsets into
        the region."""
        Q = q.shape[0]
        n = n_valid
        if n == 0:
            return torch.zeros((Q, 0), dtype=torch.long, device=q.device)
        ids, summary = ids[:n], summary[:n]
        qs = self.split(q)                                    # (Q, B, m)
        cs = qs @ self.codebook.T                             # (Q, B, nc)
        counts = torch.zeros((self.B, self.nc), device=q.device)
        counts.scatter_add_(1, ids.T.contiguous(),
                            torch.ones_like(ids.T, dtype=torch.float32))
        order = torch.sort(-cs, dim=-1, stable=True).indices
        cnt = counts[None].expand(Q, -1, -1).gather(-1, order)
        before = cnt.cumsum(-1) - cnt
        frac = before / max(n * float(self.pk["rho"]), 1.0)
        tier = torch.searchsorted(self.pcts, frac.contiguous(), right=True)
        table = torch.zeros_like(cs).scatter_(
            -1, order, self.wts[tier.clamp_max(len(self.wts) - 1)])
        # a key's score is Σ_b table[b, id_b]: as one product with the
        # keys' one-hot bucket matrix, exact (integers below 2048 in fp16
        # with float32 sums)
        onehot = torch.zeros((n, self.B * self.nc), dtype=torch.float16,
                             device=q.device)
        onehot.scatter_(1, ids + torch.arange(self.B, device=q.device)
                        * self.nc, 1.0)
        scores = (table.reshape(Q, -1).half() @ onehot.T).float()
        c = min(num_candidates, n)
        cand = torch.sort(scores, dim=-1, descending=True,
                          stable=True).indices[:, :c]
        cand = cand.sort(dim=-1).values       # stage II sees them in order
        qn = torch.linalg.vector_norm(q.float(), dim=-1)
        est = qn[:, None] * (summary[cand] * qs.reshape(Q, 1, -1)).sum(-1)
        k = min(top_k, c)
        pick = torch.sort(est, dim=-1, descending=True,
                          stable=True).indices[:, :k]
        return cand.gather(-1, pick)


def candidate_count(pk: Dict, n_max: int) -> int:
    """C for a store of n_max positions: ceil(beta · n_max) clamped to
    [min_candidates, max_candidates], at least top_k, at most n_max."""
    c = int(math.ceil(float(pk["beta"]) * n_max))
    c = max(int(pk["min_candidates"]), min(int(pk["max_candidates"]), c))
    return min(max(c, int(pk["top_k"])), n_max)


def region_schedule(prompt_len: int, steps: int, pk: Dict):
    """The retrieval region's end at each of ``steps`` decode steps of a
    sequence whose prompt holds ``prompt_len`` tokens: it starts at
    max(min(L, sink), L - local) and moves by ``update_interval`` after
    every step at whose start the window (local + update_interval) is
    full. → list of enc_end, one per step."""
    sink, local = int(pk["sink_size"]), int(pk["local_size"])
    U = int(pk["update_interval"])
    W = local + U
    enc = max(min(prompt_len, sink), prompt_len - local)
    pos = prompt_len - 1
    out = []
    for _ in range(steps):
        out.append(enc)
        if pos + 1 - enc >= W:
            enc += U
        pos += 1
    return out


def attended(p: int, enc_end: int, pk: Dict, device) -> torch.Tensor:
    """(p + 1,) bool: the sink and local-window positions a decode step at
    position p attends to besides its winners."""
    sink = int(pk["sink_size"])
    W = int(pk["local_size"]) + int(pk["update_interval"])
    pos = torch.arange(p + 1, device=device)
    ws = max(p + 1 - W, 0)
    return (pos < sink) | ((pos >= ws) & (pos >= enc_end) & (pos >= sink))
