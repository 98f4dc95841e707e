"""The one traffic generator: it reads a traffic file's parameters and,
from the run's seed, makes every request the cell's clients send.

Parameters (``traffic/<name>.json``):

* ``loop``: ``closed`` — each of ``clients`` sends its next request the
  moment its last one has finished (no think time);
* ``shared_prefix_tokens``: a prefix every prompt begins with (0: none);
* ``prompt_tokens``, ``output_tokens``: the private prompt part's length
  and ``max_new_tokens``, each ``{"dist": "fixed", "value": n}`` or
  ``{"dist": "loguniform", "lo": a, "hi": b}``;
* ``sizes``: how many sizes make one round; 7 must not divide it.

So that every seed gets the same work in another order, lengths are not
drawn freely: a round is ``sizes`` requests whose prompt lengths are the
``sizes`` quantile midpoints of their distribution, rounded, each paired
with one of the output lengths' midpoints by a fixed rule (quantile i
with quantile (7·i + 3) mod ``sizes``, a spread that pairs short with
long as often as like with like); the seed shuffles the round's pairs,
and each round anew. Token ids are uniform over the
vocabulary, from the seed. Decoding is greedy; no request stops early
(no end-of-sequence token)."""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def grid(dist: Dict, n: int) -> np.ndarray:
    """The ``n`` lengths of one round, in ascending order."""
    if dist["dist"] == "fixed":
        return np.full((n,), int(dist["value"]), np.int64)
    if dist["dist"] != "loguniform":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    lo, hi = math.log(dist["lo"]), math.log(dist["hi"])
    q = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(lo + q * (hi - lo))).astype(np.int64)


class Traffic:
    """Requests of one run, in the order they are asked for."""

    def __init__(self, params: Dict, seed: int, vocab: int):
        if params.get("loop", "closed") != "closed":
            raise ValueError("only closed-loop traffic is defined")
        self.p = params
        self.vocab = vocab
        self.rng = np.random.default_rng(int(seed))
        self.clients = int(params["clients"])
        self.n = int(params["sizes"])
        self.prefix = self._tokens(int(params.get("shared_prefix_tokens",
                                                  0)))
        prompts = grid(params["prompt_tokens"], self.n)
        outs = grid(params["output_tokens"], self.n)
        if self.n % 7 == 0:
            raise ValueError("sizes: 7 divides it, so quantile i cannot "
                             "pair with (7·i + 3) mod sizes")
        pair = (7 * np.arange(self.n) + 3) % self.n
        self._pairs = list(zip(prompts.tolist(), outs[pair].tolist()))
        self._round: List = []
        self.made = 0

    def _tokens(self, n: int) -> np.ndarray:
        return self.rng.integers(0, self.vocab, size=(n,), dtype=np.int64
                                 ).astype(np.int32)

    def next(self):
        """→ (prompt (n,) int32, max_new_tokens)."""
        if not self._round:
            order = self.rng.permutation(self.n)
            self._round = [self._pairs[i] for i in order]
        own, out = self._round.pop()
        prompt = np.concatenate([self.prefix, self._tokens(own)])
        self.made += 1
        return prompt, out

