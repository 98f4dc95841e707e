"""Synthetic token streams (a numpy copy of ``repro/data/pipeline.py``'s
``SyntheticLMStream``, so the port's CLI sends the reference's prompts).

A deterministic mixture of Zipf-distributed unigrams and short repeated
motifs: the same seed gives the same sequences as the reference.
"""
from __future__ import annotations

import numpy as np


class SyntheticLMStream:
    """Deterministic, restartable synthetic token stream."""

    def __init__(self, vocab_size: int, seed: int = 0, motif_len: int = 16,
                 num_motifs: int = 64, motif_prob: float = 0.5):
        self.vocab = vocab_size
        self.rng = np.random.RandomState(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.motifs = self.rng.randint(
            0, vocab_size, size=(num_motifs, motif_len))
        self.motif_prob = motif_prob

    def sequence(self, length: int) -> np.ndarray:
        out = np.empty(length, np.int32)
        i = 0
        while i < length:
            if self.rng.rand() < self.motif_prob:
                m = self.motifs[self.rng.randint(len(self.motifs))]
                n = min(len(m), length - i)
                out[i:i + n] = m[:n]
                i += n
            else:
                n = min(self.rng.randint(4, 32), length - i)
                out[i:i + n] = self.rng.choice(
                    self.vocab, size=n, p=self.unigram)
                i += n
        return out
