"""Synthetic token streams, batches and media (numpy copies of
``repro/data/pipeline.py``'s ``SyntheticLMStream``, ``make_batch`` and
``media_stub``, so the port's CLIs send the reference's prompts, batches
and media).

A deterministic mixture of Zipf-distributed unigrams and short repeated
motifs: the same seed gives the same sequences as the reference.
"""
from __future__ import annotations

from typing import Tuple

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


def make_batch(stream: SyntheticLMStream, batch: int, seq_len: int,
               host_id: int = 0, num_hosts: int = 1
               ) -> Tuple[np.ndarray, np.ndarray]:
    """→ (tokens (b, s), labels (b, s)) int32 of this host's shard: the
    next ``batch // num_hosts`` sequences of the stream, each of
    ``seq_len + 1`` tokens, labels shifted by one."""
    if batch % num_hosts:
        raise ValueError(f"batch {batch} does not split over {num_hosts} "
                         f"hosts")
    rows = np.stack([stream.sequence(seq_len + 1)
                     for _ in range(batch // num_hosts)])
    return rows[:, :-1], rows[:, 1:]


def media_stub(batch: int, num_tokens: int, d_model: int,
               seed: int = 0) -> np.ndarray:
    """Precomputed image-patch / audio-frame embeddings (batch,
    num_tokens, d_model) float32: the stand-in for a vision encoder's
    patches or whisper's mel frontend, bit for bit the reference's."""
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, num_tokens, d_model) * 0.02).astype(np.float32)
