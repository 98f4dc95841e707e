"""Frozen counts of work: the FLOPs and bytes a decode step, a prefill and
each retrieval kernel launch need, from the configuration's shapes and
the sequences' lengths alone (never from the program's code).

A decode row is (L, d): a sequence of prompt length L at its d-th decode
step (0-based); its region end and window follow from
``reference.pariskv.region_schedule``. Bytes count each input byte read
once and each output byte written once, at the served types: bf16
activations and weights, uint8 bucket ids, int32 codes and positions,
float32 code weights and scores."""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

from portbench.lib.spec import head_dim
from portbench.reference.pariskv import candidate_count, next_pow2

PEAK_FLOPS = 989e12          # H100 SXM, dense bf16
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
SEG = 256                    # positions per score-histogram segment
_E = 2                       # bytes of a bf16 element


class Shapes:
    """Everything the counts need about a cell's decode."""

    def __init__(self, cfg: Dict, n_max: int, batch: int):
        pk = cfg["pariskv"]
        self.cfg, self.pk, self.b, self.n = cfg, pk, batch, n_max
        self.H = cfg["num_attention_heads"]
        self.G = cfg["num_key_value_heads"]
        self.Hg = self.H // self.G
        self.D = head_dim(cfg)
        m = int(pk["m"])
        self.m = m
        self.B = next_pow2(max(self.D, m)) // m
        self.nc = 1 << m
        self.rng = max(pk["tier_weights"]) * self.B
        self.C = candidate_count(pk, n_max)
        self.k = int(pk["top_k"])
        self.sink = int(pk["sink_size"])
        self.W = int(pk["local_size"]) + int(pk["update_interval"])
        self.U = int(pk["update_interval"])
        self.nseg = -(-n_max // SEG)
        self.layers = cfg["num_hidden_layers"]


def region(L: int, d: int, pk: Dict) -> Tuple[int, bool]:
    """(enc_end at decode step d of a prompt of L tokens, whether step d
    promotes). The window (local + update_interval) first fills at step
    j* = max(0, enc_0 + W - L); it promotes then and every
    update_interval steps after, each time moving enc_end by that much."""
    sink, local, U = pk["sink_size"], pk["local_size"], pk["update_interval"]
    enc0 = max(min(L, sink), L - local)
    first = max(0, enc0 + local + U - L)
    moves = 0 if d <= first else (d - 1 - first) // U + 1
    return enc0 + U * moves, d >= first and (d - first) % U == 0


def chunk_rows(step_rec: Dict) -> List[Tuple[int, int]]:
    """The (L, d) of every decode row-step of one ``step_serve``."""
    return [(L, d0 + j) for L, d0, n in step_rec["rows"] for j in range(n)]


# ----------------------------------------------------------- kernels ----
def stage1_bytes(s: Shapes, regions: Iterable[int]) -> int:
    """One Stage-I launch over the batch, rows with region sizes
    ``regions``: the region's ids, the tier weights, the block table and
    region ends in; every position's score and the segment histograms
    out."""
    ids = sum(regions) * s.G * s.B
    table = s.b * s.G * s.Hg * s.B * s.nc
    tables = s.b * (s.n // 128) * 4 + s.b * 4
    out = s.b * s.G * s.Hg * (s.n * 4 + s.nseg * (s.rng + 2) * 4)
    return ids + table + tables + out


def topc_bytes(s: Shapes, regions: Iterable[int]) -> int:
    """One top-C launch: the segment histograms and the scores of every
    segment that overlaps a region in, C positions out."""
    hist = s.b * s.G * s.Hg * s.nseg * (s.rng + 2) * 4
    segs = sum(min(s.nseg, -(-(s.sink + r) // SEG)) - s.sink // SEG
               if r > 0 else 0 for r in regions)
    return hist + segs * SEG * 4 * s.G * s.Hg + s.b * s.G * s.Hg * s.C * 4


def stage2_bytes(s: Shapes, regions: Iterable[int]) -> int:
    """One Stage-II + top-k launch: the candidates' positions, the codes
    and code weights of at least C distinct keys per KV head (the query
    heads of a group may pick the same ones), the queries in; every
    candidate's estimate and the winners' estimate, position, row and
    block out."""
    n_c = sum(min(s.C, r) for r in regions) * s.G
    cand = s.b * s.G * s.Hg * s.C * 4
    codes = n_c * s.B * (4 + 4)
    q = s.b * s.G * s.Hg * (s.B * s.m + 1) * 4
    out = s.b * s.G * s.Hg * (s.C * 4 + s.k * 16)
    return cand + codes + q + out


def gather_bytes(s: Shapes, regions: Iterable[int]) -> int:
    """One decode gather: each row's sink and window rows and its winners'
    head rows (at least top-k distinct per KV head) in, all of them out."""
    row = s.D * _E
    dense = s.b * (s.sink + s.W) * s.G * row * 2
    wins = sum(min(s.k, r) for r in regions) * s.G * row * 2
    out = dense + s.b * s.G * s.Hg * s.k * row * 2
    return dense + wins + out


def promote_gather_bytes(s: Shapes) -> int:
    """One promotion gather: U keys of every row (keys only) in and out."""
    return 2 * s.b * s.U * s.G * s.D * _E


# ------------------------------------------------------------ model ------
def weight_bytes(cfg: Dict) -> int:
    """Every weight once, at 2 bytes; the embedding table once (the
    unembedding reads it whole, or its own matrix)."""
    from portbench.lib.weights import leaves
    return sum(math.prod(shape) * _E for path, shape, _ in leaves(cfg)
               # untied, only b rows of the embedding are read
               if path != ("embed",) or cfg["tie_word_embeddings"])


def matmul_params(cfg: Dict) -> int:
    """Parameters a token multiplies with: attention, MLP and the
    unembedding."""
    d, V, H = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    G, hd = cfg["num_key_value_heads"], head_dim(cfg)
    per_layer = 2 * d * H * hd + 2 * d * G * hd + 3 * d * cfg[
        "intermediate_size"]
    return d * V + per_layer * cfg["num_hidden_layers"]


def decode_chunk(s: Shapes, step_rec: Dict) -> Tuple[float, float]:
    """(FLOPs, bytes) that one ``step_serve``'s decode steps need: every
    active row-step's products, attention and retrieval, and each step's
    weights once."""
    rows = chunk_rows(step_rec)
    flops = 2.0 * matmul_params(s.cfg) * len(rows)
    byts = float(weight_bytes(s.cfg)) * step_rec["steps"]
    for L, d in rows:
        enc, _ = region(L, d, s.pk)
        pos = L + d
        reg = max(enc - s.sink, 0)
        keys = (min(s.sink, pos + 1) + min(s.k, reg)
                + max(0, pos + 1 - max(enc, s.sink, pos + 1 - s.W)))
        flops += 4.0 * s.H * keys * s.D
        # Stage I adds B weights per key and query head; Stage II takes
        # 2·B·m per candidate and query head
        flops += s.G * s.Hg * (reg * s.B + 2.0 * min(s.C, reg) * s.B * s.m)
        byts += (keys * s.G * s.D * _E * 2 + reg * s.G * s.B
                 + min(s.C, reg) * s.G * s.B * 8)
    return flops, byts


def prefill(cfg: Dict, L: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of a solo prefill of L tokens: the products and the
    causal attention's two products; the weights read once."""
    H, hd = cfg["num_attention_heads"], head_dim(cfg)
    att = 2.0 * H * 2 * hd * L * (L + 1) / 2 * cfg["num_hidden_layers"]
    return 2.0 * matmul_params(cfg) * L + att, float(weight_bytes(cfg))


def step_time_bound(flops: float, byts: float) -> Tuple[float, str]:
    """The least time of a step at the chip's peaks, and which binds."""
    tf, tb = flops / PEAK_FLOPS, byts / PEAK_BYTES
    return (tf, "flops") if tf >= tb else (tb, "bytes")
