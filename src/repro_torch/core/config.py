"""Configuration dataclasses for the ParisKV framework.

Two layers of config:

* :class:`ParisKVConfig` — hyper-parameters of the paper's retrieval technique
  (subspace geometry, collision/candidate ratios, cache-region sizes).
* :class:`ModelConfig` — architecture definition for the model substrate.
  One instance per ported architecture lives in ``repro_torch.configs``.

Everything is a frozen dataclass so configs hash and can be closed over by
dict keys or cache keys.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@dataclass(frozen=True)
class ParisKVConfig:
    """Hyper-parameters of the ParisKV retrieval pipeline (paper §4, App. B)."""

    # --- subspace geometry -------------------------------------------------
    m: int = 8                 # subspace dimension (2^m analytic centroids)
    magnitude_bits: int = 3    # 3-bit magnitude + 1 sign bit = 4-bit code

    # --- Stage I: collision-based coarse candidate generation --------------
    rho: float = 0.25          # collision ratio: top-rho fraction per subspace scores
    beta: float = 0.08         # candidate ratio: top-beta fraction survive Stage I
    tier_weights: Tuple[int, ...] = (6, 5, 4, 3, 2, 1)
    tier_pcts: Tuple[float, ...] = (0.05, 0.15, 0.30, 0.50, 0.75, 1.00)

    # --- Stage II: RSQ-IP rerank & final selection --------------------------
    top_k: int = 100           # final retrieval budget (paper: fixed Top-100)
    min_candidates: int = 128  # static lower bound on candidate-set size C
    max_candidates: int = 4096  # static upper bound on C (keeps rerank bounded)

    # --- cache regions (paper Fig. 5 / Table 1) -----------------------------
    sink_size: int = 128
    local_size: int = 512
    update_interval: int = 256  # sliding-window metadata refresh period

    # --- rotation ------------------------------------------------------------
    srht_seed: int = 0x9A1915

    # --- beyond-paper perf knobs (EXPERIMENTS.md §Perf) -----------------------
    # 0 = exact bucket histogram (paper-faithful); >0 = estimate tier
    # percentile boundaries from a strided subsample of ~this many keys.
    hist_sample: int = 0

    def num_centroids(self) -> int:
        return 1 << self.m

    def num_levels(self) -> int:
        return 1 << self.magnitude_bits

    def padded_dim(self, d: int) -> int:
        """SRHT requires a power-of-two dim; we zero-pad (IP-preserving)."""
        p = _next_pow2(max(d, self.m))
        # must also be divisible by m (power of two m guarantees it)
        assert p % self.m == 0
        return p

    def num_subspaces(self, d: int) -> int:
        return self.padded_dim(d) // self.m

    def candidate_count(self, n: int) -> int:
        """Static candidate-set size C for a retrieval region of length n."""
        c = int(math.ceil(self.beta * n))
        c = max(self.min_candidates, min(self.max_candidates, c))
        c = max(c, self.top_k)
        return min(c, n)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture definition. Field groups are optional per family."""

    name: str
    family: str                # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    source: str = ""           # citation for the config

    # --- attention variants --------------------------------------------------
    rope_theta: float = 10_000.0
    qkv_bias: bool = False                 # qwen2
    attn_logit_softcap: float = 0.0        # gemma2 (0 = disabled)
    final_logit_softcap: float = 0.0       # gemma2
    sliding_window: int = 0                # gemma2/gemma3 local layers (0 = none)
    local_global_period: int = 0           # e.g. gemma3: 6 -> 5 local + 1 global
    query_pre_attn_scalar: float = 0.0     # gemma: custom attention scale

    # --- MoE -------------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0            # deepseek-v2: layer 0 is dense
    router_aux_loss_coef: float = 0.001

    # --- MLA (deepseek-v2) -------------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2 / hymba) ----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_groups: int = 1

    # --- multimodal ---------------------------------------------------------------
    cross_attn_period: int = 0             # llama-3.2-vision: cross-attn every N layers
    num_media_tokens: int = 0              # image patch / audio frame embedding count
    encoder_layers: int = 0                # whisper encoder depth
    encoder_seq: int = 0                   # whisper: 1500 frames

    # --- misc ------------------------------------------------------------------------
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    scale_embed_by_sqrt_d: bool = False    # gemma family
    first_dense_d_ff: int = 0              # deepseek-v2: layer-0 dense FFN width

    # ParisKV integration
    pariskv: ParisKVConfig = dataclasses.field(default_factory=ParisKVConfig)

    # ------------------------------------------------------------------
    def retrieval_dim(self) -> int:
        """Dimension of the vectors ParisKV indexes for this arch.

        MLA archs retrieve in the shared latent space (kv_lora + rope head);
        everything else retrieves per-kv-head keys of head_dim.
        """
        if self.kv_lora_rank:
            return self.kv_lora_rank + self.rope_head_dim
        return self.head_dim

    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def num_params(self) -> int:
        """Approximate parameter count (embedding + blocks), for rooflines."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, g, hd = self.num_heads, self.num_kv_heads, self.head_dim
        per_layer = 0
        if self.kv_lora_rank:  # MLA
            qd = self.q_lora_rank or d
            per_layer += d * qd + qd * h * (self.head_dim + self.rope_head_dim)
            per_layer += d * (self.kv_lora_rank + self.rope_head_dim)
            per_layer += self.kv_lora_rank * h * (self.head_dim + self.v_head_dim)
            per_layer += h * self.v_head_dim * d
        elif self.family != "ssm":
            per_layer += d * (h + 2 * g) * hd + h * hd * d
        if self.family in ("ssm", "hybrid"):
            di = self.ssm_expand * d
            per_layer += d * (2 * di + 2 * self.ssm_groups * self.ssm_state) + di * d
        if self.num_experts:
            fe = self.moe_d_ff or f
            per_layer_moe = self.num_experts * 3 * d * fe
            per_layer_moe += self.num_shared_experts * 3 * d * fe
            per_layer_moe += d * self.num_experts
            dense_layers = self.first_dense_layers
            moe_layers = self.num_layers - dense_layers
            total_ffn = moe_layers * per_layer_moe + dense_layers * 3 * d * f
        else:
            total_ffn = self.num_layers * (3 * d * f if f else 0)
        total = self.num_layers * per_layer + total_ffn + v * d
        if not self.tie_embeddings:
            total += v * d
        if self.cross_attn_period:
            n_cross = self.num_layers // self.cross_attn_period
            total += n_cross * (d * (h + 2 * g) * hd + h * hd * d + 3 * d * f)
        if self.encoder_layers:
            total += self.encoder_layers * (4 * d * d + 3 * d * f)
        return total

    def active_params_per_token(self) -> int:
        """Active parameters per token (MoE-aware) — used for MODEL_FLOPS."""
        if not self.num_experts:
            return self.num_params()
        d = self.d_model
        fe = self.moe_d_ff or self.d_ff
        h, g, hd = self.num_heads, self.num_kv_heads, self.head_dim
        per_layer = d * (h + 2 * g) * hd + h * hd * d
        if self.kv_lora_rank:
            per_layer = 0
            qd = self.q_lora_rank or d
            per_layer += d * qd + qd * h * (self.head_dim + self.rope_head_dim)
            per_layer += d * (self.kv_lora_rank + self.rope_head_dim)
            per_layer += self.kv_lora_rank * h * (self.head_dim + self.v_head_dim)
            per_layer += h * self.v_head_dim * d
        active_ffn = (self.experts_per_token + self.num_shared_experts) * 3 * d * fe
        dense = self.first_dense_layers
        total = (self.num_layers * per_layer
                 + (self.num_layers - dense) * active_ffn
                 + dense * 3 * d * self.d_ff
                 + self.vocab_size * d)
        return total


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
