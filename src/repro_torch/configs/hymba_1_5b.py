"""Hymba-1.5B [arXiv:2411.13676] — parallel attention + mamba heads.

32 layers, d_model 1600, 25 attn heads × 64 (GQA kv=5) in parallel with SSM
heads (state 16). Hymba's learnable meta-tokens are folded into the
attention-sink region (the paper's Sink tokens play the same role —
DESIGN.md §8).
"""
import dataclasses

from repro_torch.core.config import ModelConfig, ParisKVConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32_001,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_groups=1,
    source="arXiv:2411.13676",
)

SMOKE = dataclasses.replace(
    CONFIG, name="hymba-smoke", num_layers=2, d_model=320, num_heads=5,
    num_kv_heads=1, head_dim=64, d_ff=512, vocab_size=512, ssm_state=16,
    pariskv=ParisKVConfig(sink_size=8, local_size=32, update_interval=16,
                          top_k=16, min_candidates=32))
