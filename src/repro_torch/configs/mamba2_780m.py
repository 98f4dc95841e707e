"""Mamba-2-780M [arXiv:2405.21060] — attention-free SSD.

ParisKV is inapplicable (no KV cache; DESIGN.md §4) — the arch is
implemented without the technique and runs long_500k natively via its
O(1) recurrent state.
"""
import dataclasses

from repro_torch.core.config import ModelConfig, ParisKVConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50_280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_groups=1,
    source="arXiv:2405.21060",
)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-smoke", num_layers=2, d_model=256, vocab_size=512,
    ssm_state=32,
    pariskv=ParisKVConfig(sink_size=8, local_size=32, update_interval=16,
                          top_k=16, min_candidates=32))
