"""Gemma-3-12B [hf:google/gemma-3-1b-pt family] — 5:1 local:global, 128k ctx.

48 layers, d_model 3840, 16 heads × head_dim 256 (GQA kv=8), d_ff 15360,
vocab 262144; sliding window 1024 on local layers; qk-norm.
"""
import dataclasses

from repro_torch.core.config import ModelConfig, ParisKVConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=15_360, vocab_size=262_144,
    rope_theta=1_000_000.0, sliding_window=1024, local_global_period=6,
    query_pre_attn_scalar=256.0, scale_embed_by_sqrt_d=True,
    source="hf:google/gemma-3-1b-pt",
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma3-smoke", num_layers=6, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512, sliding_window=64,
    query_pre_attn_scalar=64.0,
    pariskv=ParisKVConfig(sink_size=8, local_size=32, update_interval=16,
                          top_k=16, min_candidates=32))
