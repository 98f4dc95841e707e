"""Gemma-2-27B [arXiv:2408.00118] — local/global alternating, logit softcaps.

Real model: 46 layers, d_model 4608, 32 heads × head_dim 128 (GQA kv=16),
d_ff 36864, sliding window 4096 on local layers, attn softcap 50, final
logit softcap 30, query_pre_attn_scalar = d_model/num_heads = 144.
"""
import dataclasses

from repro_torch.core.config import ModelConfig, ParisKVConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=36_864, vocab_size=256_000,
    rope_theta=10_000.0, attn_logit_softcap=50.0, final_logit_softcap=30.0,
    sliding_window=4096, local_global_period=2,
    query_pre_attn_scalar=144.0, scale_embed_by_sqrt_d=True,
    source="arXiv:2408.00118",
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma2-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512, sliding_window=64,
    query_pre_attn_scalar=64.0,
    pariskv=ParisKVConfig(sink_size=8, local_size=32, update_interval=16,
                          top_k=16, min_candidates=32))
