"""Grok-1 314B [hf:xai-org/grok-1] — MoE, 8 experts top-2, GQA kv=8."""
import dataclasses

from repro_torch.core.config import ModelConfig, ParisKVConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=32_768, vocab_size=131_072,
    num_experts=8, experts_per_token=2, moe_d_ff=32_768,
    attn_logit_softcap=30.0, final_logit_softcap=30.0,
    source="hf:xai-org/grok-1",
)

SMOKE = dataclasses.replace(
    CONFIG, name="grok-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
    num_experts=4, experts_per_token=2, moe_d_ff=512,
    pariskv=ParisKVConfig(sink_size=8, local_size=32, update_interval=16,
                          top_k=16, min_candidates=32))
