"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision].

Decoder: 40 layers, d_model 4096, 32H (GQA kv=8), d_ff 14336, vocab 128256;
cross-attention layers every 5th layer read ViT patch embeddings. Per the
assignment carve-out the vision encoder is a STUB — input_specs() provides
precomputed patch embeddings (b, 1600, d_model).
"""
import dataclasses

from repro_torch.core.config import ModelConfig, ParisKVConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab_size=128_256,
    rope_theta=500_000.0, cross_attn_period=5, num_media_tokens=1600,
    tie_embeddings=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama-vision-smoke", num_layers=5, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
    num_media_tokens=64,
    pariskv=ParisKVConfig(sink_size=8, local_size=32, update_interval=16,
                          top_k=16, min_candidates=32))
