"""Qwen2-1.5B [arXiv:2407.10671] — GQA kv=2, QKV bias."""
import dataclasses

from repro_torch.core.config import ModelConfig, ParisKVConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151_936,
    rope_theta=1_000_000.0, qkv_bias=True, tie_embeddings=True,
    source="arXiv:2407.10671",
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
    pariskv=ParisKVConfig(sink_size=8, local_size=32, update_interval=16,
                          top_k=16, min_candidates=32))
