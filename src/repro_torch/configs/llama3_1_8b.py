"""Llama-3.1-8B — the paper's own efficiency-eval model (§5.2)."""
import dataclasses

from repro_torch.core.config import ModelConfig, ParisKVConfig

CONFIG = ModelConfig(
    name="llama3.1-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab_size=128_256,
    rope_theta=500_000.0, tie_embeddings=False,
    source="paper §5.2 / hf:meta-llama/Llama-3.1-8B",
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama31-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
    pariskv=ParisKVConfig(sink_size=8, local_size=32, update_interval=16,
                          top_k=16, min_candidates=32))
