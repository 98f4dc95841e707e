"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b]."""
import dataclasses

from repro_torch.core.config import ModelConfig, ParisKVConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100_352,
    rope_theta=10_000.0, tie_embeddings=False,
    source="hf:stabilityai/stablelm-2-1_6b",
)

SMOKE = dataclasses.replace(
    CONFIG, name="stablelm-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512,
    pariskv=ParisKVConfig(sink_size=8, local_size=32, update_interval=16,
                          top_k=16, min_candidates=32))
