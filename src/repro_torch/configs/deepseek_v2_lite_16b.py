"""DeepSeek-V2-Lite 16B [arXiv:2405.04434] — MLA + MoE.

MLA: kv_lora_rank 512, qk_nope 128, decoupled rope head 64, v_head 128.
MoE: 64 routed experts top-6 + 2 shared, moe_d_ff 1408; layer 0 is a dense
FFN (d_ff 10944). ParisKV retrieves in the shared 576-d latent space
(DESIGN.md §4 — beyond-paper adaptation).
"""
import dataclasses

from repro_torch.core.config import ModelConfig, ParisKVConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102_400,
    num_experts=64, experts_per_token=6, num_shared_experts=2,
    moe_d_ff=1408, first_dense_layers=1, first_dense_d_ff=10_944,
    kv_lora_rank=512, rope_head_dim=64, v_head_dim=128,
    source="arXiv:2405.04434",
)

SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-smoke", num_layers=3, d_model=256, num_heads=4,
    num_kv_heads=4, head_dim=32, d_ff=512, vocab_size=512,
    num_experts=4, experts_per_token=2, num_shared_experts=1, moe_d_ff=128,
    first_dense_layers=1, first_dense_d_ff=512,
    kv_lora_rank=64, rope_head_dim=32, v_head_dim=32,
    pariskv=ParisKVConfig(sink_size=8, local_size=32, update_interval=16,
                          top_k=16, min_candidates=32))
