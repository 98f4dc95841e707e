"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder audio.

Decoder backbone: 32 layers, d_model 1280, 20 heads × 64, d_ff 5120, vocab
51866, cross-attention over 1500 encoder frames. Mel-spectrogram + conv
frontend is a STUB per the carve-out — input_specs() provides frame
embeddings (b, 1500, d). Decode shapes exercise the decoder's self-attn
with ParisKV; the (small, static) cross-attn stays dense.
"""
import dataclasses

from repro_torch.core.config import ModelConfig, ParisKVConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51_866,
    encoder_layers=32, encoder_seq=1500, tie_embeddings=True,
    source="arXiv:2212.04356",
)

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-smoke", num_layers=2, d_model=256, num_heads=4,
    num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512,
    encoder_layers=2, encoder_seq=64,
    pariskv=ParisKVConfig(sink_size=8, local_size=32, update_interval=16,
                          top_k=16, min_candidates=32))
