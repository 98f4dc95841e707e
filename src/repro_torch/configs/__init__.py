"""Architecture configs ported so far (copies of ``repro.configs``): the
plain dense qwen2-1.5b, stablelm-1.6b and the paper's own evaluation
models llama3.1-8b and qwen3-8b, grok-1's mixture of experts, the
local/global dense gemma2-27b and gemma3-12b, and the cross-attention
families: whisper-large-v3's encoder-decoder and llama-3.2-vision-11b's
gated cross layers, and the state-space families: mamba2-780m's
attention-free SSD layers and hymba-1.5b's hybrid layers (ParisKV
attention and an SSD mixer side by side), and deepseek-v2-lite-16b's
multi-head latent attention (MLA: ParisKV over one latent that all query
heads share) with a mixture of experts: all twelve of
``repro.configs.ARCHS``.

Usage: ``repro_torch.configs.get("qwen2-1.5b")`` or ``smoke(...)`` for the
reduced CPU-test variant. An unknown name raises ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

ARCHS = ("qwen2-1.5b", "stablelm-1.6b", "llama3.1-8b", "qwen3-8b",
         "grok-1-314b", "gemma2-27b", "gemma3-12b", "whisper-large-v3",
         "llama-3.2-vision-11b", "mamba2-780m", "hymba-1.5b",
         "deepseek-v2-lite-16b")


def _module(name: str):
    if name not in ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not one of the reference's "
            f"(ROADMAP A13 ported all of them); ported: {ARCHS}")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get(name: str):
    return _module(name).CONFIG


def smoke(name: str):
    """Reduced variant of the same family for CPU smoke tests."""
    return _module(name).SMOKE
