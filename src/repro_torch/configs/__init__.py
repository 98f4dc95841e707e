"""Architecture configs ported so far (copies of ``repro.configs``): the
plain dense qwen2-1.5b, stablelm-1.6b and the paper's own evaluation
models llama3.1-8b and qwen3-8b, grok-1's mixture of experts, the
local/global dense gemma2-27b and gemma3-12b, and the cross-attention
families: whisper-large-v3's encoder-decoder and llama-3.2-vision-11b's
gated cross layers, and the state-space families: mamba2-780m's
attention-free SSD layers and hymba-1.5b's hybrid layers (ParisKV
attention and an SSD mixer side by side).

Usage: ``repro_torch.configs.get("qwen2-1.5b")`` or ``smoke(...)`` for the
reduced CPU-test variant. Architectures of ``repro.configs.ARCHS`` that the
port does not serve yet raise ``NotImplementedError`` (ROADMAP A13).
"""
from __future__ import annotations

import importlib

ARCHS = ("qwen2-1.5b", "stablelm-1.6b", "llama3.1-8b", "qwen3-8b",
         "grok-1-314b", "gemma2-27b", "gemma3-12b", "whisper-large-v3",
         "llama-3.2-vision-11b", "mamba2-780m", "hymba-1.5b")


def _module(name: str):
    if name not in ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ROADMAP A13); "
            f"ported: {ARCHS}")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get(name: str):
    return _module(name).CONFIG


def smoke(name: str):
    """Reduced variant of the same family for CPU smoke tests."""
    return _module(name).SMOKE
