"""Architecture configs ported so far (a copy of ``repro.configs``).

Usage: ``repro_torch.configs.get("qwen2-1.5b")`` or ``smoke(...)`` for the
reduced CPU-test variant. Architectures of ``repro.configs.ARCHS`` that the
port does not serve yet raise ``NotImplementedError`` (ROADMAP A13).
"""
from __future__ import annotations

import importlib

ARCHS = ("qwen2-1.5b",)


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
