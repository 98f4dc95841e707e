"""npz checkpoints in the reference's format (``repro/ckpt/npz.py``), so
either side reads what the other writes: one array per leaf of the
reference's parameter tree (each stage's layers stacked), keyed by its
tree path joined with ``::``; bfloat16 as its uint16 pattern under a
``__bf16__`` suffix (npz has no bfloat16); the step under ``__step__``.
A save writes a temporary file beside the target and renames it over.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models.convert import params_from_jax, stack_params

_SEP = "::"
_BF16_TAG = "__bf16__"
_STEP = "__step__"


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Tree paths as the reference's ``tree_flatten_with_path`` names
    them: dict keys and list indices joined with ``::``."""
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``a::0::b`` keys → nested dicts, with integer parts as list
    indices (``stages`` is a list in the reference's tree)."""
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split(_SEP)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def save_checkpoint(path: str, params: dict, cfg: ModelConfig,
                    step: Optional[int] = None) -> None:
    """Write the port's ``params`` as the reference's ``save_checkpoint``
    writes its tree (``repro.ckpt.load_checkpoint`` reads it back)."""
    arrays = {}
    for key, t in _flatten(stack_params(params, cfg)).items():
        if t.dtype == torch.bfloat16:
            arrays[key + _BF16_TAG] = t.view(torch.int16).numpy().view(
                np.uint16)
        else:
            arrays[key] = t.numpy()
    if step is not None:
        arrays[_STEP] = np.asarray(step)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_checkpoint(path: str, cfg: ModelConfig, device=None) -> dict:
    """Read a checkpoint in the reference's format (the reference's or
    the port's) into the port's params on ``device`` (the first CUDA
    card unless ``device="cpu"``), each leaf in its stored dtype."""
    flat = {}
    with np.load(path) as data:
        for key in data.files:
            if key == _STEP:
                continue
            arr = data[key]
            if key.endswith(_BF16_TAG):
                key = key[:-len(_BF16_TAG)]
                arr = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            flat[key] = arr
    return params_from_jax(_unflatten(flat), cfg, device)
