"""Carry weights across from the JAX package.

torch cannot reproduce ``jax.random``, so parameters shared with the
reference arrive here as numpy arrays:

* ``params_from_jax`` takes the reference's parameter tree (nested dicts
  and lists of numpy arrays, e.g. ``jax.device_get(params)``). The
  reference stacks each stage's layers on a leading axis for ``lax.scan``;
  the port keeps one dict per layer, so the stacks are unstacked in scan
  order. Whisper's encoder, stacked by the reference's ``vmap`` over
  ``encoder_layers``, becomes a list of layer dicts.
* ``load_npz`` reads the reference's ``ckpt/npz.py`` format: tree paths
  joined with ``::``, bfloat16 stored as a uint16 view under a
  ``__bf16__`` suffix.

Every leaf keeps the dtype the reference's tree gives it: the config's,
but for the mixture of experts' router, which the reference holds in
float32 in every config (a bfloat16 cast would round its logits).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.config import ModelConfig
from repro_torch.models.model import layer_plan

_SEP = "::"
_BF16_TAG = "__bf16__"


def _tensor(a, device: torch.device) -> torch.Tensor:
    """numpy (or an npz bfloat16 tensor) → torch on ``device`` in its own
    dtype. A bfloat16 numpy array (the ml_dtypes type JAX hands out)
    travels as its 16-bit pattern."""
    if not isinstance(a, torch.Tensor):
        a = np.array(a, copy=True, order="C")    # torch wants writable
        if a.dtype.name == "bfloat16":
            a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            a = torch.from_numpy(a)
    return a.to(device=device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> dict:
    """The reference's parameter tree (numpy leaves) → the port's params
    on ``device`` (the first CUDA card unless ``device="cpu"``), each leaf
    in the tree's dtype."""
    dev = resolve_device(device)
    out = {k: _tensor(tree[k], dev)
           for k in ("embed", "final_norm", "unembed", "enc_final_norm")
           if k in tree}
    layers = []
    for stage, stacked in zip(layer_plan(cfg), tree["stages"]):
        for r in range(stage.repeat):
            for i in range(len(stage.layers)):
                layers.append(_map(stacked[f"l{i}"],
                                   lambda a: _tensor(a[r], dev)))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.name!r} has {cfg.num_layers}")
    out["layers"] = layers
    if cfg.encoder_layers or "encoder" in tree:
        enc = tree.get("encoder")
        depth = 0 if enc is None else len(enc["norm_attn"])
        if depth != cfg.encoder_layers:
            raise ValueError(f"tree holds {depth} encoder layers, config "
                             f"{cfg.name!r} has {cfg.encoder_layers}")
        out["encoder"] = [_map(enc, lambda a: _tensor(a[r], dev))
                          for r in range(depth)]
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
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


def load_npz(path: str, cfg: ModelConfig, device=None) -> dict:
    """Read a reference ``save_checkpoint`` file into the port's params."""
    flat = {}
    with np.load(path) as data:
        for key in data.files:
            if key == "__step__":
                continue
            arr = data[key]
            if key.endswith(_BF16_TAG):
                key = key[:-len(_BF16_TAG)]
                arr = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            flat[key] = arr
    return params_from_jax(_unflatten(flat), cfg, device)
