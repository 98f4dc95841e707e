"""Carry weights across from the JAX package.

torch cannot reproduce ``jax.random``, so parameters shared with the
reference arrive here as numpy arrays:

* ``params_from_jax`` takes the reference's parameter tree (nested dicts
  and lists of numpy arrays, e.g. ``jax.device_get(params)``). The
  reference stacks each stage's layers on a leading axis for ``lax.scan``;
  the port keeps one dict per layer, so the stacks are unstacked in scan
  order. Whisper's encoder, stacked by the reference's ``vmap`` over
  ``encoder_layers``, becomes a list of layer dicts.
* ``params_to_jax`` is its inverse: the port's params → the reference's
  stacked tree of numpy leaves.
* ``load_npz`` reads a checkpoint in the reference's format
  (``ckpt.npz``, which owns the format).

Every leaf keeps the dtype the reference's tree gives it: the config's,
but for the mixture of experts' router, which the reference holds in
float32 in every config (a bfloat16 cast would round its logits).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device, tree_map
from repro_torch.core.config import ModelConfig
from repro_torch.models.model import layer_places, layer_plan


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


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> dict:
    """The reference's parameter tree (numpy leaves) → the port's params
    on ``device`` (the first CUDA card unless ``device="cpu"``), each leaf
    in the tree's dtype."""
    dev = resolve_device(device)
    out = {k: _tensor(tree[k], dev)
           for k in ("embed", "final_norm", "unembed", "enc_final_norm")
           if k in tree}
    layers = [tree_map(lambda a: _tensor(a[r], dev),
                       tree["stages"][si][f"l{i}"])
              for si, r, i in layer_places(cfg)
              if si < len(tree["stages"])]
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
        out["encoder"] = [tree_map(lambda a: _tensor(a[r], dev), enc)
                          for r in range(depth)]
    return out


def stack_params(params: dict, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's params → the reference's tree of tensors on the CPU:
    each stage's layers stacked per period position (``stages`` [{"l0":
    ..., ...}], ``repeat`` on the leading axis) and whisper's encoder
    layers stacked, every leaf in its own dtype."""
    def stack(layers):
        return tree_map(lambda *ts: torch.stack(
            [t.detach().cpu() for t in ts]), *layers)
    out = {k: params[k].detach().cpu()
           for k in ("embed", "final_norm", "unembed", "enc_final_norm")
           if k in params}
    places = layer_places(cfg)
    if len(places) != len(params["layers"]):
        raise ValueError(f"params hold {len(params['layers'])} layers, "
                         f"config {cfg.name!r} has {len(places)}")
    out["stages"] = [
        {f"l{i}": stack([p for (s, _, j), p in zip(places, params["layers"])
                         if (s, j) == (si, i)])
         for i in range(len(stage.layers))}
        for si, stage in enumerate(layer_plan(cfg))]
    if "encoder" in params:
        out["encoder"] = stack(params["encoder"])
    return out


def params_to_jax(params: dict, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's params → the reference's parameter tree with numpy
    leaves, stacked as ``stack_params`` stacks them. numpy has no
    bfloat16: a bfloat16 leaf comes back as float32 holding the same
    values (``ckpt.save_checkpoint`` stores its 16-bit pattern)."""
    return tree_map(lambda t: (t.float() if t.dtype == torch.bfloat16
                               else t).numpy(), stack_params(params, cfg))


def load_npz(path: str, cfg: ModelConfig, device=None) -> dict:
    """Read a reference ``save_checkpoint`` file into the port's params."""
    from repro_torch.ckpt.npz import load_checkpoint   # ckpt imports this
    return load_checkpoint(path, cfg, device)
