"""Model assembly for the dense family (port of the main-path part of
``repro/models/model.py``): layer plan, parameter init, embed / unembed.

The reference stacks each stage's layers on a leading axis for
``lax.scan``; the port keeps one parameter dict per layer in
``params["layers"]``, in the order the scan visits them (stage by stage,
repeat by repeat, layer by layer within a period).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnSpec


@dataclasses.dataclass(frozen=True)
class LayerDef:
    mixer: str                 # 'attn' (the only mixer ported so far)
    attn: Optional[AttnSpec] = None
    ffn: str = "mlp"
    d_ff: int = 0
    use_pariskv: bool = True


@dataclasses.dataclass(frozen=True)
class StageDef:
    layers: Tuple[LayerDef, ...]
    repeat: int


def _attn_spec(cfg: ModelConfig) -> AttnSpec:
    scale = 0.0
    if cfg.query_pre_attn_scalar:
        scale = cfg.query_pre_attn_scalar ** -0.5
    return AttnSpec(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                    head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                    qkv_bias=cfg.qkv_bias, softcap=cfg.attn_logit_softcap,
                    sm_scale=scale)


def layer_plan(cfg: ModelConfig) -> Tuple[StageDef, ...]:
    """The stage/period structure of a dense model: one stage of
    ``num_layers`` global-attention layers. Other families and
    local/global patterns are not ported yet (ROADMAP A13)."""
    if cfg.family != "dense" or cfg.local_global_period:
        raise NotImplementedError(
            f"config {cfg.name!r}: only the plain dense family is ported "
            f"(ROADMAP A13)")
    ld = LayerDef("attn", _attn_spec(cfg), ffn="mlp", d_ff=cfg.d_ff)
    return (StageDef((ld,), cfg.num_layers),)


def layer_defs(cfg: ModelConfig) -> List[LayerDef]:
    """The plan flattened in scan order: one LayerDef per model layer."""
    return [ld for stage in layer_plan(cfg) for _ in range(stage.repeat)
            for ld in stage.layers]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def init_layer(cfg: ModelConfig, ld: LayerDef, device,
               gen: torch.Generator) -> dict:
    dt = torch_dtype(cfg)
    return {
        "norm_attn": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "attn": L.init_attn(cfg.d_model, ld.attn, dt, device, gen),
        "norm_mlp": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "mlp": L.init_mlp(cfg.d_model, ld.d_ff, dt, device, gen),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from ``seed``, made directly on ``device`` (the
    first CUDA card unless ``device="cpu"``). torch cannot reproduce
    ``jax.random``: weights shared with the reference come through
    ``models.convert``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch_dtype(cfg)
    params: Dict[str, Any] = {
        "embed": L.truncated_normal_(
            torch.empty((cfg.vocab_size, cfg.d_model), device=dev),
            gen).to(dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.truncated_normal_(
            torch.empty((cfg.d_model, cfg.vocab_size), device=dev),
            gen).to(dt)
    params["layers"] = [init_layer(cfg, ld, dev, gen)
                        for ld in layer_defs(cfg)]
    return params


def param_device(params: dict) -> torch.device:
    return params["embed"].device


def param_count(params: dict) -> int:
    def count(tree):
        if isinstance(tree, torch.Tensor):
            return tree.numel()
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return sum(count(v) for v in tree)
    return count(params)


def _embed(params: dict, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.scale_embed_by_sqrt_d:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _unembed(params: dict, cfg: ModelConfig,
             x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = x @ w
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(
            logits / cfg.final_logit_softcap)
    return logits
