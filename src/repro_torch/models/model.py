"""Model assembly for the dense family (plain, or gemma's local/global
pattern), grok-1's mixture of experts, the cross-attention families
(whisper's encoder-decoder, llama-3.2-vision's cross layers), the
state-space families (mamba2's SSD layers, hymba's hybrid layers) and
deepseek-v2's latent attention with its mixture of experts (port
of ``repro/models/model.py`` but its prefill and decode, which are
``models.serve``'s): layer plan, parameter init, whisper's encoder, embed
/ unembed, and the training forward.

The reference stacks each stage's layers on a leading axis for
``lax.scan``; the port keeps one parameter dict per layer in
``params["layers"]``, in the order the scan visits them (stage by stage,
repeat by repeat, layer by layer within a period), and whisper's encoder
layers as a list in ``params["encoder"]``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.core.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import AttnSpec


@dataclasses.dataclass(frozen=True)
class LayerDef:
    mixer: str                 # 'attn' | 'cross' | 'ssm' | 'hybrid' | 'mla'
    attn: Optional[AttnSpec] = None
    ffn: str = "mlp"           # 'mlp' | 'moe' | 'none'
    d_ff: int = 0
    cross: bool = False        # extra cross-attn sublayer (whisper decoder)
    use_pariskv: bool = True   # retrieval at decode (False: ring buffer, or
    #                            a cross layer's static media K/V)


@dataclasses.dataclass(frozen=True)
class StageDef:
    layers: Tuple[LayerDef, ...]
    repeat: int


def _attn_spec(cfg: ModelConfig, sliding: int = 0, causal: bool = True,
               qk_norm: bool = False) -> AttnSpec:
    scale = 0.0
    if cfg.query_pre_attn_scalar:
        scale = cfg.query_pre_attn_scalar ** -0.5
    return AttnSpec(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                    head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                    qkv_bias=cfg.qkv_bias, softcap=cfg.attn_logit_softcap,
                    sliding_window=sliding, qk_norm=qk_norm, sm_scale=scale,
                    causal=causal)




def layer_plan(cfg: ModelConfig) -> Tuple[StageDef, ...]:
    """The stage/period structure: one stage of ``num_layers``
    global-attention layers, with an MLP (the plain dense family) or a
    mixture of experts of width ``moe_d_ff`` (grok-1); with
    ``local_global_period`` p (gemma) a period of p - 1 sliding-window
    local layers and one global layer, repeated ``num_layers // p`` times,
    with qk-norm on gemma3; llama-3.2-vision (``vlm``) a period of
    ``cross_attn_period`` - 1 ParisKV layers and one cross layer (queries
    from the hidden state, keys and values from the media, gated by
    tanh(cross_gate)); whisper's decoder (``audio``) ParisKV layers each
    with a cross sublayer over the encoder's output; mamba2 (``ssm``) SSD
    layers with no FFN; hymba (``hybrid``) layers whose mixer is half
    ParisKV attention and half SSD, with an MLP; deepseek-v2 (``moe`` with
    ``kv_lora_rank``) a stage of ``first_dense_layers`` MLA layers with a
    dense MLP of ``first_dense_d_ff``, then a stage of MLA layers with a
    mixture of experts of width ``moe_d_ff`` (``models.mla``)."""
    if cfg.family == "ssm":
        return (StageDef((LayerDef("ssm", ffn="none"),), cfg.num_layers),)
    if cfg.family == "hybrid":
        ld = LayerDef("hybrid", _attn_spec(cfg), ffn="mlp", d_ff=cfg.d_ff)
        return (StageDef((ld,), cfg.num_layers),)
    if cfg.family == "moe" and cfg.kv_lora_rank:   # deepseek-v2
        dense = LayerDef("mla", None, ffn="mlp",
                         d_ff=cfg.first_dense_d_ff or cfg.d_ff)
        moe_l = LayerDef("mla", None, ffn="moe",
                         d_ff=cfg.moe_d_ff or cfg.d_ff)
        stages = []
        if cfg.first_dense_layers:
            stages.append(StageDef((dense,), cfg.first_dense_layers))
        stages.append(StageDef((moe_l,),
                               cfg.num_layers - cfg.first_dense_layers))
        return tuple(stages)
    if cfg.family == "moe":                     # grok-1
        ld = LayerDef("attn", _attn_spec(cfg), ffn="moe",
                      d_ff=cfg.moe_d_ff or cfg.d_ff)
        return (StageDef((ld,), cfg.num_layers),)
    if cfg.family == "vlm":                     # llama-3.2-vision
        period = cfg.cross_attn_period
        self_l = LayerDef("attn", _attn_spec(cfg), ffn="mlp", d_ff=cfg.d_ff)
        cross_l = LayerDef("cross", _attn_spec(cfg, causal=False), ffn="mlp",
                           d_ff=cfg.d_ff, use_pariskv=False)
        return (StageDef((self_l,) * (period - 1) + (cross_l,),
                         cfg.num_layers // period),)
    if cfg.family == "audio":                   # whisper decoder (+cross)
        ld = LayerDef("attn", _attn_spec(cfg), ffn="mlp", d_ff=cfg.d_ff,
                      cross=True)
        return (StageDef((ld,), cfg.num_layers),)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"config {cfg.name!r}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP A13)")
    if cfg.local_global_period:
        p = cfg.local_global_period
        qk = cfg.name.startswith("gemma3")
        local = LayerDef("attn", _attn_spec(cfg, sliding=cfg.sliding_window,
                                            qk_norm=qk),
                         ffn="mlp", d_ff=cfg.d_ff, use_pariskv=False)
        glob = LayerDef("attn", _attn_spec(cfg, qk_norm=qk), ffn="mlp",
                        d_ff=cfg.d_ff)
        return (StageDef((local,) * (p - 1) + (glob,), cfg.num_layers // p),)
    ld = LayerDef("attn", _attn_spec(cfg), ffn="mlp", d_ff=cfg.d_ff)
    return (StageDef((ld,), cfg.num_layers),)


def layer_defs(cfg: ModelConfig) -> List[LayerDef]:
    """The plan flattened in scan order: one LayerDef per model layer."""
    return [ld for stage in layer_plan(cfg) for _ in range(stage.repeat)
            for ld in stage.layers]


def layer_places(cfg: ModelConfig) -> List[Tuple[int, int, int]]:
    """Each layer, in ``params["layers"]`` order, as its place in the
    reference's stacked tree: (stage ``si``, index ``r`` on the stack's
    leading axis, position ``i`` within the stage's period), i.e. leaf
    ``stages/<si>/l<i>/...[r]``. The one map between the two trees:
    conversions both ways (``models.convert``), the cache entries' names
    (``models.serve.entry_names``) and the sharding rules
    (``launch.mesh``) go through it."""
    return [(si, r, i) for si, stage in enumerate(layer_plan(cfg))
            for r in range(stage.repeat) for i in range(len(stage.layers))]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def init_layer(cfg: ModelConfig, ld: LayerDef, device,
               gen: Optional[torch.Generator]) -> dict:
    """One layer's parameters: a cross layer adds the 0-d ``cross_gate``,
    zero as in the reference (tanh(0) = 0: the layer adds nothing until
    the gate is trained or set), a ``cross=True`` layer its cross
    sublayer's ``cross`` attention and ``norm_cross``, an ``ssm`` or
    ``hybrid`` layer its SSD mixer ``ssm``; an ``ssm`` layer has no
    attention, and no ``norm_mlp`` (``ffn="none"``); an ``mla`` layer's
    ``attn`` holds the latent projections (``models.mla.init_mla``)."""
    dt = torch_dtype(cfg)

    def ones():
        return torch.ones((cfg.d_model,), dtype=dt, device=device)
    p = {"norm_attn": ones()}
    if ld.mixer == "mla":
        p["attn"] = MLA.init_mla(cfg, dt, device, gen)
    elif ld.mixer != "ssm":
        p["attn"] = L.init_attn(cfg.d_model, ld.attn, dt, device, gen)
    if ld.mixer in ("ssm", "hybrid"):
        p["ssm"] = SSM.init_ssm(cfg, dt, device, gen)
    if ld.mixer == "cross":
        p["cross_gate"] = torch.zeros((), dtype=dt, device=device)
    if ld.cross:
        p["cross"] = L.init_attn(cfg.d_model, ld.attn, dt, device, gen)
        p["norm_cross"] = ones()
    if ld.ffn != "none":
        p["norm_mlp"] = ones()
    if ld.ffn == "moe":
        p["moe"] = MOE.init_moe(cfg.d_model, ld.d_ff, cfg.num_experts,
                                cfg.num_shared_experts, dt, device, gen)
    elif ld.ffn == "mlp":
        p["mlp"] = L.init_mlp(cfg.d_model, ld.d_ff, dt, device, gen)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from ``seed``, made directly on ``device`` (the
    first CUDA card unless ``device="cpu"``). torch cannot reproduce
    ``jax.random``: weights shared with the reference come through
    ``models.convert``. On ``device="meta"`` every leaf has its shape and
    dtype and no storage, and nothing is drawn (``launch.dryrun`` plans
    from them)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
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
    if cfg.encoder_layers:                      # whisper's encoder
        spec = _attn_spec(cfg, causal=False)
        params["encoder"] = [
            {"norm_attn": torch.ones((cfg.d_model,), dtype=dt, device=dev),
             "attn": L.init_attn(cfg.d_model, spec, dt, dev, gen),
             "norm_mlp": torch.ones((cfg.d_model,), dtype=dt, device=dev),
             "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, dt, dev, gen)}
            for _ in range(cfg.encoder_layers)]
        params["enc_final_norm"] = torch.ones((cfg.d_model,), dtype=dt,
                                              device=dev)
    return params


def _float(tree):
    """A parameter dict with every tensor in float32."""
    if isinstance(tree, dict):
        return {k: _float(v) for k, v in tree.items()}
    return tree.float()


def encoder_fwd(params: dict, cfg: ModelConfig,
                feats: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings ``feats`` (b, T, d):
    sinusoidal positions added, then per layer rms-norm, bidirectional
    attention with no rope, rms-norm and the MLP, then ``enc_final_norm``
    → (b, T, d) float32.

    The frames are float32, and in the reference every product of a
    float32 activation with a config-dtype weight promotes to float32, so
    the whole encoder runs in float32. torch refuses a mixed-dtype
    product: each layer's weights are cast up to float32 (one layer's
    copy at a time; a no-op in a float32 config)."""
    pos = torch.from_numpy(L.sinusoidal_positions(feats.shape[1],
                                                  cfg.d_model))
    x = feats.float() + pos.to(feats.device)[None]
    spec = _attn_spec(cfg, causal=False)
    for p in params["encoder"]:
        p = _float(p)
        h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
        x = x + L.attn_encoder(p["attn"], h, spec)
        h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        x = x + L.mlp_fwd(p["mlp"], h)
    return L.rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


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


def _gate(p: dict) -> torch.Tensor:
    """A cross layer's output scale tanh(cross_gate), taken in the gate's
    dtype as the reference takes it, then float32 (it scales a float32
    output)."""
    return torch.tanh(p["cross_gate"]).float()


def layer_fwd_train(p: dict, x: torch.Tensor, ld: LayerDef, cfg: ModelConfig,
                    positions: torch.Tensor, media: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer over a full sequence x (b, s, d) → (x, aux loss float32):
    the mixer (attention, MLA, a cross layer gated by tanh(cross_gate),
    the SSD mixer, or hybrid's 0.5 · (attention + SSD)), the cross
    sublayer of whisper's decoder, then the MLP or the mixture of experts.
    Each sublayer's output joins the residual in x's dtype, as the
    reference's ``x + y.astype(x.dtype)``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
    if ld.mixer == "attn":
        y = L.attn_train(p["attn"], h, ld.attn, positions)
    elif ld.mixer == "mla":
        y = MLA.mla_train(p["attn"], h, cfg, positions)
    elif ld.mixer == "cross":
        y = _gate(p) * L.attn_cross(p["attn"], h, media, ld.attn)
    elif ld.mixer == "ssm":
        y = SSM.ssm_train(p["ssm"], h, cfg)
    elif ld.mixer == "hybrid":
        y = 0.5 * (L.attn_train(p["attn"], h, ld.attn, positions)
                   + SSM.ssm_train(p["ssm"], h, cfg))
    else:
        raise ValueError(ld.mixer)
    x = x + y.to(x.dtype)
    if ld.cross:
        h = L.rms_norm(x, p["norm_cross"], cfg.norm_eps)
        x = x + L.attn_cross(p["cross"], h, media, ld.attn).to(x.dtype)
    if ld.ffn != "none":
        h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        if ld.ffn == "moe":
            y, aux = MOE.moe_fwd(p["moe"], h, cfg.experts_per_token)
        else:
            y = L.mlp_fwd(p["mlp"], h)
        x = x + y.to(x.dtype)
    return x, aux


def forward_train(params: dict, cfg: ModelConfig, tokens,
                  media: Optional[torch.Tensor] = None,
                  remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (b, s) → (logits (b, s, vocab) in the config's dtype, the
    summed aux loss float32), on the parameters' device. ``media`` (b, T,
    d) float32 carries the stub patch or frame embeddings of the vlm and
    audio families (whisper's go through ``encoder_fwd`` first).

    ``remat`` recomputes each layer's activations in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``):
    between the passes only each layer's input is kept."""
    dev = param_device(params)
    tokens = torch.as_tensor(tokens, device=dev)
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(s, device=dev).expand(b, s)
    if media is not None:
        media = torch.as_tensor(media, dtype=torch.float32, device=dev)
        if cfg.family == "audio":
            media = encoder_fwd(params, cfg, media)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    for ld, p in zip(layer_defs(cfg), params["layers"]):
        fwd = functools.partial(layer_fwd_train, ld=ld, cfg=cfg,
                                positions=positions, media=media)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                fwd, p, x, use_reentrant=False)
        else:
            x, aux = fwd(p, x)
        aux_total = aux_total + aux
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), aux_total
