"""Mamba-2 SSD (state-space duality) mixer (port of the serving part of
``repro/models/ssm.py``, arXiv:2405.21060).

Prefill runs the chunked SSD algorithm: a quadratic "attention-like" term
inside each chunk and a linear recurrence over the chunks' final states.
Decode is the O(1)-per-step recurrence

    h_t = exp(dt·A) h_{t-1} + dt · B_t ⊗ x_t ,   y_t = C_t · h_t + D x_t.

The reference computes all of it in jnp, not in a Pallas kernel, so the
port is plain torch. Its casts follow the reference's step by step: the
input projection, the prefill's causal convolution and the output path
in the config's dtype; the decode convolution, dt, the recurrence and its
state in float32; the conv tail (the last k - 1 pre-convolution inputs)
in the config's dtype. The decode step's per-head contractions are
products and sums: a batched matmul rounds by batch count on the card,
and the mixer runs whole and replicated on every rank of a head-sharded
group, so one rank's bits must equal one device's.

ParisKV does not apply to an SSM layer: it keeps no KV cache. A mamba2
model has none at all; hymba's hybrid layers run a ParisKV attention half
beside this mixer (``models.serve``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.models.layers import rms_norm, truncated_normal_


def ssm_dims(cfg: ModelConfig):
    """(inner width, heads, head dim, state size, groups)."""
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups


def conv_dim(cfg: ModelConfig) -> int:
    """Channels of the causal convolution: x, B and C."""
    d_in, _, _, n, g = ssm_dims(cfg)
    return d_in + 2 * g * n


def init_ssm(cfg: ModelConfig, dtype, device,
             gen: Optional[torch.Generator]) -> dict:
    """One mixer's parameters, drawn from ``gen``: the projections and the
    convolution in ``dtype``, ``A_log``, ``D`` and ``dt_bias`` in float32
    as the reference keeps them."""
    d = cfg.d_model
    d_in, nh, _, n, g = ssm_dims(cfg)

    def w(shape, std=0.02):
        return truncated_normal_(torch.empty(shape, device=device), gen,
                                 std).to(dtype)
    return {
        "w_in": w((d, 2 * d_in + 2 * g * n + nh)),
        "conv_w": w((cfg.ssm_conv_width, conv_dim(cfg)), std=0.1),
        "conv_b": torch.zeros((conv_dim(cfg),), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "dt_bias": torch.full((nh,), -2.0, dtype=torch.float32,
                              device=device),
        "out_norm": torch.ones((d_in,), dtype=dtype, device=device),
        "w_out": w((d_in, d)),
    }


def _split_in(cfg: ModelConfig, xz: torch.Tensor):
    """The input projection's output → (z, xBC, dt)."""
    d_in, nh, _, n, g = ssm_dims(cfg)
    return (xz[..., :d_in], xz[..., d_in:2 * d_in + 2 * g * n],
            xz[..., -nh:])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d along time, then SiLU, in the input's
    dtype. xBC: (b, l, c); w: (k, c)."""
    k, l = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    out = pad[:, 0:l] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + l] * w[i]
    return F.silu(out + b)


def segsum_exp(a: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(Σ_{j<t≤i} a_t) for i ≥ j else 0. a: (..., L). The
    mask goes on before the exp: the upper triangle's differences are
    large and positive and would overflow."""
    L = a.shape[-1]
    cs = torch.cumsum(a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return torch.exp(torch.where(mask, diff, -1e30))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, Cm: torch.Tensor, chunk: int = 256
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (the Mamba-2 paper's Alg. 1, "ssd_minimal").

    x: (b, l, h, p); dt: (b, l, h) after softplus; A: (h,) negative;
    B, Cm: (b, l, g, n), the g groups broadcast over the heads
    → (y (b, l, h, p), final state (b, h, p, n)). ``l`` must be a
    multiple of ``chunk`` (the reference asserts it)."""
    b, l, h, p_dim = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"ssd_chunked: length {l} is not a multiple of the "
                         f"chunk {chunk}")
    nc = l // chunk
    rep = h // g
    xc = x.reshape(b, nc, chunk, h, p_dim)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Cc = Cm.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    dA = dtc * A                                         # (b, nc, c, h) ≤ 0
    dA_cs = torch.cumsum(dA, dim=2)

    # intra-chunk (quadratic): Y = (C B^T ∘ L) (dt x)
    Lmat = segsum_exp(dA.movedim(2, -1))                 # (b, nc, h, c, c)
    scores = torch.einsum("bzihn,bzjhn->bzhij", Cc, Bc) * Lmat
    y_intra = torch.einsum("bzhij,bzjhp->bzihp",
                           scores * dtc.permute(0, 1, 3, 2)[:, :, :, None],
                           xc)

    # chunk-final states: S_z = Σ_j exp(dA_cs[end] - dA_cs[j]) dt_j B_j x_j^T
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)    # (b, nc, c, h)
    S = torch.einsum("bzjhn,bzjhp->bzhpn",
                     Bc * (decay_to_end * dtc)[..., None], xc)

    # inter-chunk recurrence over the chunk states, the state before each
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])              # (b, nc, h)
    state = torch.zeros((b, h, p_dim, n), dtype=x.dtype, device=x.device)
    prev = []
    for z in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, z, :, None, None] + S[:, z]
    prev_states = torch.stack(prev, dim=1)                   # (b, nc, h, p, n)

    # inter-chunk term: y_j += C_j · exp(dA_cs[j]) · prev_state
    y_inter = torch.einsum("bzihn,bzhpn->bzihp",
                           Cc * torch.exp(dA_cs)[..., None], prev_states)
    return (y_intra + y_inter).reshape(b, l, h, p_dim), state


def ssd_recurrent_step(state: torch.Tensor, x_t: torch.Tensor,
                       dt_t: torch.Tensor, A: torch.Tensor,
                       B_t: torch.Tensor, C_t: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step, products and sums. state: (b, h, p, n); x_t: (b,
    h, p); dt_t: (b, h); B_t, C_t: (b, g, n) → (y_t (b, h, p), new
    state)."""
    rep = x_t.shape[1] // B_t.shape[1]
    B_t = B_t.repeat_interleave(rep, dim=1)
    C_t = C_t.repeat_interleave(rep, dim=1)
    decay = torch.exp(dt_t * A)[..., None, None]
    upd = dt_t[:, :, None, None] * B_t[:, :, None, :] * x_t[..., None]
    new_state = state * decay + upd
    return (new_state * C_t[:, :, None, :]).sum(-1), new_state


class SSMCache(NamedTuple):
    state: torch.Tensor     # (b, h, p, n) float32
    conv_buf: torch.Tensor  # (b, k - 1, conv_dim): the last k - 1 inputs


def init_ssm_cache(batch: int, cfg: ModelConfig, dtype,
                   device) -> SSMCache:
    """A zero cache: the state in float32, the conv tail in ``dtype``."""
    _, nh, hp, n, _ = ssm_dims(cfg)
    return SSMCache(
        state=torch.zeros((batch, nh, hp, n), dtype=torch.float32,
                          device=device),
        conv_buf=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim(cfg)),
                             dtype=dtype, device=device))


def _ssm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, chunk: int,
               token_valid=None):
    """The mixer over a sequence x (b, l, d) → (output (b, l, d) in x's
    dtype, final state, pre-convolution inputs xBC)."""
    b, l, _ = x.shape
    d_in, nh, hp, n, g = ssm_dims(cfg)
    z, xBC, dt = _split_in(cfg, x @ p["w_in"])
    xBC_act = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs = xBC_act[..., :d_in].reshape(b, l, nh, hp)
    Bm = xBC_act[..., d_in:d_in + g * n].reshape(b, l, g, n)
    Cm = xBC_act[..., d_in + g * n:].reshape(b, l, g, n)
    dt = _softplus(dt.float() + p["dt_bias"])
    if token_valid is not None:
        # dt = 0 at a pad makes the recurrence an exact identity there
        # (decay exp(0·A) = 1, update dt·B·x = 0): a LEFT-aligned padded
        # row's final state is the state after its real tokens
        dt = dt * token_valid[..., None].to(dt.dtype)
    A = -torch.exp(p["A_log"])
    y, final_state = ssd_chunked(xs.float(), dt, A, Bm.float(), Cm.float(),
                                 min(chunk, l))
    y = y + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(b, l, d_in).to(x.dtype) * F.silu(z)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    return y @ p["w_out"], final_state, xBC


def ssm_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
              chunk: int = 256) -> torch.Tensor:
    """The mixer over a full sequence x (b, l, d) → (b, l, d), without
    the decode cache."""
    return _ssm_apply(p, x, cfg, chunk)[0]


def ssm_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                chunk: int = 256, token_valid=None, lengths=None
                ) -> Tuple[torch.Tensor, SSMCache]:
    """The mixer over a prompt that also returns the decode cache: the
    final state and the conv tail, the last k - 1 pre-activation inputs.
    ``token_valid`` (b, l) and ``lengths`` (b,) describe LEFT-aligned
    padded rows: pads are skipped exactly in the recurrence and the tail
    holds each row's last k - 1 real inputs, zeros before the prompt
    start (the convolution's causal padding)."""
    out, final_state, xBC = _ssm_apply(p, x, cfg, chunk, token_valid)
    k = cfg.ssm_conv_width
    if lengths is None:
        tail = xBC[:, -(k - 1):]
    else:
        idx = (lengths.long()[:, None] - (k - 1)
               + torch.arange(k - 1, device=x.device)[None])    # (b, k-1)
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        gathered = xBC[rows, idx.clamp(0, xBC.shape[1] - 1)]
        tail = torch.where((idx >= 0)[..., None], gathered,
                           torch.zeros((), dtype=xBC.dtype, device=x.device))
    return out, SSMCache(final_state, tail)


def ssm_decode(p: dict, x_t: torch.Tensor, cache: SSMCache,
               cfg: ModelConfig) -> Tuple[torch.Tensor, SSMCache]:
    """One recurrent step of rows x_t (b, d): the convolution over the
    conv tail and the new input, then the state update, in float32 →
    (output (b, d) in x_t's dtype, new cache)."""
    b = x_t.shape[0]
    d_in, nh, hp, n, g = ssm_dims(cfg)
    z, xBC_t, dt = _split_in(cfg, x_t @ p["w_in"])
    window = torch.cat([cache.conv_buf, xBC_t[:, None].to(
        cache.conv_buf.dtype)], 1)                               # (b, k, c)
    conv = ((window.float() * p["conv_w"].float()).sum(1)
            + p["conv_b"].float())
    xBC_a = F.silu(conv)
    xs = xBC_a[..., :d_in].reshape(b, nh, hp)
    B_t = xBC_a[..., d_in:d_in + g * n].reshape(b, g, n)
    C_t = xBC_a[..., d_in + g * n:].reshape(b, g, n)
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, new_state = ssd_recurrent_step(cache.state, xs, dt, A, B_t, C_t)
    y = y + xs * p["D"][None, :, None]
    y = y.reshape(b, d_in).to(x_t.dtype) * F.silu(z)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    return y @ p["w_out"], SSMCache(new_state, window[:, 1:])
