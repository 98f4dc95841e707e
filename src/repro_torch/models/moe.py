"""Mixture-of-experts FFN (port of ``repro/models/moe.py``): top-k routing
with a capacity per expert, plus optional shared experts (grok-1: 8
experts, top-2, no shared).

Dispatch scatters token ids into per-expert capacity slots, runs each
expert's dense products over its slots, and gathers the outputs back per
(token, slot): memory is O(n·k + E·cap·d), and the experts' weights are
read whole, never gathered per token. The reference computes all of this
outside any Pallas kernel, in XLA's products; here they are torch's.

Routing follows the reference bit for bit where it can: the router's
product and softmax run in float32 (the router is held in float32 in
every config), the top-k is ``lax.top_k``'s (descending, ties to the
lowest expert index), and capacity positions are an exclusive cumsum over
the (token, slot) order. Tokens past an expert's capacity are dropped
(their residual carries them).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def init_moe(d_model: int, d_ff: int, num_experts: int, num_shared: int,
             dtype, device, gen: Optional[torch.Generator]) -> dict:
    """The router (d, E) in float32 (std 0.006), the experts' (E, d, f)
    gate and up and (E, f, d) down in ``dtype``, and the ``shared`` MLP
    of width ``num_shared · d_ff`` when ``num_shared``."""
    def w(shape, std=0.02):
        return L.truncated_normal_(torch.empty(shape, device=device), gen,
                                   std)
    p = {"router": w((d_model, num_experts), 0.006),
         "experts_gate": w((num_experts, d_model, d_ff)).to(dtype),
         "experts_up": w((num_experts, d_model, d_ff)).to(dtype),
         "experts_down": w((num_experts, d_ff, d_model)).to(dtype)}
    if num_shared:
        p["shared"] = L.init_mlp(d_model, num_shared * d_ff, dtype, device,
                                 gen)
    return p


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the ``k`` largest by the float's
    total order, descending, ties to the lowest index — a stable
    descending sort of order-preserving int32 keys (``torch.topk``
    promises no order among ties). → (values, indices int64)."""
    bits = x.float().contiguous().view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(keys, dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return x.gather(-1, idx), idx


def _route(p: dict, xt: torch.Tensor, top_k: int):
    """xt (n, d) → (probs (n, E) float32, renormalised gates (n, k),
    expert ids (n, k) int64)."""
    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, -1)
    gate_vals, expert_idx = _top_k(probs, top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_idx


def _positions(expert_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each (token, slot)'s position in its expert's queue: the count of
    earlier (token, slot) pairs, in row-major order, routed to the same
    expert (an exclusive cumsum over the (n·k, E) one-hot). → (n, k)."""
    n, k = expert_idx.shape
    onehot = F.one_hot(expert_idx, num_experts).to(torch.int32)
    flat = onehot.reshape(n * k, num_experts)
    pos_all = (torch.cumsum(flat, 0) - flat).reshape(n, k, num_experts)
    return (pos_all * onehot).sum(-1)


def _slot_table(expert_idx: torch.Tensor, pos: torch.Tensor,
                keep: torch.Tensor, capacity: int,
                num_experts: int) -> torch.Tensor:
    """(E, capacity) token id held by each expert's slot, ``n`` where the
    slot is empty: kept (token, slot) pairs scatter into an (E,
    capacity + 1) table whose last column swallows the dropped ones."""
    n, k = expert_idx.shape
    dev = expert_idx.device
    table = torch.full((num_experts, capacity + 1), n, dtype=torch.int64,
                       device=dev)
    tok = torch.arange(n, device=dev)[:, None].expand(n, k)
    col = torch.where(keep, pos, capacity)
    table[expert_idx.reshape(-1), col.reshape(-1)] = tok.reshape(-1)
    return table[:, :capacity]


def _dispatch_gather(p: dict, xt: torch.Tensor, gate_vals: torch.Tensor,
                     expert_idx: torch.Tensor, capacity: int) -> torch.Tensor:
    """Scatter/gather expert execution: xt (n, d) → (n, d)."""
    n, d = xt.shape
    E = p["router"].shape[1]
    pos = _positions(expert_idx, E)
    keep = pos < capacity
    slot_tok = _slot_table(expert_idx, pos, keep, capacity, E)
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], 0)
    buf = xt_pad[slot_tok]                                   # (E, cap, d)
    h = F.silu(torch.bmm(buf, p["experts_gate"]))
    h = h * torch.bmm(buf, p["experts_up"])
    out_buf = torch.bmm(h, p["experts_down"])                # (E, cap, d)
    y = out_buf[expert_idx, torch.where(keep, pos, 0)]       # (n, k, d)
    y = y * keep[..., None].to(y.dtype)
    return torch.einsum("nkd,nk->nd", y, gate_vals.to(y.dtype))


def moe_fwd(p: dict, x: torch.Tensor, top_k: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) → (out (b, s, d), load-balance aux loss): every one of
    the b·s tokens routes and takes capacity, pad tokens too."""
    b, s, d = x.shape
    E = p["router"].shape[1]
    n = b * s
    xt = x.reshape(n, d)
    probs, gate_vals, expert_idx = _route(p, xt, top_k)
    capacity = max(int(capacity_factor * n * top_k / E), 4)
    out = _dispatch_gather(p, xt, gate_vals, expert_idx,
                           capacity).reshape(b, s, d)
    if "shared" in p:
        out = out + L.mlp_fwd(p["shared"], x).to(out.dtype)
    density = F.one_hot(expert_idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(density * probs.mean(0))
    return out.to(x.dtype), aux


def moe_decode(p: dict, x_t: torch.Tensor, top_k: int) -> torch.Tensor:
    """A decode step's rows x_t (b, d) → (b, d), with capacity factor 2
    (a small n quantizes capacity harshly): every batch row routes, free
    slots too."""
    b, d = x_t.shape
    E = p["router"].shape[1]
    _, gate_vals, expert_idx = _route(p, x_t, top_k)
    capacity = max(int(2.0 * b * top_k / E), 4)
    out = _dispatch_gather(p, x_t, gate_vals, expert_idx, capacity)
    if "shared" in p:
        out = out + L.mlp_fwd(p["shared"], x_t).to(out.dtype)
    return out.to(x_t.dtype)
