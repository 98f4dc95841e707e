"""The plain reference of the served models, teacher-forced: given the
weights the benchmark made and each sequence's prompt and served tokens,
the float32 logits at every position that chose a served token.

It imports nothing of the program. Each model follows its configuration
file (``portbench/configs``) as run, departures included:

* qwen2 (arXiv:2407.10671): RMSNorm, GQA attention with q/k/v biases,
  rotary embeddings on half-split heads (theta 1e6), SwiGLU MLP, tied
  embeddings.

A prompt's positions attend causally to every earlier position. Each
served token after the first is chosen at a decode step, which attends
to the sink, the local window and the ParisKV winners of its retrieval
region (``reference/pariskv.py``), with the region end that the decode
schedule gives. Everything runs layer by layer over all positions of all
sequences at once, which teacher forcing allows; a shared prompt prefix
(``prefix``) is computed once.

``precision="fp8"`` is the control: every product of a linear layer
takes its weight and its input rounded to float8 e4m3 (one scale per
tensor), as an fp8 deployment of the model would.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference import pariskv as PK

_Q_CHUNK = 512


def _qdq(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per tensor, back to float32."""
    x = x.float()
    s = x.abs().amax().clamp_min(1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (n, heads, hd), pos (n,): rotate the pairs (j, j + hd/2)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


class Sequence:
    """One sequence to check: its prompt and its served tokens."""

    def __init__(self, prompt, served):
        self.prompt = torch.as_tensor(prompt, dtype=torch.long)
        self.served = torch.as_tensor(served, dtype=torch.long)
        self.L = len(self.prompt)
        self.T = len(self.served)
        self.tokens = torch.cat([self.prompt, self.served[:-1]])


class Reference:
    def __init__(self, cfg: Dict, weights: Dict, device,
                 precision: str = "fp32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
            False
        self.cfg, self.w, self.dev = cfg, weights, torch.device(device)
        self.fp8 = precision == "fp8"
        self.pk = cfg["pariskv"]
        self.eps = float(cfg["rms_norm_eps"])
        self.index = PK.Index(
            self.pk, cfg["hidden_size"] // cfg["num_attention_heads"],
            self.dev)

    # ------------------------------------------------------------ basics --
    def _w(self, t: torch.Tensor) -> torch.Tensor:
        return _qdq(t) if self.fp8 else t.float()

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_qdq(x) if self.fp8 else x) @ self._w(w)

    def _mlp(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        return self._mm(F.silu(self._mm(x, p["wi_gate"]))
                        * self._mm(x, p["wi_up"]), p["wo_mlp"])

    # ------------------------------------------------------------ public --
    @torch.no_grad()
    def logits(self, seqs: List[Sequence], n_max: int,
               prefix: int = 0) -> List[torch.Tensor]:
        """Each sequence's (T, vocab) float32 logits: row j the logits
        that chose served token j. ``n_max`` sets C; ``prefix`` the
        length of a prompt prefix every sequence shares, computed once."""
        cfg, dev = self.cfg, self.dev
        if prefix and prefix >= min(s.L for s in seqs):
            raise ValueError("a shared prefix is shorter than every prompt")
        self.num_candidates = PK.candidate_count(self.pk, n_max)
        emb = self.w["embed"]

        def embed(tok):
            e = emb[tok.to(dev)]
            return self._w(e) if self.fp8 else e.float()
        x_pre = embed(seqs[0].tokens[:prefix]) if prefix else None
        xs = [embed(s.tokens[prefix:]) for s in seqs]
        sched = [PK.region_schedule(s.L, s.T - 1, self.pk) for s in seqs]
        for p in self.w["layers"]:
            h = [_norm(x, p["norm_attn"], self.eps) for x in xs]
            h_pre = (None if x_pre is None
                     else _norm(x_pre, p["norm_attn"], self.eps))
            a_pre, att = self._attn_layer(p["attn"], h_pre, h, seqs, sched,
                                          prefix)
            if x_pre is not None:
                x_pre = x_pre + a_pre
                x_pre = x_pre + self._mlp(
                    p["mlp"], _norm(x_pre, p["norm_mlp"], self.eps))
            xs = [x + a for x, a in zip(xs, att)]
            xs = [x + self._mlp(p["mlp"], _norm(x, p["norm_mlp"], self.eps))
                  for x in xs]
        out = []
        unemb = (self.w["embed"].T if cfg["tie_word_embeddings"]
                 else self.w["unembed"])
        for x, s in zip(xs, seqs):
            x = _norm(x[s.L - 1 - prefix:], self.w["final_norm"], self.eps)
            out.append(self._mm(x, unemb))
        return out

    # --------------------------------------------------------- attention --
    def _decode_attend(self, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, s: Sequence, sched: List[int],
                       scale: float, heads_per_kv: int) -> torch.Tensor:
        """Decode positions L..N-1 of one sequence. q (N, H, dq), k (N, G,
        dq), v (N, G, dv), retrieval on q over k → (N - L, H, dv)."""
        N, H = q.shape[:2]
        G = k.shape[1]
        L, pk, dev = s.L, self.pk, self.dev
        sink = int(pk["sink_size"])
        out = torch.empty((N - L, H, v.shape[-1]), device=dev)
        if N == L:
            return out
        enc_max = max(sched)
        meta = [self.index.encode(k[sink:max(enc_max, sink), g])
                for g in range(G)]
        steps = torch.arange(N - L)
        for enc in sorted(set(sched)):
            idx = steps[torch.tensor(sched) == enc]
            pos = (idx + L).to(dev)
            nreg = max(enc - sink, 0)
            mask = torch.zeros((len(idx), H, N), dtype=torch.bool,
                               device=dev)
            for g in range(G):
                hs = slice(g * heads_per_kv, (g + 1) * heads_per_kv)
                qg = q[pos, hs].reshape(-1, q.shape[-1])
                win = self.index.winners(qg, *meta[g], nreg,
                                         self.num_candidates,
                                         int(pk["top_k"]))
                win = (win + sink).reshape(len(idx), heads_per_kv, -1)
                mask[:, hs].scatter_(-1, win, True)
            for j, p in enumerate(pos.tolist()):
                mask[j, :, :p + 1] |= PK.attended(p, enc, pk, dev)[None]
            kk = k.repeat_interleave(heads_per_kv, 1)         # (N, H, dq)
            vv = v.repeat_interleave(heads_per_kv, 1)
            for c0 in range(0, len(idx), 64):
                sl = slice(c0, c0 + 64)
                sc = torch.einsum("qhd,nhd->qhn", q[pos[sl]], kk) * scale
                sc = sc.masked_fill(~mask[sl], float("-inf"))
                out[idx[sl]] = torch.einsum("qhn,nhd->qhd",
                                            torch.softmax(sc, -1), vv)
        return out

    def _causal(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, q0: int, heads_per_kv: int) -> torch.Tensor:
        """Queries at positions q0.. over keys 0..: q (n, H, dq), k (m, G,
        dq), v (m, G, dv) → (n, H, dv)."""
        kk = k.repeat_interleave(heads_per_kv, 1)
        vv = v.repeat_interleave(heads_per_kv, 1)
        out = []
        kpos = torch.arange(k.shape[0], device=q.device)
        for c0 in range(0, q.shape[0], _Q_CHUNK):
            qc = q[c0:c0 + _Q_CHUNK]
            qpos = torch.arange(qc.shape[0], device=q.device) + q0 + c0
            hi = int(qpos[-1]) + 1
            sc = torch.einsum("qhd,nhd->qhn", qc, kk[:hi]) * scale
            sc = sc.masked_fill((kpos[None, :hi] > qpos[:, None])[:, None],
                                float("-inf"))
            out.append(torch.einsum("qhn,nhd->qhd", torch.softmax(sc, -1),
                                    vv[:hi]))
        return torch.cat(out)

    def _attn_layer(self, p: Dict, h_pre: Optional[torch.Tensor],
                    h: List[torch.Tensor], seqs, sched, prefix: int):
        """→ (the shared prefix's output or None, each sequence's output
        over its own positions prefix..)."""
        cfg = self.cfg
        H, G = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        hd = cfg["hidden_size"] // H
        theta = float(cfg["rope_theta"])
        scale = 1.0 / math.sqrt(hd)

        def qkv(x, pos):
            n = x.shape[0]
            q = (self._mm(x, p["wq"]) + p["bq"].float()).reshape(n, H, hd)
            k = (self._mm(x, p["wk"]) + p["bk"].float()).reshape(n, G, hd)
            v = (self._mm(x, p["wv"]) + p["bv"].float()).reshape(n, G, hd)
            return _rope(q, pos, theta), _rope(k, pos, theta), v
        a_pre = None
        if h_pre is not None:
            q0, k0, v0 = qkv(h_pre, torch.arange(prefix, device=self.dev))
            a_pre = self._mm(self._causal(q0, k0, v0, scale, 0, H // G
                                          ).reshape(prefix, H * hd), p["wo"])
        outs = []
        for x, s, sc in zip(h, seqs, sched):
            n = x.shape[0]
            q, k, v = qkv(x, torch.arange(prefix, prefix + n,
                                          device=self.dev))
            if h_pre is not None:
                k, v = torch.cat([k0, k]), torch.cat([v0, v])
                q = torch.cat([q.new_zeros((prefix, H, hd)), q])
            own = self._causal(q[prefix:s.L], k[:s.L], v[:s.L], scale,
                               prefix, H // G)
            dec = self._decode_attend(q, k, v, s, sc, scale, H // G)
            o = torch.cat([own, dec]).reshape(n, H * hd)
            outs.append(self._mm(o, p["wo"]))
        return a_pre, outs


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far below the best logit each chosen token's logit lies."""
    tokens = tokens.to(logits.device)
    return logits.max(-1).values - logits.gather(-1, tokens[:, None])[:, 0]
