"""Random weights from the run's seed, made on the device in a few large
draws, in the type they are served in, laid out as the program's
parameter tree. The reference reads the same tensors.

Matrices and embeddings are normal with the configuration's ``std``; the
products that form attention scores (``wq`` and ``wk``) with ``qk_std``,
so that a query's scores have a clear top set, as a trained model's do,
and retrieval has something to find; biases with ``bias_std``; norm
scales 1 + N(0, ``norm_std``). One generator on the device, seeded with
the run's seed, draws three flat buffers (the served-dtype matrices, the
score matrices, the norm scales); every leaf is a view into one of
them."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.lib.spec import head_dim

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaves(cfg: Dict) -> List[Tuple[Tuple, Tuple[int, ...], str]]:
    """(path, shape, kind) of every leaf; kind is ``w`` (a matrix), ``a``
    (a matrix that forms attention scores), ``b`` (a bias) or ``n`` (a
    norm scale)."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    H, G, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        head_dim(cfg)
    f = cfg["intermediate_size"]
    out = [(("embed",), (V, d), "w"), (("final_norm",), (d,), "n")]
    if not cfg["tie_word_embeddings"]:
        out.append((("unembed",), (d, V), "w"))
    for li in range(cfg["num_hidden_layers"]):
        lay = ("layers", li)
        out += [(lay + ("norm_attn",), (d,), "n"),
                (lay + ("norm_mlp",), (d,), "n")]
        a = lay + ("attn",)
        out += [(a + ("wq",), (d, H * hd), "a"),
                (a + ("wk",), (d, G * hd), "a"),
                (a + ("wv",), (d, G * hd), "w"),
                (a + ("wo",), (H * hd, d), "w")]
        if cfg.get("qkv_bias"):
            out += [(a + ("bq",), (H * hd,), "b"),
                    (a + ("bk",), (G * hd,), "b"),
                    (a + ("bv",), (G * hd,), "b")]
        m = lay + ("mlp",)
        out += [(m + ("wi_gate",), (d, f), "w"),
                (m + ("wi_up",), (d, f), "w"),
                (m + ("wo_mlp",), (f, d), "w")]
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _put(tree: Dict, path: Tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
            continue
        node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append({})
    node[path[-1]] = value


def make(cfg: Dict, seed: int, device) -> Dict:
    """The parameter tree of ``cfg`` drawn from ``seed`` on ``device``."""
    dt = _DT[cfg["dtype"]]
    ws = cfg["weights"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    items = leaves(cfg)
    sizes = {k: sum(_numel(s) for _, s, kk in items if kk in k)
             for k in ("wb", "a", "n")}
    flat = {
        "wb": torch.empty(sizes["wb"], dtype=dt, device=device).normal_(
            0.0, float(ws["std"]), generator=gen),
        "a": torch.empty(sizes["a"], dtype=dt, device=device).normal_(
            0.0, float(ws.get("qk_std", ws["std"])), generator=gen),
        "n": torch.empty(sizes["n"], dtype=torch.float32,
                         device=device).normal_(
            1.0, float(ws["norm_std"]), generator=gen).to(dt),
    }
    bias_scale = float(ws.get("bias_std", ws["std"])) / float(ws["std"])
    at = {"wb": 0, "a": 0, "n": 0}
    tree: Dict = {}
    for path, shape, kind in items:
        key = "wb" if kind in "wb" else kind
        n = _numel(shape)
        t = flat[key][at[key]:at[key] + n].view(shape)
        at[key] += n
        if kind == "b" and bias_scale != 1.0:
            t.mul_(bias_scale)
        _put(tree, path, t)
    return tree


def count(cfg: Dict) -> int:
    """Parameters of ``cfg``, every leaf counted."""
    return sum(_numel(s) for _, s, _ in leaves(cfg))
