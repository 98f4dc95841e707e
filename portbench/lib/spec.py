"""The benchmark's data: the manifest (``BENCHMARK.json``), a cell's file
(``workloads/<cell>.json``), its configuration (``configs/<name>.json``)
and its traffic (``traffic/<name>.json``), each found by its name.

A configuration file holds the published ``config.json`` keys as run,
plus ``dtype``, ``pariskv`` (the retrieval's settings) and ``weights``
(how the random weights are drawn). ``model_config`` turns it into the
program's configuration object; nothing else of the program is named
here."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]          # portbench/
REPO = ROOT.parent
MANIFEST = REPO / "BENCHMARK.json"


def _load(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return _load(MANIFEST)


def cell(name: str) -> Dict:
    """The cell's file with its configuration and traffic merged in under
    ``config`` and ``traffic``."""
    c = _load(ROOT / "workloads" / f"{name}.json")
    c["name"] = name
    c["config"] = config(c["config"])
    c["traffic"] = dict(_load(ROOT / "traffic" / f"{c['traffic']}.json"),
                        name=c["traffic"])
    return c


def config(name: str) -> Dict:
    c = _load(ROOT / "configs" / f"{name}.json")
    c["name"] = name
    return c


def metrics_of(man: Dict, cell_name: str, kind: str):
    """The manifest's ``end_to_end`` or ``per_layer`` entries that the
    cell reports."""
    return [m for m in man[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg[
        "num_attention_heads"]


def model_config(cfg: Dict):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.core.config import ModelConfig, ParisKVConfig
    pk = dict(cfg["pariskv"])
    for key in ("tier_weights", "tier_pcts"):
        pk[key] = tuple(pk[key])
    return ModelConfig(
        family="dense", name=cfg["name"], num_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=head_dim(cfg),
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        qkv_bias=bool(cfg["qkv_bias"]), norm_eps=float(cfg["rms_norm_eps"]),
        dtype=cfg["dtype"], source=cfg["source"],
        pariskv=ParisKVConfig(**pk))
