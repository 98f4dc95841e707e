"""The smoke-size cell for the CPU tests: the full cell's files with the
configuration cut to the program's smoke widths and the traffic and
engine scaled to match. Only the tests use it."""
from __future__ import annotations

import copy

from portbench.lib import spec

SMOKE_PARISKV = dict(sink_size=8, local_size=32, update_interval=16,
                     top_k=16, min_candidates=32)


def smoke_config(name: str) -> dict:
    c = spec.config(name)
    c["pariskv"] = dict(c["pariskv"], **SMOKE_PARISKV)
    c["vocab_size"] = 512
    c["dtype"] = "float32"
    # at these widths std 0.02 leaves the tied embedding in charge (the
    # model repeats its input); wider weights let the layers decide
    c["weights"] = dict(c["weights"], std=0.08, qk_std=0.12)
    c.update(num_hidden_layers=2, hidden_size=256, num_attention_heads=4,
             num_key_value_heads=2, intermediate_size=512)
    return c


def smoke_cell(name: str) -> dict:
    """The cell ``name`` (sessions over one shared document) at smoke
    size, with the same engine class and options."""
    c = copy.deepcopy(spec.cell(name))
    c["config"] = smoke_config(c["config"]["name"])
    c["traffic"].update(clients=3, shared_prefix_tokens=128, sizes=8,
                        prompt_tokens={"dist": "fixed", "value": 24},
                        output_tokens={"dist": "fixed", "value": 80})
    c["engine"]["args"].update(n_max=256, max_batch=3, block_size=16,
                               num_blocks=64, prefill_budget=64)
    return c
