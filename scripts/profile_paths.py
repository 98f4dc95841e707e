#!/usr/bin/env python3
"""Decode-step profiles of the port's contiguous slot engine, paged
meta-view engine and offloaded engine on one NVIDIA card, for the port in
a given source tree: how two commits are compared in one call (parent,
change, change, parent).

    python3 scripts/profile_paths.py [SRC] [PATH ...]

``SRC`` is a tree's ``src/`` directory (default: this checkout's); PATH
is ``slot``, ``metaview`` or ``offload`` (128 of 512 blocks staged in a
pinned host pool; default: slot and metaview). Each path serves
qwen2-1.5b at full width (28 layers, bf16, random weights from
seed 0) and prints one ``profile {...}`` line from
``chip_smoke.profile_phase``: wall and device-busy time per decode step,
launches and host-device copies per step, the top kernels and the port's
own kernels' device time per step (four rows of 2,000-token prompts,
n_max 16,384, one profiled chunk of eight steps). Fails without a card.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_paths: no CUDA device is available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    paths = [a for a in args if a in ("slot", "metaview", "offload")]
    for a in args:
        if a not in paths:
            sys.path.insert(0, os.path.abspath(a))
    from repro_torch import configs
    from repro_torch.models.model import init_params
    from repro_torch.serving import PagedServingEngine, ServingEngine

    print("src " + os.path.dirname(
        sys.modules["repro_torch"].__file__), flush=True)
    cfg = configs.get("qwen2-1.5b")
    params = init_params(cfg, seed=0, device="cuda")
    engines = {
        "slot": lambda: ServingEngine(cfg, params, n_max=16384, max_batch=4,
                                      chunk_size=8, device="cuda"),
        "metaview": lambda: PagedServingEngine(
            cfg, params, n_max=16384, block_size=128, max_batch=4,
            num_blocks=512, chunk_size=8, fused=False, device="cuda"),
        "offload": lambda: PagedServingEngine(
            cfg, params, n_max=16384, block_size=128, max_batch=4,
            num_blocks=512, num_device_blocks=128, chunk_size=8,
            offload=True, device="cuda")}
    for path in paths or ("slot", "metaview"):
        make = engines[path]
        eng = make()
        chip_smoke._warm(eng, cfg)
        chip_smoke.profile_phase(eng, cfg, path)
        del eng
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
