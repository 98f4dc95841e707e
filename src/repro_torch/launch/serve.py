"""Serving launcher: ``python -m repro_torch.launch.serve [...]``.

Runs the slot-based continuous-batching ``ServingEngine`` (or the lockstep
``WaveServingEngine`` with ``--wave``) over synthetic prompts with random
weights from seed 0, and reports per-request TTFT and TPOT and the
aggregate throughput, for ParisKV or the full-attention baseline
(``--baseline``). Runs on the first CUDA card unless ``--device cpu``.
The cross-attention architectures (``--arch llama-3.2-vision-11b``,
``--arch whisper-large-v3``) give every request the reference's stub media
(``data.media_stub``): patch embeddings or encoder frames. The
state-space architectures (``--arch mamba2-780m``, ``--arch hymba-1.5b``)
run on both engines; mamba2 has no KV cache, so ``--baseline`` changes
nothing there, and hymba's hybrid layers retrieve in the baseline too (as
the reference's do: only plain attention layers turn dense).
deepseek-v2-lite (``--arch deepseek-v2-lite-16b``) runs on both engines
too; its MLA layers retrieve over their latent in the baseline as well,
and ``--mesh-shards`` refuses it (its latent caches are not paged).

``--mesh-shards N`` serves the paged engine head-sharded over N ranks
(``PagedServingEngine(mesh_shards=N)``), one process per rank:

    torchrun --nproc-per-node N -m repro_torch.launch.serve \\
        --arch stablelm-1.6b --mesh-shards N [--device cpu]

Each rank joins the process group torchrun describes (NCCL with a card per
rank, else gloo: ``distributed.backend_for``) and serves the same
requests; rank 0 prints the per-request lines.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.data import SyntheticLMStream, media_stub
from repro_torch.distributed import backend_for
from repro_torch.models import model as M
from repro_torch.serving import (PagedServingEngine, Request, ServingEngine,
                                 WaveServingEngine)
from repro_torch.serving.engine import _sync


def _join_group(shards: int, device: torch.device) -> torch.device:
    """Join torchrun's process group of ``shards`` ranks → this rank's
    device (its own card under NCCL)."""
    if int(os.environ.get("WORLD_SIZE", "1")) != shards:
        raise SystemExit(f"--mesh-shards {shards} runs under torchrun "
                         f"--nproc-per-node {shards}")
    backend = backend_for(shards, device)
    print(f"rank {os.environ['RANK']}: backend {backend}", flush=True)
    if backend == "nccl":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.distributed.init_process_group(backend)
    return device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=192)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--n-max", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per host sync (slot engine)")
    ap.add_argument("--wave", action="store_true",
                    help="legacy lockstep wave engine instead of slots")
    ap.add_argument("--baseline", action="store_true",
                    help="full attention instead of ParisKV")
    ap.add_argument("--mesh-shards", type=int, default=1,
                    help="serve the paged engine head-sharded over this "
                         "many ranks (run under torchrun)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    device = resolve_device(args.device)
    rank0 = True
    if args.mesh_shards > 1:
        device = _join_group(args.mesh_shards, device)
        rank0 = torch.distributed.get_rank() == 0
    params = M.init_params(cfg, seed=0, device=device)
    if args.mesh_shards > 1:
        engine = PagedServingEngine(cfg, params, n_max=args.n_max,
                                    max_batch=args.batch,
                                    chunk_size=args.chunk,
                                    block_size=min(128, args.n_max),
                                    mesh_shards=args.mesh_shards,
                                    device=device)
    elif args.wave:
        engine = WaveServingEngine(cfg, params, n_max=args.n_max,
                                   max_batch=args.batch,
                                   use_pariskv=not args.baseline,
                                   device=device)
    else:
        engine = ServingEngine(cfg, params, n_max=args.n_max,
                               max_batch=args.batch, chunk_size=args.chunk,
                               use_pariskv=not args.baseline, device=device)
    stream = SyntheticLMStream(cfg.vocab_size, seed=1)
    media = None
    if cfg.family == "vlm":
        media = media_stub(1, cfg.num_media_tokens, cfg.d_model)[0]
    if cfg.family == "audio":
        media = media_stub(1, cfg.encoder_seq, cfg.d_model)[0]
    for i in range(args.requests):
        engine.submit(Request(uid=i, prompt=stream.sequence(args.prompt_len),
                              max_new_tokens=args.gen, media=media))
    t0 = time.perf_counter()
    done = engine.run()
    _sync(device)
    wall = time.perf_counter() - t0
    if args.mesh_shards > 1:
        torch.distributed.destroy_process_group()
    if not rank0:
        return
    for r in done:
        tpot = r.decode_s / max(r.max_new_tokens - 1, 1) * 1000
        print(f"req {r.uid}: ttft {r.ttft_s*1000:.1f}ms  "
              f"tpot {tpot:.1f}ms/tok  out[:8]={r.output[:8].tolist()}")
    mode = "full-attention" if args.baseline else "ParisKV"
    sched = (f"paged, {args.mesh_shards} head shards" if args.mesh_shards > 1
             else "wave" if args.wave else "slots")
    agg = sum(len(r.output) for r in done) / max(wall, 1e-9)
    print(f"[{mode}/{sched}] end-to-end throughput ≈ {agg:.1f} tok/s "
          f"({len(done)} requests in {wall:.2f}s on {device})")


if __name__ == "__main__":
    main()
