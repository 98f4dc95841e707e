"""Training launcher: ``python -m repro_torch.launch.train [...]``.

    python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
        --steps 20 --batch 4 --seq 128 --lr 3e-4 --ckpt out.npz \\
        [--device cpu]

The deployable path on one device: config → init → synthetic batches
(``data.make_batch``, the reference's stream from seed 0) → ``train_step``
(warm-up 5 steps, a cosine over ``--steps``) → a checkpoint in the
reference's npz format. Runs on the first CUDA card unless ``--device
cpu``. The weights come from the port's ``init_params(cfg, seed=0)``,
whose values differ from the reference's ``jax.random`` draws, so the
losses are not the reference's step for step. The reference's TPU-pod
dry run is not part of this launcher (nor of the reference's).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.ckpt import save_checkpoint
from repro_torch.data import SyntheticLMStream, make_batch, media_stub
from repro_torch.models import model as M
from repro_torch.models.train import TrainState, train_step
from repro_torch.optim import adamw_init


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    device = resolve_device(args.device)
    print(f"arch={cfg.name} params≈{cfg.num_params()/1e6:.1f}M")
    params = M.init_params(cfg, seed=0, device=device)
    state = TrainState(params, adamw_init(params))
    stream = SyntheticLMStream(cfg.vocab_size, seed=0)
    for step in range(args.steps):
        tokens, labels = make_batch(stream, args.batch, args.seq)
        batch = {"tokens": torch.as_tensor(tokens, device=device),
                 "labels": torch.as_tensor(labels, device=device)}
        if cfg.family == "vlm":
            batch["media"] = media_stub(args.batch, cfg.num_media_tokens,
                                        cfg.d_model, step)
        if cfg.family == "audio":
            batch["media"] = media_stub(args.batch, cfg.encoder_seq,
                                        cfg.d_model, step)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, cfg, peak_lr=args.lr,
                                    warmup=5, total_steps=args.steps)
        loss = float(metrics["loss"])             # waits for the device
        dt = time.perf_counter() - t0
        print(f"step {step:4d} loss {loss:.4f} gnorm "
              f"{float(metrics['grad_norm']):.3f} ({dt:.2f}s)", flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, state.params, cfg, step=args.steps)
        print("checkpoint →", args.ckpt)


if __name__ == "__main__":
    main()
