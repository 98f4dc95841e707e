"""Serving launcher: ``python -m repro_torch.launch.serve [...]``.

Runs the slot-based continuous-batching ``ServingEngine`` (or the lockstep
``WaveServingEngine`` with ``--wave``) over synthetic prompts with random
weights from seed 0, and reports per-request TTFT and TPOT and the
aggregate throughput, for ParisKV or the full-attention baseline
(``--baseline``). Runs on the first CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import configs, resolve_device
from repro_torch.data import SyntheticLMStream
from repro_torch.models import model as M
from repro_torch.serving import Request, ServingEngine, WaveServingEngine
from repro_torch.serving.engine import _sync


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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    device = resolve_device(args.device)
    params = M.init_params(cfg, seed=0, device=device)
    if args.wave:
        engine = WaveServingEngine(cfg, params, n_max=args.n_max,
                                   max_batch=args.batch,
                                   use_pariskv=not args.baseline,
                                   device=device)
    else:
        engine = ServingEngine(cfg, params, n_max=args.n_max,
                               max_batch=args.batch, chunk_size=args.chunk,
                               use_pariskv=not args.baseline, device=device)
    stream = SyntheticLMStream(cfg.vocab_size, seed=1)
    for i in range(args.requests):
        engine.submit(Request(uid=i, prompt=stream.sequence(args.prompt_len),
                              max_new_tokens=args.gen))
    t0 = time.perf_counter()
    done = engine.run()
    _sync(device)
    wall = time.perf_counter() - t0
    for r in done:
        tpot = r.decode_s / max(r.max_new_tokens - 1, 1) * 1000
        print(f"req {r.uid}: ttft {r.ttft_s*1000:.1f}ms  "
              f"tpot {tpot:.1f}ms/tok  out[:8]={r.output[:8].tolist()}")
    mode = "full-attention" if args.baseline else "ParisKV"
    sched = "wave" if args.wave else "slots"
    agg = sum(len(r.output) for r in done) / max(wall, 1e-9)
    print(f"[{mode}/{sched}] end-to-end throughput ≈ {agg:.1f} tok/s "
          f"({len(done)} requests in {wall:.2f}s on {device})")


if __name__ == "__main__":
    main()
