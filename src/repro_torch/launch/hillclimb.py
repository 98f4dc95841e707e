"""Layout experiments on the capacity planner (counterpart of
``repro/launch/hillclimb.py``), on meta tensors: nothing is allocated.

  E1  llama-3.2-vision-11b × decode_32k
  E2  stablelm-1.6b × long_500k
  E3  gemma2-27b × train_4k

E1 and E2 plan one global-attention layer's decode step, on the
reference's production mesh and on each ``--gpus`` mesh, in two ways:
all-gathering the layer's sequence-sharded K/V and metadata, which is what
the reference's GSPMD lowering of the global gather does, and the port's
``distributed_retrieve_fetch`` (``decode_step(dist=SeqShardDist)``): two
all-gathers of the local winners and one all-reduce of the rows
(``launch.mesh.collective_plan``). Each case gives a rank's cache bytes
after the step's collectives and the bytes they move, for one layer and
for the model's ParisKV layers.

E3 gives a rank's params plus AdamW state, and with the gradients, with
FSDP×TP and with pure TP (``fsdp=False``, the reference's
``REPRO_FSDP=0``), ``fits`` a lower bound (``dryrun.FITS_NOTE``), and the
step's FLOPs
with remat on and off (``FlopCounterMode`` counts the recompute under
``torch.utils.checkpoint``).

Times: a rank's bytes over the H100's 3.35 TB/s of HBM3; link times only
for a ``--link-gbps`` rate (10^9 bytes a second) given on the command
line.

    python -m repro_torch.launch.hillclimb --exp all --gpus 1,4 --device cpu
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import torch

from repro_torch import configs, resolve_device
from repro_torch.core import cache as CC
from repro_torch.core.config import INPUT_SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MX
from repro_torch.models.model import torch_dtype
from repro_torch.models.serve import pool_layers
from repro_torch.optim import adamw_init

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, as PERF.md's bounds


def _times(rec: Dict, hbm_bytes: int, coll_bytes: int,
           link_gbps: Optional[float]) -> Dict:
    rec["t_mem_ms"] = hbm_bytes / HBM_BYTES_PER_S * 1e3
    rec["t_link_ms"] = (None if link_gbps is None
                        else coll_bytes / (link_gbps * 1e9) * 1e3)
    return rec


def _report(rec: Dict) -> Dict:
    link = ("" if rec["t_link_ms"] is None
            else f"  t_link={rec['t_link_ms']:9.3f} ms")
    print(f"{rec['tag']:44s} cache/rank={rec['cache_bytes'] / 1e9:9.3f} GB "
          f"coll/rank={rec['collective_bytes'] / 1e9:9.4f} GB  "
          f"t_mem={rec['t_mem_ms']:8.3f} ms{link}", flush=True)
    return rec


def one_layer_decode(arch: str, shape_name: str, mesh: MX.MeshShape,
                     link_gbps: Optional[float] = None) -> List[Dict]:
    """E1/E2 on one mesh: a rank's bytes of one ParisKV layer's cache and
    its collective bytes a decode step, gathering the cache against the
    distributed fetch, for one layer and for the model's ParisKV
    layers."""
    cfg = configs.get(arch)
    shape = INPUT_SHAPES[shape_name]
    b, n = shape.global_batch, shape.seq_len
    layers = sum(pool_layers(cfg))
    layer = [{"kv": CC.init_layer_cache(b, n, cfg.num_kv_heads,
                                        cfg.head_dim, cfg.pariskv,
                                        torch_dtype(cfg), D.META)}]
    shard = MX.rank_bytes(layer, MX.seq_shard_sharding(layer, mesh, b), mesh)
    out, where = [], MX.mesh_tag(mesh)
    for tag, layout in (("gather the cache", "gather_cache"),
                        ("distributed fetch", "seq_shards")):
        coll = MX.collective_plan(cfg, layout, mesh, b, n)
        per = coll["per_layer_step"]
        # after gathering, a rank holds every shard of the layer
        held = (per["all_gather_cache"]["recv"]
                if layout == "gather_cache" and per else shard)
        for scale, what in ((1, "1 layer"), (layers, f"×{layers} layers")):
            rec = dict(tag=f"{arch} {where} {tag} ({what})", arch=arch,
                       shape=shape_name, mesh=where, case=layout,
                       layers=scale, shards=coll["shards"],
                       cache_bytes=held * scale,
                       collective_bytes=coll["total_per_layer_step"] * scale,
                       per_layer_step=per)
            out.append(_report(_times(rec, held * scale,
                                      coll["total_per_layer_step"] * scale,
                                      link_gbps)))
    return out


def train_layouts(arch: str, shape_name: str, mesh: MX.MeshShape,
                  capacity: Optional[int] = None) -> List[Dict]:
    """E3 on one mesh: a rank's params plus AdamW state, and with the
    gradients, with FSDP×TP and pure TP."""
    cfg = configs.get(arch)
    params = D.params_spec(cfg)
    opt = adamw_init(params)
    out, where = [], MX.mesh_tag(mesh)
    for fsdp in (True, False):
        specs = MX.params_sharding(params, mesh, fsdp=fsdp)
        pbytes = MX.rank_bytes(params, specs, mesh)
        nbytes = pbytes + MX.rank_bytes(opt, MX.opt_sharding(opt, specs),
                                        mesh)
        grads = pbytes          # params-shaped, laid out as the params
        known = nbytes + grads
        rec = dict(tag=f"{arch} {where} {'FSDPxTP' if fsdp else 'pure TP'}",
                   arch=arch, shape=shape_name, mesh=where, fsdp=fsdp,
                   state_bytes=nbytes, grad_bytes=grads, known_bytes=known,
                   t_mem_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   fits=None if capacity is None else known <= capacity,
                   fits_note=D.FITS_NOTE)
        print(f"{rec['tag']:44s} params+opt/rank={nbytes / 1e9:9.3f} GB "
              f"+grads={known / 1e9:9.3f} GB fits={rec['fits']}",
              flush=True)
        out.append(rec)
    return out


def train_flops(arch: str, shape_name: str) -> List[Dict]:
    """E3's FLOPs: the whole step with remat on and off."""
    cfg = configs.get(arch)
    out = []
    for remat in (True, False):
        flops, _ = D.step_flops(cfg, INPUT_SHAPES[shape_name], remat=remat)
        rec = dict(tag=f"{arch} remat {'on' if remat else 'off'}", arch=arch,
                   shape=shape_name, remat=remat, flops=flops)
        print(f"{rec['tag']:44s} flops={flops:.6e}", flush=True)
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.hillclimb")
    ap.add_argument("--exp", default="all", choices=("e1", "e2", "e3", "all"))
    ap.add_argument("--gpus", action="append", default=[], metavar="D,M",
                    help="a GPU mesh (data=D, model=M) beside the "
                         "production mesh; repeatable")
    ap.add_argument("--link-gbps", type=float, default=None,
                    help="a link rate in GB/s (10^9 bytes per second) for "
                         "link times; the port has measured none between "
                         "two cards")
    ap.add_argument("--device", default=None,
                    help="where E3's `fits` is judged: the card (default; "
                         "raises without one) or cpu (fits null)")
    ap.add_argument("--out", default="hillclimb_results.json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    capacity = (torch.cuda.get_device_properties(dev).total_memory
                if dev.type == "cuda" else None)
    meshes = [MX.production_mesh()] + [
        MX.gpu_mesh(*(int(x) for x in g.split(","))) for g in args.gpus]
    results: List[Dict] = []
    if args.exp in ("e1", "all"):
        print("\n=== E1: llama-3.2-vision-11b × decode_32k ===", flush=True)
        for mesh in meshes:
            results += one_layer_decode("llama-3.2-vision-11b", "decode_32k",
                                        mesh, args.link_gbps)
    if args.exp in ("e2", "all"):
        print("\n=== E2: stablelm-1.6b × long_500k ===", flush=True)
        for mesh in meshes:
            results += one_layer_decode("stablelm-1.6b", "long_500k", mesh,
                                        args.link_gbps)
    if args.exp in ("e3", "all"):
        print("\n=== E3: gemma2-27b × train_4k ===", flush=True)
        for mesh in meshes:
            results += train_layouts("gemma2-27b", "train_4k", mesh, capacity)
        results += train_flops("gemma2-27b", "train_4k")
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print("→", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
