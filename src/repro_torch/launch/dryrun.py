"""Capacity planner: the port's dry run (counterpart of
``repro/launch/dryrun.py``).

For every (architecture × input shape × mesh) combination, build the
step's arguments — params, AdamW state, caches, inputs — on
``torch.device("meta")`` (shapes and dtypes, no storage), lay them out by
the reference's sharding rules (``launch.mesh``) or by one of the port's
runnable decode layouts, and record what one rank holds, the step's
FLOPs and the bytes its collectives move. Nothing is allocated on any
device.

    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --both-meshes --out plan.json
    python -m repro_torch.launch.dryrun --arch stablelm-1.6b --gpus 1,4 \\
        --gpus 1,8 --device cpu

Layouts (``layout`` in each record):

* ``gspmd``: the reference's plan (``params_sharding``, ``opt_sharding``,
  ``data_sharding``, ``cache_sharding``) applied to the port's leaves. The
  port runs no GSPMD program: the record's bytes are what the
  reference's layout would put on a rank.
* ``seq_shards`` (decode): ``decode_step(dist=SeqShardDist)`` over
  ``models.serve.seq_shard_state``, the counterpart of the reference's
  ``REPRO_DIST_RETRIEVAL=1``: K, V and metadata cut by position; rings,
  media, SSM state, MLA latents and regions whole; params on every rank.
* ``head_shards`` (decode): the paged pool of
  ``PagedServingEngine(mesh_shards=N)``, N = the mesh's ``model`` axis,
  cut by KV head, the engine's default block count.

A layout the port refuses for a combination (MLA and mamba2 on the paged
engines, the baseline under sequence shards, an n_max that does not
split) gets a record with ``ok`` false and the port's own refusal text.

A record keeps the reference's keys: ``arch``, ``shape``, ``mesh``,
``chips``, ``pariskv``, ``ok``, ``flops`` and ``memory.{argument_bytes,
output_bytes, temp_bytes, peak_bytes}``. ``argument_bytes`` is one
rank's, exact; ``temp_bytes`` and ``peak_bytes`` are null (no compiler
reports them here). ``flops`` is the whole step's (every rank together),
counted by ``torch.utils.flop_counter.FlopCounterMode`` over the step on
meta tensors: ``forward_train`` and its gradient (remat on) for train,
``prefill`` for prefill, the dense baseline's ``decode_step`` for
``--dense-baseline`` decode. A ParisKV decode step's FLOPs are null: its
retrieval kernels launch through ``ctypes``, which the counter cannot
see, and a meta tensor must not reach a kernel wrapper. ``fits``
compares a rank's ``known_bytes`` (its argument bytes, plus its gradients'
for train) with the card's memory (``torch.cuda.get_device_properties``)
when the device is the card, the default; ``--device cpu`` leaves it
null. It is a lower bound (``FITS_NOTE``): activations and workspace are
not counted, so a false is final and a true alone does not choose one
card or more. ``--bodies`` counts one period
of each stage of ``models.model.layer_plan`` (the reference's
``body_costs``) and asserts that the whole step's FLOPs equal Σ repeat ×
body, the parts outside the stages (embedding, unembedding and loss;
whisper's encoder) counted as bodies of repeat 1.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import time
import traceback
from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs, resolve_device, tree_leaves, tree_map
from repro_torch.core import cache as CC
from repro_torch.core.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.distributed import ShardDist
from repro_torch.launch import mesh as MX
from repro_torch.models import serve as SV
from repro_torch.models.model import (encoder_fwd, init_params,
                                      layer_fwd_train, layer_places,
                                      layer_plan, torch_dtype)
from repro_torch.models.train import loss_grads
from repro_torch.optim import adamw_init

META = torch.device("meta")
LAYOUTS = ("gspmd", "seq_shards", "head_shards")
# the reference's --all: the first ten of its ARCHS, in its order
ALL_ARCHS = ("stablelm-1.6b", "gemma2-27b", "llama-3.2-vision-11b",
             "grok-1-314b", "mamba2-780m", "hymba-1.5b", "whisper-large-v3",
             "qwen2-1.5b", "deepseek-v2-lite-16b", "gemma3-12b")
FITS_NOTE = (
    "a lower bound: known_bytes are the step's arguments and, for train, "
    "its gradients; activations, workspace and the allocator's slack are "
    "not counted, so false is final and true alone does not show that "
    "the step runs")
PARISKV_FLOPS_NOTE = (
    "not counted: the ParisKV decode step's retrieval kernels launch "
    "through ctypes, which FlopCounterMode cannot see, and a meta tensor "
    "must not reach a kernel wrapper")


def params_spec(cfg: ModelConfig) -> dict:
    """The port's parameters on meta: every leaf's shape and dtype."""
    return init_params(cfg, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape
                ) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for every model input of this workload (the
    reference's ``input_specs``): tokens and labels (train), tokens
    (prefill), the decode token, and the media of the vlm and audio
    families outside decode."""
    b, s = shape.global_batch, shape.seq_len

    def z(shape_, dt):
        return torch.empty(shape_, dtype=dt, device=META)
    out: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        out["tokens"] = z((b, s), torch.int32)
        out["labels"] = z((b, s), torch.int32)
    elif shape.kind == "prefill":
        out["tokens"] = z((b, s), torch.int32)
    else:
        out["token"] = z((b,), torch.int32)
    if cfg.family == "vlm" and shape.kind != "decode":
        out["media"] = z((b, cfg.num_media_tokens, cfg.d_model),
                         torch.float32)
    if cfg.family == "audio" and shape.kind != "decode":
        out["media"] = z((b, cfg.encoder_seq, cfg.d_model), torch.float32)
    return out


def _logits(cfg: ModelConfig, batch: int) -> torch.Tensor:
    return torch.empty((batch, cfg.vocab_size), dtype=torch_dtype(cfg),
                       device=META)


def _refusal(fn) -> Optional[str]:
    """The text of the port's refusal when ``fn`` raises one, else None."""
    try:
        fn()
    except (ValueError, NotImplementedError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return None


def paged_state(cfg: ModelConfig, batch: int, n_max: int, shards: int = 1,
                block_size: int = CC.PAGED_DEFAULT_BLOCK,
                num_blocks: Optional[int] = None) -> SV.SlotState:
    """The slot state ``PagedServingEngine.start()`` allocates on one
    rank (all but its 8-byte non-finite counter), on meta: ``batch``
    slots over a pool of ``num_blocks`` blocks (default the engine's,
    batch · n_max / block_size) holding the rank's KV heads of
    ``shards``, with every slot-local leaf."""
    if num_blocks is None:
        num_blocks = batch * (n_max // block_size)
    dist = ShardDist(0, shards) if shards > 1 else None
    return SV.init_paged_slot_state(cfg, batch, num_blocks, block_size,
                                    device=META, n_max=n_max, dist=dist)


def _count(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def step_flops(cfg: ModelConfig, shape: InputShape, use_pariskv: bool = True,
               remat: bool = True):
    """(FLOPs of the whole step over every rank, note): counted on meta
    tensors; None with the reason where the step cannot be counted."""
    params = params_spec(cfg)
    ins = input_specs(cfg, shape)
    if shape.kind == "train":
        return _count(lambda: loss_grads(params, cfg, ins, remat)), None
    if shape.kind == "prefill":
        return _count(lambda: SV.prefill(
            params, cfg, ins["tokens"], shape.seq_len, device=META,
            media=ins.get("media"))), None
    if use_pariskv:
        return None, PARISKV_FLOPS_NOTE
    state = SV.ServeState(
        SV.make_caches(cfg, shape.global_batch, shape.seq_len, META),
        SV.regions_init(shape.global_batch, META))
    try:
        return _count(lambda: SV.decode_step(params, cfg, ins["token"],
                                             state, use_pariskv=False)), None
    except RuntimeError as exc:
        return None, (f"not counted: the baseline's decode step does not "
                      f"run on meta tensors ({exc})")


def _period(cfg: ModelConfig, si: int) -> List[int]:
    """The indices in ``params["layers"]`` of stage ``si``'s first
    period."""
    return [j for j, (s, r, _) in enumerate(layer_places(cfg))
            if s == si and r == 0]


def _grad_leaves(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def body_costs(cfg: ModelConfig, shape: InputShape,
               remat: bool = True) -> Dict[str, Any]:
    """FLOPs of one period of each stage of ``layer_plan`` with its
    repeat, and of the parts outside the stages (repeat 1), for train and
    prefill; the whole step's count; asserts whole == Σ repeat × body.
    A train body runs the period's ``layer_fwd_train`` (under
    ``torch.utils.checkpoint`` with remat) on a (b, s, d) input that
    requires grad, as every layer's input does in the step, and takes the
    gradient of its output's sum (and the aux loss) with respect to the
    period's params and its input (and whisper's encoder output); a
    prefill body runs the period's ``_layer_prefill`` into meta caches."""
    if shape.kind not in ("train", "prefill"):
        raise ValueError(f"bodies are counted for train and prefill, not "
                         f"{shape.kind}")
    params = params_spec(cfg)
    ins = input_specs(cfg, shape)
    b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
    dt = torch_dtype(cfg)
    positions = torch.arange(s, device=META).expand(b, s)
    media = ins.get("media")
    enc_out = None
    if cfg.family == "audio":
        enc_out = torch.empty((b, cfg.encoder_seq, d), device=META)
    bodies = []
    if shape.kind == "train":
        whole = _count(lambda: loss_grads(params, cfg, ins, remat))
        enc_keys = ("encoder", "enc_final_norm")
        head = {k: v for k, v in params.items() if k not in enc_keys}
        head["layers"] = []
        bodies.append(dict(stage="embed, unembed, loss", repeat=1,
                           flops=_count(lambda: loss_grads(
                               head, cfg, {k: v for k, v in ins.items()
                                           if k != "media"}, remat))))
        if enc_out is not None:
            enc = _grad_leaves({k: params[k] for k in enc_keys})

            def encoder():
                out = encoder_fwd(enc, cfg, media)
                torch.autograd.grad(out, tree_leaves(enc),
                                    torch.ones_like(out))
            bodies.append(dict(stage="the encoder", repeat=1,
                               flops=_count(encoder)))
        cross_media = media if enc_out is None else enc_out.requires_grad_()

        def train_body(si, ld_list):
            period = _grad_leaves([params["layers"][j]
                                   for j in _period(cfg, si)])
            x = torch.empty((b, s, d), dtype=dt,
                            device=META).requires_grad_()
            xx, aux = x, 0.0
            for ld, p in zip(ld_list, period):
                fwd = functools.partial(layer_fwd_train, ld=ld, cfg=cfg,
                                        positions=positions,
                                        media=cross_media)
                if remat:
                    xx, a = torch.utils.checkpoint.checkpoint(
                        fwd, p, xx, use_reentrant=False)
                else:
                    xx, a = fwd(p, xx)
                aux = aux + a
            obj = xx.float().sum() + cfg.router_aux_loss_coef * aux
            wrt = tree_leaves(period) + [x] + (
                [cross_media] if enc_out is not None else [])
            torch.autograd.grad(obj, wrt)
        body = train_body
    else:
        whole = _count(lambda: SV.prefill(params, cfg, ins["tokens"], s,
                                          device=META, media=media))
        bodies.append(dict(stage="embed, unembed" + (
            ", the encoder" if enc_out is not None else ""), repeat=1,
            flops=_count(lambda: SV.prefill(
                {**params, "layers": []}, cfg, ins["tokens"], s, device=META,
                media=media))))
        caches = SV.make_caches(cfg, b, s, META)
        signs = SV.rotation_signs(cfg, META)
        cross_media = media if enc_out is None else enc_out

        @torch.no_grad()
        def prefill_body(si, ld_list):
            x = torch.empty((b, s, d), dtype=dt, device=META)
            for ld, j in zip(ld_list, _period(cfg, si)):
                x = SV._layer_prefill(params["layers"][j], x, ld, cfg,
                                      positions, caches[j], signs, None,
                                      cross_media, None)
        body = prefill_body
    for si, stage in enumerate(layer_plan(cfg)):
        bodies.append(dict(stage=si, repeat=stage.repeat, flops=_count(
            functools.partial(body, si, stage.layers))))
    total = sum(x["repeat"] * x["flops"] for x in bodies)
    assert total == whole, (
        f"{cfg.name} × {shape.name}: Σ repeat × body = {total} FLOPs, the "
        f"whole step {whole}")
    return dict(arch=cfg.name, shape=shape.name, stages=bodies, flops=whole)


def plan_combo(arch: str, shape_name, mesh: MX.MeshShape, *,
               use_pariskv: bool = True, layouts=None, flops=None,
               capacity: Optional[int] = None,
               cfg: Optional[ModelConfig] = None) -> List[Dict[str, Any]]:
    """One record per layout (``gspmd`` for every kind; ``seq_shards`` and
    ``head_shards`` too for decode) of ``arch`` × ``shape_name`` on
    ``mesh``, built on meta (``shape_name``: an ``INPUT_SHAPES`` key or
    an ``InputShape``). ``flops``: (count, note) from
    ``step_flops``, shared by every mesh and layout (None: not counted);
    ``capacity``: a card's bytes, for ``fits``; ``cfg`` overrides the
    architecture's config (a cut depth)."""
    cfg = cfg or configs.get(arch)
    shape = (INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    if layouts is None:
        layouts = LAYOUTS if shape.kind == "decode" else ("gspmd",)
    params = params_spec(cfg)
    ins = input_specs(cfg, shape)
    out = []
    for layout in layouts:
        rec: Dict[str, Any] = dict(
            arch=arch, shape=shape.name, mesh=MX.mesh_tag(mesh),
            mesh_axes=list(mesh), chips=math.prod(mesh.values()),
            pariskv=use_pariskv, layout=layout)
        if flops is not None:
            rec["flops"], note = flops
            if note:
                rec["flops_note"] = note
        try:
            rec.update(_plan_layout(cfg, shape, mesh, layout, params, ins,
                                    use_pariskv))
        except _Refused as exc:
            rec.update(ok=False, refused=str(exc))
            out.append(rec)
            continue
        known = rec["memory"]["argument_bytes"] + rec.get("grad_bytes", 0)
        rec["known_bytes"] = known
        rec["fits"] = None if capacity is None else known <= capacity
        rec["fits_note"] = FITS_NOTE
        rec["ok"] = True
        out.append(rec)
    return out


class _Refused(Exception):
    """A layout the port refuses for this combination."""


def _plan_layout(cfg, shape, mesh, layout, params, ins,
                 use_pariskv) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if layout != "gspmd" and shape.kind != "decode":
        raise _Refused(f"the {layout} layout is a decode layout")
    parts: Dict[str, int] = {}
    outputs: Dict[str, int] = {}
    extra: Dict[str, Any] = {}
    if layout == "gspmd":
        p_specs = MX.params_sharding(params, mesh)
        parts["params"] = MX.rank_bytes(params, p_specs, mesh)
        in_specs = {k: MX.data_sharding(mesh, b, *v.shape[1:])
                    for k, v in ins.items()}
        parts["inputs"] = MX.rank_bytes(ins, in_specs, mesh)
        logits_spec = MX.data_sharding(mesh, b, cfg.vocab_size)
        if shape.kind == "train":
            opt = adamw_init(params)
            parts["opt"] = MX.rank_bytes(opt, MX.opt_sharding(opt, p_specs),
                                         mesh)
            outputs["state"] = parts["params"] + parts["opt"]
            outputs["metrics"] = 4 * 4
            # the gradients: params-shaped, laid out as the params
            extra["grad_bytes"] = MX.rank_bytes(params, p_specs, mesh)
        elif shape.kind == "prefill":
            caches = SV.make_caches(cfg, b, s, META)
            outputs["logits"] = MX.rank_bytes(_logits(cfg, b), logits_spec,
                                              mesh)
            outputs["caches"] = MX.rank_bytes(caches, MX.cache_sharding(
                caches, mesh, b), mesh)
            outputs["regions"] = MX.tree_bytes(SV.regions_init(b, META))
        else:
            caches = SV.make_caches(cfg, b, s, META)
            parts["caches"] = MX.rank_bytes(caches, MX.cache_sharding(
                caches, mesh, b), mesh)
            parts["regions"] = MX.tree_bytes(SV.regions_init(b, META))
            outputs["logits"] = MX.rank_bytes(_logits(cfg, b), logits_spec,
                                              mesh)
            outputs["state"] = parts["caches"] + parts["regions"]
        extra["layout_note"] = ("the reference's GSPMD plan on the port's "
                                "leaves: the port runs no GSPMD program")
        coll = None
        if shape.kind == "decode":
            coll = MX.collective_plan(cfg, "gather_cache", mesh, b, s)
            coll["note"] = ("all-gathering each ParisKV layer's sequence "
                            "shards, as the reference's GSPMD lowering of "
                            "the global gather does")
    elif layout == "seq_shards":
        why = _refusal(lambda: SV._check_seq_shard(cfg, None, use_pariskv,
                                                   None))
        caches = SV.make_caches(cfg, b, s, META)
        why = why or _refusal(lambda: MX.seq_shard_sharding(caches, mesh, b))
        if why:
            raise _Refused(why)
        ba = MX.batch_axes(mesh, b)
        parts["params"] = MX.tree_bytes(params)
        parts["caches"] = MX.rank_bytes(
            caches, MX.seq_shard_sharding(caches, mesh, b), mesh)
        regions = SV.regions_init(b, META)
        row = MX.Spec(ba)
        parts["regions"] = MX.rank_bytes(regions, type(regions)(row, row),
                                         mesh)
        parts["inputs"] = MX.rank_bytes(ins, {"token": row}, mesh)
        outputs["logits"] = MX.rank_bytes(_logits(cfg, b), MX.Spec(ba, None),
                                          mesh)
        outputs["state"] = parts["caches"] + parts["regions"]
        coll = MX.collective_plan(cfg, "seq_shards", mesh, b, s)
    else:                                     # head_shards
        shards = mesh["model"]
        why = _refusal(lambda: SV.check_paged_engine(
            cfg, shards, use_pariskv, s, CC.PAGED_DEFAULT_BLOCK))
        if why:
            raise _Refused(why)
        ba = MX.batch_axes(mesh, b)
        b_loc = b // MX._axes_size(mesh, ba)
        state = paged_state(cfg, b_loc, s, shards)
        parts["params"] = MX.tree_bytes(params)
        parts["state"] = MX.tree_bytes(state)
        parts["inputs"] = b_loc * 4
        outputs["logits"] = MX.tree_bytes(_logits(cfg, b_loc))
        outputs["state"] = parts["state"]
        coll = MX.collective_plan(cfg, "head_shards", mesh, b, s)
        extra.update(slots_per_rank=b_loc, block_size=CC.PAGED_DEFAULT_BLOCK,
                     num_blocks=b_loc * (s // CC.PAGED_DEFAULT_BLOCK))
    memory = dict(argument_bytes=sum(parts.values()),
                  output_bytes=sum(outputs.values()), temp_bytes=None,
                  peak_bytes=None)
    if shape.kind == "decode":
        extra["state_in_place"] = ("the decode step updates its caches and "
                                   "regions in place: output_bytes counts "
                                   "them as the reference's donated state")
    return dict(memory=memory, argument_parts=parts, output_parts=outputs,
                collectives=coll, **extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Plan each (architecture × input shape × mesh) on "
                    "meta tensors: per-rank bytes, FLOPs, collective bytes")
    ap.add_argument("--arch", default=None, choices=configs.ARCHS)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="the reference's --all: its ten architectures "
                         "× every input shape")
    ap.add_argument("--dense-baseline", action="store_true",
                    help="decode with full attention instead of ParisKV")
    ap.add_argument("--bodies", action="store_true",
                    help="per-stage FLOPs of one period, with its repeat")
    ap.add_argument("--gpus", action="append", default=[], metavar="D,M",
                    help="a GPU mesh (data=D, model=M) in place of the "
                         "production meshes; repeatable")
    ap.add_argument("--device", default=None,
                    help="where `fits` is judged: the card (default; "
                         "raises without one) or cpu (fits null)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    capacity = (torch.cuda.get_device_properties(dev).total_memory
                if dev.type == "cuda" else None)
    if not args.all and args.arch is None:
        ap.error("--arch (or --all) is required")
    archs = list(ALL_ARCHS) if args.all else [args.arch]
    shapes = (list(INPUT_SHAPES) if args.all or args.shape is None
              else [args.shape])
    results: List[Dict[str, Any]] = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    def save():
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    if args.bodies:
        if args.all:   # as the reference: prefill bodies are the slow ones
            shapes = [s for s in shapes if s != "prefill_32k"]
        shapes = [s for s in shapes if INPUT_SHAPES[s].kind != "decode"]
        done = {(r["arch"], r["shape"]) for r in results if "stages" in r}
        for arch in archs:
            for shape in shapes:
                if (arch, shape) in done:
                    continue
                print(f"=== bodies {arch} × {shape} ===", flush=True)
                rec = body_costs(configs.get(arch), INPUT_SHAPES[shape])
                print(json.dumps(rec["stages"]), flush=True)
                results.append(rec)
                save()
        return 0

    if args.gpus:
        meshes = [MX.gpu_mesh(*(int(x) for x in g.split(",")))
                  for g in args.gpus]
    elif args.all or args.both_meshes:
        meshes = [MX.production_mesh(), MX.production_mesh(multi_pod=True)]
    else:
        meshes = [MX.production_mesh(multi_pod=args.multipod)]
    pariskv = not args.dense_baseline
    done = {(r["arch"], r["shape"], r["mesh"], r.get("pariskv", True),
             r.get("layout", "gspmd")) for r in results
            if r.get("ok") or r.get("refused")}
    errors = 0
    for arch in archs:
        for shape in shapes:
            flops = None
            for mesh in meshes:
                tag = MX.mesh_tag(mesh)
                todo = [lay for lay in (
                    LAYOUTS if INPUT_SHAPES[shape].kind == "decode"
                    else ("gspmd",))
                    if (arch, shape, tag, pariskv, lay) not in done]
                if not todo:
                    continue
                print(f"=== {arch} × {shape} × {tag} ===", flush=True)
                t0 = time.time()
                try:
                    if flops is None:
                        flops = step_flops(configs.get(arch),
                                           INPUT_SHAPES[shape], pariskv)
                    recs = plan_combo(arch, shape, mesh,
                                      use_pariskv=pariskv, layouts=todo,
                                      flops=flops, capacity=capacity)
                except Exception as exc:
                    traceback.print_exc()
                    errors += 1
                    recs = [dict(arch=arch, shape=shape, mesh=tag,
                                 pariskv=pariskv, ok=False,
                                 error=str(exc)[-2000:])]
                for rec in recs:
                    rec["plan_s"] = round(time.time() - t0, 2)
                    if rec.get("ok"):
                        mem = rec["memory"]
                        print(f"  {rec['layout']:11s} rank GB "
                              f"{rec['known_bytes'] / 1e9:.3f} fits "
                              f"{rec['fits']} flops {rec.get('flops')}",
                              flush=True)
                    elif rec.get("refused"):
                        print(f"  {rec['layout']:11s} refused: "
                              f"{rec['refused']}", flush=True)
                results.extend(recs)
                save()
    n_ok = sum(1 for r in results if r.get("ok"))
    n_ref = sum(1 for r in results if r.get("refused"))
    print(f"dry-run complete: {n_ok}/{len(results)} OK, {n_ref} refused by "
          f"the port", flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
