"""Mesh shapes and sharding rules (port of ``repro/launch/mesh.py``).

The reference lays its params, optimizer state, batches and decode caches
over a 2-D FSDP×TP device mesh by name rules (row-parallel matmuls
(fsdp, model), column-parallel (model, fsdp), experts (None, fsdp, model),
vectors replicated), and its decode caches by leaf kind: the retrieval
region (K/V and metadata) sharded by sequence over ``model``, or over
every axis when the batch cannot split (long_500k). The port applies the
same rules to its own leaves, shapes only, for the capacity planner
(``launch.dryrun``, ``launch.hillclimb``):

* a mesh is a ``MeshShape``, a plain dict of axis name to size in the
  mesh's order: the reference's production meshes ``{"data": 16,
  "model": 16}`` and ``{"pod": 2, "data": 16, "model": 16}``, or a GPU
  mesh ``{"data": d, "model": m}``;
* a spec is a tuple with one entry per dimension: ``None``, an axis name,
  or a tuple of axis names (``jax.sharding.PartitionSpec``'s entries);
* ``shard_shape`` and ``rank_bytes`` give one rank's shapes and bytes.

The port keeps one dict per layer where the reference stacks a stage's
layers on a leading axis (``models/model.py:layer_places`` maps one tree
onto the other), so a port leaf takes the spec of its stacked counterpart
without the leading ``None``, the divisibility check applied to its own
dimensions, as the reference's ``_maybe`` applies it. The reference's
environment knobs ``REPRO_FSDP`` and ``REPRO_CACHE_SEQ_AXIS`` are the
keyword arguments ``fsdp`` and ``cache_seq_axis``.

Beside the reference's rules, the port's two runnable decode layouts:
``seq_shard_sharding`` (``models/serve.py:seq_shard_state``: the ParisKV
stores cut by position, everything else whole) and, in
``launch.dryrun``, the head-sharded paged pool. ``collective_plan``
reckons the bytes of the port's collectives a layer-step, in place of the
reference's ``collective_bytes``, which reads XLA's HLO text.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core import cache as CC
from repro_torch.core.config import ModelConfig
from repro_torch.distributed import SeqShardDist
from repro_torch.models.model import torch_dtype
from repro_torch.models.serve import pool_layers

Axes = Any                      # None | str | tuple of str
MeshShape = Dict[str, int]      # axis name → size, in the mesh's order


class Spec(tuple):
    """One leaf's layout: an entry per dimension, None (whole), an axis
    name or a tuple of names (``jax.sharding.PartitionSpec``'s entries).
    A tuple of its own type, so a tree of specs never mistakes a pair of
    leaves for one spec."""

    def __new__(cls, *entries: Axes):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


def mesh_tag(mesh: MeshShape) -> str:
    """The sizes joined by "x", as the reference's records name a mesh
    ("16x16", "2x16x16")."""
    return "x".join(str(v) for v in mesh.values())


def production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production meshes (``make_production_mesh``): 256
    chips (data=16, model=16), or 512 with a leading ``pod`` axis."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def gpu_mesh(data: int, model: int) -> MeshShape:
    """``data`` × ``model`` cards: the batch over ``data``, the tensor-,
    sequence- or head-parallel axis ``model``."""
    return {"data": data, "model": model}


def fsdp_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def _axes_size(mesh: MeshShape, axes: Axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh[a] for a in axes)


def _divisible(dim: int, mesh: MeshShape, axes: Axes) -> bool:
    if axes is None:
        return True
    size = _axes_size(mesh, axes)
    return dim % size == 0 and dim >= size


def _maybe(spec_axes, shape, mesh: MeshShape) -> Spec:
    """Drop sharding on axes that do not divide evenly (the reference
    prefers explicit replication to XLA's padding). A mesh axis left on
    two dimensions raises, as ``NamedSharding`` refuses such a spec."""
    spec = Spec(*(ax if _divisible(dim, mesh, ax) else None
                  for dim, ax in zip(shape, spec_axes)))
    used = [a for ax in spec if ax is not None
            for a in ((ax,) if isinstance(ax, str) else ax)]
    if len(used) != len(set(used)):
        raise ValueError(f"spec {tuple(spec)} maps a mesh axis to more than "
                         f"one dimension of {tuple(shape)}")
    return spec


# --------------------------------------------------------------- params ----
_ROW = re.compile(r"(wq|wk|wv|wi_gate|wi_up|w_in|w_dkv|w_uk|w_uv|unembed)$")
_COL = re.compile(r"(wo|wo_mlp|w_out)$")


def param_spec(path: str, shape: Tuple[int, ...], mesh: MeshShape,
               fsdp: bool = True) -> Spec:
    """Name-rule FSDP×TP spec for one per-layer parameter: its stacked
    counterpart's spec without the leading None (``fsdp=False``: pure TP,
    the reference's ``REPRO_FSDP=0``). The FSDP axes take in ``pod`` when
    the mesh has one, as ``batch_axes`` does."""
    fs = fsdp_axes("pod" in mesh) if fsdp else None
    name = path.split("/")[-1]
    nd = len(shape)
    if name == "embed":
        core: Tuple = ("model", fs)
    elif _ROW.search(name) and nd == 2:
        core = (fs, "model")
    elif _COL.search(name) and nd == 2:
        core = ("model", fs)
    elif name.startswith("experts_down"):
        core = (None, "model", fs)
    elif name.startswith("experts_"):
        core = (None, fs, "model")
    elif name == "router":
        core = (fs, None)
    elif name == "conv_w":
        core = (None, "model")
    elif name in ("bq", "bk", "bv", "conv_b") and nd == 1:
        core = ("model",)
    else:  # norms, gates, scalars, small vectors → replicate
        core = (None,) * nd
    core = tuple(core) + (None,) * (nd - len(core))
    return _maybe(core, shape, mesh)


# ---------------------------------------------------------------- trees ----
def _is_leaf(x) -> bool:
    return isinstance(x, torch.Tensor)


def _walk(tree, is_leaf, path: str = ""):
    """(path, leaf) for every leaf of a tree of dicts, lists, tuples and
    NamedTuples, in order; a path joins dict keys, list and tuple indices
    and NamedTuple field names with "/" (the reference's ``_path_str``).
    Anything else is skipped (a cache entry's tags, host counters)."""
    if is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, is_leaf, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(names, tree):
            yield from _walk(v, is_leaf, f"{path}/{k}" if path else str(k))


def tree_paths(tree) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor leaf of ``tree`` (``_walk``)."""
    return list(_walk(tree, _is_leaf))


def spec_paths(specs) -> Dict[str, "Spec"]:
    """path → spec of a tree of ``Spec`` leaves (``tree_paths``'s
    paths)."""
    return dict(_walk(specs, lambda x: isinstance(x, Spec)))


def _map_paths(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over the tensor leaves of ``tree``, keeping its
    structure (NamedTuples stay NamedTuples); None at other leaves."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        items = [_map_paths(fn, v, f"{path}/{k}" if path else str(k))
                 for k, v in zip(names, tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return None


def params_sharding(params, mesh: MeshShape, fsdp: bool = True):
    """The spec tree mirroring the port's params (tensors on any device,
    ``"meta"`` included), ``param_spec`` at every leaf."""
    return _map_paths(lambda path, leaf: param_spec(
        path, tuple(leaf.shape), mesh, fsdp=fsdp), params)


def opt_sharding(opt, params_specs):
    """AdamW's ``mu`` and ``nu`` inherit the param specs; ``step``
    replicates (an ``optim.AdamWState`` of specs)."""
    return type(opt)(Spec(), params_specs, params_specs)


# ---------------------------------------------------------- activations ----
def batch_axes(mesh: MeshShape, global_batch: int):
    """Axes to shard the batch dim over; None when the batch is too small
    (long_500k) — sequence sharding takes over instead."""
    fs = fsdp_axes("pod" in mesh)
    size = _axes_size(mesh, fs)
    return fs if global_batch % size == 0 and global_batch >= size else None


def data_sharding(mesh: MeshShape, global_batch: int, *extra_dims: int
                  ) -> Spec:
    """Spec for (batch, ...) host data."""
    return Spec(batch_axes(mesh, global_batch), *(None,) * len(extra_dims))


_META = ("meta_ids", "meta_codes", "meta_w")


def _cache_seq_axes(mesh: MeshShape, ba, cache_seq_axis: str):
    """(batch axes, sequence axes) of the decode caches for the
    reference's ``REPRO_CACHE_SEQ_AXIS`` value ``cache_seq_axis``."""
    if cache_seq_axis == "auto":
        return ba, (tuple(mesh) if ba is None else "model")
    if cache_seq_axis == "all":
        return None, tuple(mesh)
    if cache_seq_axis == "none":
        return ba, None
    if cache_seq_axis in ("model", "data"):
        return ba, cache_seq_axis
    raise ValueError(f"cache_seq_axis={cache_seq_axis!r}: one of auto, all, "
                     f"none, model, data")


def cache_leaf_spec(path: str, shape: Tuple[int, ...], mesh: MeshShape,
                    ba, seq_ax) -> Spec:
    """The reference's decode-cache rule for one port cache leaf. The
    reference tells leaf kinds by the rank of its stacked (L, b, ...)
    leaves; a port leaf is one layer's, so its reference rank is one
    more than its own:

      (L, b, n, G, hd)   k/v store, ring, media K/V → seq on axis 2
      (L, b, G, n, B)    metadata                   → seq on axis 3
      (L, b, n, r)       MLA latent                 → seq on axis 2
      (L, b, h, p, n)    SSM state                  → heads on 'model'
      (L, b, w, c)       conv ring                  → shard c

    The spec drops the leading L; axes that do not divide are dropped."""
    if not shape:
        return Spec()
    rank = len(shape) + 1
    meta = path.split("/")[-1] in _META
    if "ssm" in path and rank == 5:
        core: Tuple = (ba, "model", None, None)
    elif "ssm" in path and rank == 4:
        core = (ba, None, "model")
    elif rank == 5:
        core = (ba, None, seq_ax, None) if meta else (ba, seq_ax, None, None)
    elif rank == 4:
        core = (ba, None, seq_ax) if meta else (ba, seq_ax, None)
    elif rank == 3:
        core = (ba, None)
    else:
        core = (None,) * len(shape)
    return _maybe(core, shape, mesh)


def cache_sharding(caches, mesh: MeshShape, global_batch: int,
                   cache_seq_axis: str = "auto"):
    """Decode-cache specs over the port's contiguous caches
    (``models.serve.make_caches``): sequence dims over 'model' (batch over
    data), or over every axis when the batch cannot shard (long_500k);
    ``cache_seq_axis`` is the reference's ``REPRO_CACHE_SEQ_AXIS`` (auto,
    all, none, model, data)."""
    ba, seq_ax = _cache_seq_axes(mesh, batch_axes(mesh, global_batch),
                                 cache_seq_axis)
    return _map_paths(lambda path, leaf: cache_leaf_spec(
        path, tuple(leaf.shape), mesh, ba, seq_ax), caches)


def _seq_layout(mesh: MeshShape, global_batch: int):
    """(batch axes, sequence axes, shards) of the port's sequence-sharded
    decode on ``mesh``: the reference's ``REPRO_DIST_RETRIEVAL`` split,
    the sequence over 'model' with the batch over the FSDP axes, or over
    every axis when the batch cannot split."""
    ba = batch_axes(mesh, global_batch)
    seq = ("model",) if ba is not None else tuple(mesh)
    return ba, seq, _axes_size(mesh, seq)


def seq_shard_sharding(caches, mesh: MeshShape, global_batch: int):
    """Specs of the port's sequence-sharded decode
    (``models.serve.seq_shard_state``, ``decode_step(dist=SeqShardDist)``):
    every ParisKV store's K, V and metadata cut by position over the
    sequence axes; rings, media K/V, SSM state and MLA latents whole (their
    batch rows split over the batch axes, as every leaf's). Raises the
    port's ``ValueError`` when n_max does not split into the shards."""
    ba, seq, shards = _seq_layout(mesh, global_batch)

    def rows(_, t):
        return Spec(ba, *(None,) * (t.dim() - 1))

    def entry(lc: dict):
        kv = lc.get("kv")
        out = {k: _map_paths(rows, v) for k, v in lc.items() if k != "kv"}
        if isinstance(kv, CC.LayerKVCache):
            SeqShardDist(0, shards).rows(kv.k.shape[1])
            out["kv"] = CC.LayerKVCache(
                Spec(ba, seq, None, None), Spec(ba, seq, None, None),
                *(Spec(ba, None, seq, None),) * 3)
        elif kv is not None:
            out["kv"] = _map_paths(rows, kv)
        return out
    return [entry(lc) for lc in caches]


# ----------------------------------------------------------------- bytes ----
def shard_shape(shape: Tuple[int, ...], spec: Spec,
                mesh: MeshShape) -> Tuple[int, ...]:
    """One rank's block of a ``shape`` laid out by ``spec`` (missing
    trailing entries replicate), as ``NamedSharding.shard_shape`` gives
    it; raises where a sharded dimension does not divide."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        size = _axes_size(mesh, ax)
        if dim % size:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split over {ax} ({size} ranks)")
        out.append(dim // size)
    return tuple(out)


def rank_bytes(tree, specs, mesh: MeshShape) -> int:
    """One rank's bytes of ``tree`` (tensors of any device, shapes only)
    laid out by ``specs`` (a tree of its structure)."""
    spec_of = spec_paths(specs)
    total = 0
    for path, t in tree_paths(tree):
        total += (math.prod(shard_shape(tuple(t.shape), spec_of[path], mesh))
                  * t.element_size())
    return total


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree``, whole."""
    return sum(t.numel() * t.element_size() for _, t in tree_paths(tree))


# ----------------------------------------------------------- collectives ----
def collective_plan(cfg: ModelConfig, layout: str, mesh: MeshShape,
                    batch: int, n_max: int) -> Dict[str, Any]:
    """The bytes one rank's collectives move per ParisKV layer and decode
    step, and over the step's ParisKV layers (``pool_layers``), for the
    port's layouts on ``mesh`` with ``batch`` rows (split over the batch
    axes where they divide it) of ``n_max`` positions:

    * ``"seq_shards"`` (``decode_step(dist=SeqShardDist)``,
      ``models/layers.py:distributed_retrieve_fetch``): two
      ``all_gather_shards`` of the local winners, float32 scores and
      int32 positions (b, G, Hg, k), and one ``all_reduce_sum`` of the
      float32 sink, window and winner K/V rows;
    * ``"head_shards"`` (``PagedServingEngine(mesh_shards=N)``): one
      ``ShardDist.all_gather_heads`` of the float32 attention output (b,
      H / N, hd) over N = mesh['model'] ranks;
    * ``"gather_cache"``: all-gathering the layer's K/V and metadata
      shards, sequence-sharded as ``seq_shards`` cuts them, what the
      reference's GSPMD lowering of the global gather does.

    An all-gather lists the bytes a rank sends and the bytes of its result
    (``recv``, every rank's part), an all-reduce its buffer; ``total`` sums
    the results, as the reference's ``collective_bytes`` sums result
    shapes. One rank (``shards`` 1) runs no collective, nor a model with no
    ParisKV layer (mamba2; deepseek's MLA latents stay whole)."""
    pcfg = cfg.pariskv
    ba, _, shards = _seq_layout(mesh, batch)
    b = batch // _axes_size(mesh, ba)
    layers = sum(pool_layers(cfg))
    G, hd = cfg.num_kv_heads, cfg.head_dim
    Hg = cfg.num_heads // G if layers else 0
    if layout == "seq_shards":
        winners = b * G * Hg * pcfg.top_k
        rows = b * ((pcfg.sink_size + CC.window_size(pcfg)) * G
                    + G * Hg * pcfg.top_k) * hd
        per = dict(
            all_gather_scores=dict(send=winners * 4,
                                   recv=winners * 4 * shards),
            all_gather_positions=dict(send=winners * 4,
                                      recv=winners * 4 * shards),
            all_reduce_rows=dict(bytes=rows * 2 * 4))
    elif layout == "head_shards":
        shards = mesh["model"]
        send = b * (cfg.num_heads // shards) * hd * 4
        per = dict(all_gather_heads=dict(send=send, recv=send * shards))
    elif layout == "gather_cache":
        whole = tree_bytes(CC.init_layer_cache(
            b, n_max, G, hd, pcfg, torch_dtype(cfg), torch.device("meta")))
        per = dict(all_gather_cache=dict(send=whole // shards, recv=whole))
    else:
        raise ValueError(f"layout={layout!r}: one of seq_shards, "
                         f"head_shards, gather_cache")
    if shards == 1 or not layers:
        per = {}            # one rank, or no ParisKV layer: no collective
    total = sum(v.get("recv", v.get("bytes", 0)) for v in per.values())
    return dict(layout=layout, shards=shards, batch_per_rank=b,
                per_layer_step=per, total_per_layer_step=total,
                layers=layers, total_per_step=total * layers)
