"""Sharded serving's process groups: the port's counterpart of the
reference's ``ShardedPagedDist`` (``repro/models/serve.py``) and of the 1-D
KV-head mesh it runs under (``jax.make_mesh`` plus ``shard_map``), and of
the sequence mesh of its contiguous decode (``decode_step(dist=(mesh,
seq_axes, batch_axes))``).

``PagedServingEngine(mesh_shards=N)`` runs SPMD in each of the N ranks of a
``torch.distributed`` process group. Rank r owns KV heads
``head_range(G)``; the only collective on the decode and fill paths is
``all_gather_heads``, a tiled concatenation of the ranks' attention-output
heads in rank order with no float reduction, so every rank's tokens are a
single device's.

``decode_step(..., dist=SeqShardDist)`` runs SPMD in each rank of a group
of N over the contiguous caches of a one-device ``prefill``, cut by
``models.serve.seq_shard_state``: rank r holds the positions [r·n_loc, (r+1)·n_loc) of
every ParisKV store (n_loc = n_max / N), everything else whole. Its
collectives per ParisKV layer-step are one ``all_gather_shards`` of the
local winners' scores, one of their positions and one ``all_reduce_sum``
of the K/V rows (``models/layers.py:distributed_retrieve_fetch``).

Backends: ``"nccl"`` when every rank has a card of its own, ``"gloo"`` when
ranks share a card or run on the CPU (``backend_for``). Gloo gathers host
tensors only, so a gloo group stages a card's tensors through host memory.

``launch_local`` spawns the ranks of one host (tests, ``chip_smoke.py``);
the serving CLI runs under ``torchrun``.
"""
from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _check_group(name: str, shards: int) -> int:
    """The rank of this process in the default process group, which must
    hold exactly ``shards`` ranks (``name``: the option that asked)."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"{name}={shards} needs a torch.distributed process "
            f"group of {shards} ranks: launch with torchrun "
            f"--nproc-per-node {shards}, or call "
            f"torch.distributed.init_process_group in every rank")
    world = dist.get_world_size()
    if world != shards:
        raise ValueError(
            f"{name}={shards} but the process group holds {world} "
            f"ranks: launch with torchrun --nproc-per-node {shards} or "
            f"init_process_group(world_size={shards})")
    return dist.get_rank()


def _to_host(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` where the group's backend can read it: gloo moves host
    tensors only, so a card's tensor is staged through host memory."""
    return x.cpu() if dist.get_backend(group) == "gloo" else x


def _gather_stacked(x: torch.Tensor, shards: int, group) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis in rank order: the
    bytes move as they are, so no value changes on the way."""
    raw = _to_host(x.contiguous(), group).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(shards)]
    dist.all_gather(parts, raw, group=group)
    return torch.stack(parts).view(x.dtype).to(x.device)


class ShardDist(NamedTuple):
    """One rank's view of the KV-head shards: its ``rank``, the number of
    ``shards`` and the process ``group`` (None: the default group)."""
    rank: int
    shards: int
    group: Optional[object] = None

    @classmethod
    def from_process_group(cls, shards: int) -> "ShardDist":
        """This rank's view of the default process group, which must hold
        exactly ``shards`` ranks."""
        return cls(_check_group("mesh_shards", shards), shards)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def head_range(self, num_kv_heads: int) -> Tuple[int, int]:
        """[g0, g1): the KV heads this rank owns (its query heads are
        g·Hg + j for g in that range)."""
        per = num_kv_heads // self.shards
        return self.rank * per, (self.rank + 1) * per

    def all_gather_heads(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order (the
        reference's tiled ``all_gather``): the bytes move as they are, so
        no value changes on the way."""
        out = _gather_stacked(x.movedim(dim, 0), self.shards, self.group)
        return out.flatten(0, 1).movedim(0, dim).contiguous()

    def all_gather_bytes(self, data: bytes) -> List[bytes]:
        """Every rank's ``data`` (equal lengths), in rank order."""
        t = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        if self.backend != "gloo":
            t = t.to(torch.device("cuda", torch.cuda.current_device()))
        parts = [torch.empty_like(t) for _ in range(self.shards)]
        dist.all_gather(parts, t, group=self.group)
        return [bytes(p.cpu().numpy()) for p in parts]

    def ranks_differing(self, data: bytes) -> List[int]:
        """The ranks whose ``data`` differs from rank 0's (a SHA-256 digest
        of each is gathered)."""
        got = self.all_gather_bytes(hashlib.sha256(data).digest())
        return [r for r, d in enumerate(got) if d != got[0]]


class SeqShardDist(NamedTuple):
    """One rank's view of the sequence shards of a contiguous cache: its
    ``rank``, the number of ``shards`` and the process ``group`` (None:
    the default group). The rank holds the positions ``rows(n_max)`` of
    every ParisKV store."""
    rank: int
    shards: int
    group: Optional[object] = None

    @classmethod
    def from_process_group(cls, shards: int) -> "SeqShardDist":
        """This rank's view of the default process group, which must hold
        exactly ``shards`` ranks."""
        return cls(_check_group("seq_shards", shards), shards)

    def rows(self, n_max: int) -> Tuple[int, int]:
        """(base, n_loc): this rank holds the positions [base, base +
        n_loc) of an ``n_max``-position store."""
        if n_max % self.shards:
            raise ValueError(f"n_max={n_max} does not split into "
                             f"{self.shards} sequence shards: n_max must be "
                             f"a multiple of {self.shards}")
        n_loc = n_max // self.shards
        return self.rank * n_loc, n_loc

    def shard_of(self, n_loc: int) -> Tuple[int, int]:
        """(base, n_max) of this rank's store of ``n_loc`` positions: the
        ``shard`` of ``cache.decode_append`` and ``cache.promote_rows``."""
        return self.rank * n_loc, n_loc * self.shards

    def all_gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked on a new leading axis in rank order
        (the reference's untiled ``all_gather``), bytes as they are."""
        return _gather_stacked(x, self.shards, self.group)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of every rank's ``x`` (the reference's
        ``psum``)."""
        buf = _to_host(x.contiguous(), self.group)
        if buf is x:
            buf = x.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf.to(x.device)


def backend_for(world_size: int, device) -> str:
    """The backend for ``world_size`` ranks serving on ``device``: NCCL
    when every rank can have a card of its own, gloo when ranks share a
    card (NCCL refuses two ranks on one device) or run on the CPU."""
    dev = torch.device(device)
    if (dev.type == "cuda" and torch.cuda.is_available()
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


class RankError(RuntimeError):
    """A rank of ``launch_local`` raised, died or outlived its bound."""


def _rank_main(fn, rank: int, world_size: int, backend: str, store: str,
               timeout_s: float, args: tuple, results) -> None:
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        results.put((rank, "joined", None))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        # by value: a tensor sent through the queue as shared memory would
        # die with this process before the parent maps it
        results.put((rank, "done", pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 — the parent raises it
        results.put((rank, "raised", traceback.format_exc()))


def _failures(results, failed: dict, grace_s: float = 2.0) -> str:
    """Every failure report that arrives within ``grace_s`` of the first
    (a rank's error often makes its peers' collectives fail too, and the
    cause may arrive second), by rank."""
    end = time.monotonic() + grace_s
    while time.monotonic() < end:
        try:
            rank, kind, payload = results.get(
                timeout=max(end - time.monotonic(), 0.01))
        except queue_lib.Empty:
            break
        if kind == "raised":
            failed[rank] = payload
    return "\n".join(f"rank {r} raised:\n{failed[r]}" for r in sorted(failed))


def launch_local(fn: Callable, world_size: int, backend: str,
                 timeout_s: float = 120.0, args: tuple = ()) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes of this
    host, each a rank of one ``backend`` process group (a file store in a
    fresh temporary directory). ``fn`` must be importable by name (a
    module-level function) and return something picklable (tensors travel
    by value); it sets its own CUDA device.

    Two bounds: the start — spawning, each rank's import of ``fn``'s
    module and the rendezvous — must end within ``max(60, timeout_s)``
    seconds (also the group's collective timeout), and the ranks must all
    return within ``timeout_s`` of the moment the last of them joined the
    group.

    → the ranks' results in rank order. Raises ``RankError`` with the
    tracebacks of the ranks that raised as soon as one rank raises, at the
    start or in ``fn`` (and its peers' within two seconds), or dies, and
    when either bound passes; every rank still running is killed first, so
    no rank outlives the call."""
    start_s = max(60.0, timeout_s)
    print(f"launch_local: {world_size} ranks, backend {backend}", flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend,
                               os.path.join(tmp, "store"), start_s, args,
                               results))
             for r in range(world_size)]
    joined, out = set(), {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + start_s
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                if len(joined) < world_size:
                    late = sorted(set(range(world_size)) - joined)
                    raise RankError(f"ranks {late} did not join the group "
                                    f"within {start_s} s")
                late = sorted(set(range(world_size)) - set(out))
                raise RankError(f"ranks {late} did not finish within "
                                f"{timeout_s} s")
            try:
                rank, kind, payload = results.get(timeout=min(left, 0.5))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RankError(f"rank {dead[0]} died (exit code "
                                    f"{procs[dead[0]].exitcode}) without a "
                                    f"result")
                continue
            if kind == "raised":
                raise RankError(_failures(results, {rank: payload}))
            if kind == "joined":
                joined.add(rank)
                if len(joined) == world_size:  # fn's clock starts here
                    deadline = time.monotonic() + timeout_s
                continue
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.pid is None:                # never started
                continue
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
