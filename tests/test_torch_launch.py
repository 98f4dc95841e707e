"""The capacity planner (``repro_torch/launch/{mesh,dryrun,hillclimb}.py``)
against the reference's sharding rules and the port's real structures, on
the CPU; every count exact.

* Rules, at full width for all twelve architectures on the meshes (16,
  16), (2, 16, 16), (1, 4), (2, 4) and (1, 8), for each ``fsdp`` and
  ``cache_seq_axis`` value: every port leaf's ``shard_shape`` equals the
  reference's ``NamedSharding(AbstractMesh, spec).shard_shape`` of its
  stacked counterpart, less the leading axis, for params, AdamW's moments,
  every ``INPUT_SHAPES`` entry's inputs and the decode caches at
  decode_32k and long_500k; a rank's bytes are equal too. The
  reference's trees come from ``jax.eval_shape`` and ``make_caches(...,
  as_spec=True)``; its ``launch.dryrun`` (which forces 512 host devices
  through ``XLA_FLAGS`` at import) runs only in a subprocess, for its
  ``input_specs``.
* Bytes, at smoke size: the planner's equal the real CPU params, caches,
  each rank's ``seq_shard_state`` of a 2-shard cut and the pool of a
  head-sharded rank; its head-shard refusals are the engine's.
* Collectives: in a 2-rank gloo ``decode_step(dist=SeqShardDist)`` and
  one head-sharded engine step on qwen2 smoke, the bytes passing through
  ``all_gather_shards``, ``all_reduce_sum`` and ``all_gather_heads``
  (counted by wrapping them) equal ``collective_plan``'s, and the
  engine's state bytes the planner's.
* FLOPs: meta equal real CPU tensors for train and prefill at smoke
  size, and Σ repeat × body equals the whole step.
* The CLIs: ``python -m repro_torch.launch.dryrun`` writes its records
  with ``--device cpu`` and raises without a card otherwise; the
  hillclimb's E1 and E2 run on the CPU."""
import concurrent.futures
import functools
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores
torch.set_num_threads(1)

# JAX and the reference are imported inside the helpers that use them: the
# spawned ranks import this module and should start without them
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core.config import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.distributed import (SeqShardDist, ShardDist,  # noqa: E402
                                     launch_local)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hillclimb as H  # noqa: E402
from repro_torch.launch import mesh as MX  # noqa: E402
from repro_torch.models import serve as TSV  # noqa: E402
from repro_torch.models.model import layer_places  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.models.train import loss_grads  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.serving import PagedServingEngine, Request  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((1, 4), ("data", "model")), ((2, 4), ("data", "model")),
          ((1, 8), ("data", "model"))]
KNOBS = ("auto", "all", "none", "model", "data")
CACHE_SHAPES = ("decode_32k", "long_500k")
SMOKE_B, SMOKE_N = 2, 128         # smoke batch rows and n_max (a block)
RANK_PROMPT = 40                  # the gloo ranks' prompt tokens
TIMEOUT_S = 60.0

_REF_INPUTS = r"""
import json
from repro import configs
from repro.core.config import INPUT_SHAPES
from repro.launch.dryrun import input_specs
print(json.dumps({a: {s: {k: [list(v.shape), v.dtype.name] for k, v in
                          input_specs(configs.get(a),
                                      INPUT_SHAPES[s]).items()}
                      for s in INPUT_SHAPES} for a in configs.ARCHS}))
"""


def _reference_paths(tree, cfg, caches=False):
    """Each tensor leaf of a port tree → its counterpart in the
    reference's tree: (its path there, the index on the stacked leading
    axis or None). Params: ``layers/<j>/...`` is ``stages/<si>/l<i>/...``
    at index r (``model.layer_places``), ``encoder/<j>/...`` is
    ``encoder/...`` at index j; moments keep their ``mu/`` or ``nu/``
    prefix. Caches: ``<j>/...`` is ``<si>/l<i>/...`` at index r."""
    places = layer_places(cfg)

    def one(path):
        parts = path.split("/")
        head = []
        if parts[0] in ("mu", "nu"):
            head, parts = parts[:1], parts[1:]
        if caches:
            si, r, i = places[int(parts[0])]
            return "/".join(head + [str(si), f"l{i}"] + parts[1:]), r
        if parts[0] == "layers":
            si, r, i = places[int(parts[1])]
            return "/".join(head + ["stages", str(si), f"l{i}"]
                            + parts[2:]), r
        if parts[0] == "encoder":
            return "/".join(head + ["encoder"] + parts[2:]), int(parts[1])
        return "/".join(head + parts), None
    return {path: one(path) for path, _ in MX.tree_paths(tree)}


# ------------------------------------------------------- gloo ranks (c) ----
def _collective_rank(rank):
    """One rank of the 2-rank gloo run: a sequence-sharded decode step and
    a head-sharded engine step on qwen2 smoke, every collective's bytes
    recorded by wrapping the dist methods."""
    torch.set_num_threads(1)
    cfg = TC.smoke("qwen2-1.5b")
    params = init_params(cfg, seed=0, device="cpu")
    calls = {"seq": [], "head": []}
    gather, reduce_, heads = (SeqShardDist.all_gather_shards,
                              SeqShardDist.all_reduce_sum,
                              ShardDist.all_gather_heads)

    def nb(t):
        return t.numel() * t.element_size()

    def gather_w(self, x):
        out = gather(self, x)
        calls["seq"].append(("all_gather_shards", nb(x), nb(out)))
        return out

    def reduce_w(self, x):
        out = reduce_(self, x)
        calls["seq"].append(("all_reduce_sum", nb(x), nb(out)))
        return out

    def heads_w(self, x, dim):
        out = heads(self, x, dim)
        calls["head"].append(("all_gather_heads", nb(x), nb(out)))
        return out
    SeqShardDist.all_gather_shards = gather_w
    SeqShardDist.all_reduce_sum = reduce_w
    ShardDist.all_gather_heads = heads_w

    rng = np.random.RandomState(3)
    tokens = rng.randint(0, cfg.vocab_size, size=(SMOKE_B, RANK_PROMPT))
    _, st = TSV.prefill(params, cfg, tokens.astype(np.int32), SMOKE_N,
                        device="cpu")
    d = SeqShardDist.from_process_group(2)
    st = TSV.seq_shard_state(st, d)
    cache_bytes = MX.tree_bytes(st.caches)
    TSV.decode_step(params, cfg, torch.zeros((SMOKE_B,), dtype=torch.int32),
                    st, dist=d)

    eng = PagedServingEngine(cfg, params, n_max=SMOKE_N, max_batch=SMOKE_B,
                             block_size=16, chunk_size=1, mesh_shards=2,
                             device="cpu")
    eng.start()
    state_bytes = MX.tree_bytes(eng._state)
    eng.submit(Request(uid=0, prompt=tokens[0, :20].astype(np.int32),
                       max_new_tokens=3))
    eng.step_serve()
    return dict(calls=calls, cache_bytes=cache_bytes,
                state_bytes=state_bytes, decode_steps=eng.decode_steps)


@pytest.fixture(scope="module", autouse=True)
def started():
    """The gloo ranks and the reference's ``input_specs`` subprocess, both
    started before the module's first test and read by the tests that
    need them."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    ref = subprocess.Popen([sys.executable, "-c", _REF_INPUTS], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    with concurrent.futures.ThreadPoolExecutor(1) as threads:
        ranks = threads.submit(launch_local, _collective_rank, 2, "gloo",
                               TIMEOUT_S)
        yield dict(ref=ref, ranks=ranks)
        if ref.poll() is None:
            ref.kill()
        ref.communicate()


@pytest.fixture(scope="module")
def ref_inputs(started):
    out, err = started["ref"].communicate(timeout=120)
    assert started["ref"].returncode == 0, err[-2000:]
    return json.loads(out)


# ------------------------------------------------------------- rules (a) ----
@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    import jax
    from repro import configs as JC
    from repro.models import model as JM
    from repro.optim import adamw_init as j_adamw_init
    p = jax.eval_shape(lambda k: JM.init_params(JC.get(arch), k),
                       jax.random.PRNGKey(0))
    return p, jax.eval_shape(j_adamw_init, p)


def _meshes():
    from jax.sharding import AbstractMesh
    for shape, names in MESHES:
        yield AbstractMesh(shape, names), dict(zip(names, shape))


def _flat(tree, is_leaf=None):
    import jax
    from repro.launch import mesh as JX
    return {JX._path_str(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _check_tree(cfg, port, port_specs, ref, ref_shard, mesh, caches=False):
    """Every port leaf against its reference counterpart: its shape (the
    stacked leaf's less the leading axis), its dtype's size and its shard
    shape; then a rank's bytes over the whole tree."""
    from jax.sharding import NamedSharding
    ref_leaves = _flat(ref)
    shards = _flat(ref_shard, lambda x: isinstance(x, NamedSharding))
    spec_of = MX.spec_paths(port_specs)
    places = _reference_paths(port, cfg, caches=caches)
    wants = {p: shards[p].shard_shape(leaf.shape)
             for p, leaf in ref_leaves.items()}
    for path, t in MX.tree_paths(port):
        rp, r = places[path]
        leaf = ref_leaves[rp]
        want, shape = wants[rp], tuple(leaf.shape)
        if r is not None:
            assert r < shape[0], (path, rp)
            want, shape = want[1:], shape[1:]
        assert tuple(t.shape) == shape, (path, rp, t.shape, shape)
        assert t.element_size() == leaf.dtype.itemsize, (path, t.dtype)
        got = MX.shard_shape(tuple(t.shape), spec_of[path], mesh)
        assert got == tuple(want), (path, spec_of[path], got, want)
    ref_bytes = sum(math.prod(wants[p]) * leaf.dtype.itemsize
                    for p, leaf in ref_leaves.items())
    assert MX.rank_bytes(port, port_specs, mesh) == ref_bytes


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_params_and_moments_shard_as_the_reference(arch, monkeypatch):
    from repro.launch import mesh as JX
    cfg = TC.get(arch)
    ref_p, ref_opt = _ref_params(arch)
    params = D.params_spec(cfg)
    opt = adamw_init(params)
    for am, mesh in _meshes():
        for fsdp in (True, False):
            monkeypatch.setenv("REPRO_FSDP", "1" if fsdp else "0")
            ref_ps = JX.params_sharding(ref_p, am, "pod" in am.axis_names)
            ref_os = JX.opt_sharding(ref_opt, ref_ps, am)
            specs = MX.params_sharding(params, mesh, fsdp=fsdp)
            _check_tree(cfg, params, specs, ref_p, ref_ps, mesh)
            _check_tree(cfg, opt, MX.opt_sharding(opt, specs), ref_opt,
                        ref_os, mesh)


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_decode_caches_shard_as_the_reference(arch, monkeypatch):
    from repro import configs as JC
    from repro.launch import mesh as JX
    from repro.models import serve as JS
    cfg = TC.get(arch)
    for name in CACHE_SHAPES:
        b, n = INPUT_SHAPES[name].global_batch, INPUT_SHAPES[name].seq_len
        ref = JS.make_caches(JC.get(arch), b, n, as_spec=True)
        caches = TSV.make_caches(cfg, b, n, D.META)
        for am, mesh in _meshes():
            for knob in KNOBS:
                monkeypatch.setenv("REPRO_CACHE_SEQ_AXIS", knob)
                try:
                    ref_shard = JX.cache_sharding(ref, am, b)
                except Exception as exc:  # one mesh axis on two dimensions
                    assert type(exc).__name__ == "DuplicateSpecError"
                    with pytest.raises(ValueError, match="more than one"):
                        MX.cache_sharding(caches, mesh, b, knob)
                    continue
                _check_tree(cfg, caches,
                            MX.cache_sharding(caches, mesh, b, knob), ref,
                            ref_shard, mesh, caches=True)


def test_inputs_shard_as_the_reference(ref_inputs):
    from repro.launch import mesh as JX
    for arch in TC.ARCHS:
        cfg = TC.get(arch)
        for name, shape in INPUT_SHAPES.items():
            ins = D.input_specs(cfg, shape)
            want = ref_inputs[arch][name]
            assert {k: [list(v.shape), str(v.dtype).split(".")[-1]]
                    for k, v in ins.items()} == want, (arch, name)
            for am, mesh in _meshes():
                for k, v in ins.items():
                    ref = JX.data_sharding(am, shape.global_batch,
                                           *v.shape[1:])
                    spec = MX.data_sharding(mesh, shape.global_batch,
                                            *v.shape[1:])
                    assert MX.shard_shape(tuple(v.shape), spec, mesh) == \
                        tuple(ref.shard_shape(tuple(v.shape))), (arch, k)
                    # JAX writes a one-axis tuple as the axis alone
                    assert tuple(spec) == tuple(
                        (e,) if isinstance(e, str) else e for e in ref.spec
                    ) + (None,) * (v.dim() - len(ref.spec))


def test_shard_shape_refuses_an_uneven_split():
    mesh = MX.gpu_mesh(2, 4)
    assert MX.shard_shape((8, 12), MX.Spec("data", "model"), mesh) == (4, 3)
    assert MX.shard_shape((8, 12), MX.Spec(("data", "model")), mesh) == \
        (1, 12)
    with pytest.raises(ValueError, match="does not split"):
        MX.shard_shape((6, 12), MX.Spec(("data", "model")), mesh)
    # a dimension smaller than its axes stays whole, as the reference's
    # _divisible keeps it
    assert MX.param_spec("wq", (1, 12), mesh) == \
        MX.Spec(None, "model")


# ------------------------------------------------------------- bytes (b) ----
@pytest.mark.parametrize("arch", TC.ARCHS)
def test_planner_bytes_equal_real_structures(arch):
    cfg = TC.smoke(arch)
    params = init_params(cfg, seed=0, device="cpu")
    meta = D.params_spec(cfg)
    assert [(p, t.shape, t.dtype) for p, t in MX.tree_paths(meta)] == \
        [(p, t.shape, t.dtype) for p, t in MX.tree_paths(params)]
    caches = TSV.make_caches(cfg, SMOKE_B, SMOKE_N, "cpu")
    mcaches = TSV.make_caches(cfg, SMOKE_B, SMOKE_N, D.META)
    assert MX.tree_bytes(mcaches) == MX.tree_bytes(caches)

    # each rank of a 2-shard sequence cut, against seq_shard_state's, leaf
    # by leaf
    mesh = MX.gpu_mesh(1, 2)
    specs = MX.seq_shard_sharding(mcaches, mesh, SMOKE_B)
    want = MX.rank_bytes(mcaches, specs, mesh)
    spec_of = MX.spec_paths(specs)
    shapes = {p: MX.shard_shape(tuple(t.shape), spec_of[p], mesh)
              for p, t in MX.tree_paths(mcaches)}
    state = TSV.ServeState(caches, TSV.regions_init(SMOKE_B, "cpu"))
    for r in range(2):
        cut = TSV.seq_shard_state(state, SeqShardDist(r, 2)).caches
        assert {p: tuple(t.shape) for p, t in MX.tree_paths(cut)} == shapes
        assert MX.tree_bytes(cut) == want
    recs = {r["layout"]: r for r in D.plan_combo(
        arch, InputShape("smoke", SMOKE_N, SMOKE_B, "decode"), mesh,
        cfg=cfg)}
    assert recs["seq_shards"]["argument_parts"]["caches"] == want
    parts = recs["seq_shards"]["argument_parts"]
    assert parts["params"] == MX.tree_bytes(params)

    # a head-sharded rank's pool, or the engine's own refusal
    refusal = recs["head_shards"].get("refused")
    if refusal is None:
        pool = TSV.init_paged_slot_state(
            cfg, SMOKE_B, SMOKE_B, SMOKE_N, device="cpu",
            n_max=SMOKE_N, dist=ShardDist(0, 2))
        assert recs["head_shards"]["argument_parts"]["state"] == \
            MX.tree_bytes(pool)
    else:
        with pytest.raises((ValueError, NotImplementedError)) as exc:
            PagedServingEngine(cfg, params, n_max=SMOKE_N,
                               max_batch=SMOKE_B, block_size=16,
                               mesh_shards=2, device="cpu")
        assert refusal == f"{type(exc.value).__name__}: {exc.value}"


def test_train_fits_counts_the_gradients():
    """``fits`` judges a train step's arguments and its gradients, which
    the params' layout gives: a card between the two does not fit."""
    mesh = MX.gpu_mesh(1, 1)
    rec, = D.plan_combo("qwen2-1.5b", "train_4k", mesh)
    params = D.params_spec(TC.get("qwen2-1.5b"))
    grads = MX.rank_bytes(params, MX.params_sharding(params, mesh), mesh)
    arg = rec["memory"]["argument_bytes"]
    assert rec["grad_bytes"] == grads == rec["argument_parts"]["params"]
    assert rec["known_bytes"] == arg + grads
    assert rec["fits"] is None and rec["fits_note"] == D.FITS_NOTE
    rec, = D.plan_combo("qwen2-1.5b", "train_4k", mesh, capacity=arg)
    assert rec["fits"] is False
    rec, = D.plan_combo("qwen2-1.5b", "train_4k", mesh,
                        capacity=arg + grads)
    assert rec["fits"] is True


def test_seq_shards_refuse_as_the_port():
    cfg = TC.smoke("qwen2-1.5b")
    recs = {r["layout"]: r for r in D.plan_combo(
        "qwen2-1.5b", InputShape("odd", 63, 1, "decode"),
        MX.gpu_mesh(1, 2), cfg=cfg)}
    assert "must be a multiple of 2" in recs["seq_shards"]["refused"]
    base = {r["layout"]: r for r in D.plan_combo(
        "qwen2-1.5b", InputShape("smoke", SMOKE_N, 1, "decode"),
        MX.gpu_mesh(1, 2), cfg=cfg, use_pariskv=False)}
    assert "full-attention baseline" in base["seq_shards"]["refused"]
    assert "ParisKV path only" in base["head_shards"]["refused"]


# ------------------------------------------------------- collectives (c) ----
def test_collective_plan_equals_the_counted_bytes(started):
    cfg = TC.smoke("qwen2-1.5b")
    ranks = started["ranks"].result()
    mesh = MX.gpu_mesh(1, 2)
    layers = sum(TSV.pool_layers(cfg))
    seq = MX.collective_plan(cfg, "seq_shards", mesh, SMOKE_B, SMOKE_N)
    per = seq["per_layer_step"]
    want = [("all_gather_shards", per["all_gather_scores"]["send"],
             per["all_gather_scores"]["recv"]),
            ("all_gather_shards", per["all_gather_positions"]["send"],
             per["all_gather_positions"]["recv"]),
            ("all_reduce_sum", per["all_reduce_rows"]["bytes"],
             per["all_reduce_rows"]["bytes"])] * layers
    mcaches = TSV.make_caches(cfg, SMOKE_B, SMOKE_N, D.META)
    head = MX.collective_plan(cfg, "head_shards", mesh, SMOKE_B, SMOKE_N)
    hper = head["per_layer_step"]["all_gather_heads"]
    for rk in ranks:
        assert [tuple(c) for c in rk["calls"]["seq"]] == want
        assert sum(c[2] for c in rk["calls"]["seq"]) == seq["total_per_step"]
        assert rk["cache_bytes"] == MX.rank_bytes(
            mcaches, MX.seq_shard_sharding(mcaches, mesh, SMOKE_B), mesh)
        assert rk["decode_steps"] == 1
        assert [tuple(c) for c in rk["calls"]["head"]] == \
            [("all_gather_heads", hper["send"], hper["recv"])] * layers
        assert rk["state_bytes"] == MX.tree_bytes(D.paged_state(
            cfg, SMOKE_B, SMOKE_N, 2, block_size=16))


# ------------------------------------------------------------- FLOPs (d) ----
@pytest.mark.parametrize("kind", ("train", "prefill"))
@pytest.mark.parametrize("arch", ("whisper-large-v3", "deepseek-v2-lite-16b",
                                  "hymba-1.5b"))
def test_meta_flops_equal_cpu_flops(arch, kind):
    cfg = TC.smoke(arch)
    shape = InputShape("smoke", 32, 1, kind)
    meta, note = D.step_flops(cfg, shape)
    assert note is None and meta > 0
    params = init_params(cfg, seed=0, device="cpu")
    ins = {k: torch.zeros(v.shape, dtype=v.dtype)
           for k, v in D.input_specs(cfg, shape).items()}
    if kind == "train":
        cpu = D._count(lambda: loss_grads(params, cfg, ins))
    else:
        cpu = D._count(lambda: TSV.prefill(params, cfg, ins["tokens"], 32,
                                           device="cpu",
                                           media=ins.get("media")))
    assert cpu == meta
    bodies = D.body_costs(cfg, shape)          # asserts whole == Σ
    assert bodies["flops"] == meta
    stages = [b for b in bodies["stages"] if isinstance(b["stage"], int)]
    assert [b["repeat"] for b in stages] == [
        st.repeat for st in TSV.layer_plan(cfg)]


def _dense_train_flops(cfg, b, s, remat):
    """qwen2's train step by hand, independent of ``FlopCounterMode``: a
    matmul of m × k by k × n is 2mkn FLOPs forward and twice that
    backward (the input's gradient and the weight's). A layer's matmuls
    are its projections (d × (H + 2G)·hd, H·hd × d) and its MLP (3 · d ×
    d_ff) over b·s tokens, and the two attention products (q·kᵀ and p·v,
    2·b·H·s²·hd each: at s ≤ 1024 the blockwise attention runs one
    (s, s) tile whole, its masked half included). The unembedding (the
    tied d × vocab) runs forward and backward once. Remat recomputes a
    layer's forward in the backward pass up to its last activation that
    the backward keeps (``torch.utils.checkpoint``'s early stop): all but
    the MLP's output product."""
    d, H, G, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tokens = b * s
    mm = d * (H + 2 * G) * hd + H * hd * d + 3 * d * cfg.d_ff
    layer = 2 * tokens * mm + 2 * 2 * b * H * s * s * hd
    per_layer = 3 * layer
    if remat:
        per_layer += layer - 2 * tokens * cfg.d_ff * d
    return cfg.num_layers * per_layer + 3 * 2 * tokens * d * cfg.vocab_size


@pytest.mark.parametrize("size,b,s,remat", [
    ("smoke", 2, 32, True), ("smoke", 2, 32, False),
    ("full", 4, 1024, True)])       # the train phase's step on the card
def test_train_flops_equal_a_count_by_hand(size, b, s, remat):
    cfg = (TC.smoke if size == "smoke" else TC.get)("qwen2-1.5b")
    assert cfg.tie_embeddings and cfg.family == "dense"
    flops, note = D.step_flops(cfg, InputShape("hand", s, b, "train"),
                               remat=remat)
    assert note is None
    assert flops == _dense_train_flops(cfg, b, s, remat)


def test_decode_flops_notes():
    shape = InputShape("smoke", SMOKE_N, SMOKE_B, "decode")
    assert D.step_flops(TC.smoke("qwen2-1.5b"), shape) == (
        None, D.PARISKV_FLOPS_NOTE)
    flops, note = D.step_flops(TC.smoke("qwen2-1.5b"), shape,
                               use_pariskv=False)
    assert flops > 0 and note is None
    # hymba's hybrid layers retrieve in the baseline too: not on meta
    flops, note = D.step_flops(TC.smoke("hymba-1.5b"), shape,
                               use_pariskv=False)
    assert flops is None and "meta" in note


# --------------------------------------------------------------- CLIs (e) ----
def test_dryrun_cli_writes_its_record(tmp_path):
    out = tmp_path / "plan.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-1.5b", "--shape", "decode_32k", "--device", "cpu", "--out",
         str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    recs = {r["layout"]: r for r in json.loads(out.read_text())}
    assert sorted(recs) == sorted(D.LAYOUTS)
    # 16 ranks cannot split qwen2's 2 KV heads
    assert not recs["head_shards"]["ok"]
    assert "must divide num_kv_heads=2" in recs["head_shards"]["refused"]
    for r in (recs["gspmd"], recs["seq_shards"]):
        assert r["ok"] and r["mesh"] == "16x16" and r["chips"] == 256
        assert r["memory"]["temp_bytes"] is None
        assert r["memory"]["peak_bytes"] is None
        assert r["fits"] is None and r["flops"] is None
    cfg = TC.get("qwen2-1.5b")
    mesh = MX.production_mesh()
    meta = D.params_spec(cfg)
    assert recs["gspmd"]["argument_parts"]["params"] == MX.rank_bytes(
        meta, MX.params_sharding(meta, mesh), mesh)
    assert recs["seq_shards"]["collectives"] == MX.collective_plan(
        cfg, "seq_shards", mesh, 128, 32768)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k"])


def test_hillclimb_e1_e2(tmp_path):
    out = tmp_path / "hc.json"
    assert H.main(["--exp", "e2", "--gpus", "1,4", "--device", "cpu",
                   "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    one = {(r["mesh"], r["case"]): r for r in recs if r["layers"] == 1}
    # gathering the cache leaves a rank every shard of the layer: the
    # distributed fetch's shard times the shards
    for mesh in ("16x16", "1x4"):
        fetch = one[(mesh, "seq_shards")]
        gather = one[(mesh, "gather_cache")]
        assert gather["cache_bytes"] == fetch["cache_bytes"] * fetch["shards"]
        assert fetch["collective_bytes"] < gather["collective_bytes"]
        assert fetch["t_link_ms"] is None
