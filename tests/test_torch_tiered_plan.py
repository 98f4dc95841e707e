"""The tiered gather's launch plan (``kernels/gather_kv/ops.py:tiered_plan``)
and its key-to-block rule, modelled plainly in ``kernels/gather_kv/ref.py``
(``tiered_roles``, ``gather_heads_tiered_plan_ref``), on the CPU: every
distinct missed (row, kv head) key has exactly one leader and all entries
of a key meet in one block; the blend and count built from the plan equal
the reference's (``repro/serving/offload.py:_dedup_heads_gather`` for the
misses, the staging pool for the staged rows) on a free slot's winners at
block 0, all missed, all staged and a degraded step; the plan fits an
H100 block's shared memory at every pageable config's (G, hd), at decode
and at a 1,048,576-token fill. Gathered rows and counts must be
identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: several test workers share few cores, and torch's
# spinning OpenMP pool would otherwise slow each of them many times over
torch.set_num_threads(1)

from repro.serving import offload as JO  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build as K  # noqa: E402
from repro_torch.kernels.gather_kv import gather_heads_tiered  # noqa: E402
from repro_torch.kernels.gather_kv import ops as GO  # noqa: E402
from repro_torch.kernels.gather_kv.ref import (  # noqa: E402
    FOLLOWER, LEADER, STAGED, ZERO, gather_heads_tiered_plan_ref,
    tiered_roles)
from repro_torch.models.serve import offload_support_reason  # noqa: E402

NB, BS, G, D, Q, KTOP = 24, 16, 2, 16, 3, 40
PLANS = [(1, 64), (3, 128), (66, 4096), (264, 4096)]  # (H, pass entries)


def _tier(seed, staged_blocks):
    """Host K/V rows (NB·BS, G, D) float32, a dev_map staging
    ``staged_blocks`` of the NB blocks, the staging pool holding them."""
    rng = np.random.RandomState(seed)
    host = rng.randn(2, NB * BS, G, D).astype(np.float32)
    dev_map = np.full((NB,), -1, np.int32)
    staged = rng.permutation(NB)[:staged_blocks]
    dev_map[staged] = np.arange(staged_blocks, dtype=np.int32)
    staging = np.zeros((2, max(staged_blocks, 1), BS, G, D), np.float32)
    staging[:, dev_map[staged]] = host.reshape(2, NB, BS, G, D)[:, staged]
    return host, dev_map, staging, rng


def _case(name):
    """Winner rows (b, G, Q, k) of one case, with repeats across query
    heads and batch rows, and its tier."""
    if name == "all_staged":
        host, dev_map, staging, rng = _tier(1, NB)
    elif name == "all_missed":
        host, dev_map, staging, rng = _tier(2, 0)
    else:
        host, dev_map, staging, rng = _tier(3, NB // 2)
    pick = rng.randint(0, NB * BS, size=(1, G, 25))
    rows = np.repeat(pick, 3, 0)[..., rng.randint(0, 25, size=(Q, KTOP))]
    rows[..., ::9] = -1
    if name == "free_slot":
        # a free slot's -1 table row sends its winners to block 0, which
        # the other slots' winners also pick; block 0 unstaged
        dev_map[0] = -1
        rows[2] = rng.randint(0, BS, size=(G, Q, KTOP))
        rows[0, :, 0, :6] = rng.randint(0, BS, size=(G, 6))
    if name == "degraded":
        # the fetch gave up: every missed winner at -1, the staged ones kept
        staged = dev_map[np.maximum(rows, 0) // BS] >= 0
        rows = np.where(staged, rows, -1)
    return host, dev_map, staging, rows.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _keys(rows, dev_map):
    missed = (rows >= 0) & (dev_map[np.maximum(rows, 0) // BS] < 0)
    keys = np.where(missed, rows * G + np.arange(G)[None, :, None, None], -1)
    return missed, keys


@pytest.mark.parametrize("H,pass_entries", PLANS)
@pytest.mark.parametrize("name", ["free_slot", "all_missed", "degraded"])
def test_every_missed_key_has_one_leader_in_one_block(name, H,
                                                      pass_entries):
    """Each distinct missed key has exactly one leader; every entry of a
    key lands in the block of its row's residue (phys % H), in the leader's
    pass or a later one; followers name their key's leader; zero and staged
    entries go to contiguous position ranges, one per block; the table
    slot (phys // H) of every key fits the plan's slots."""
    _, dev_map, _, rows = _case(name)
    plan = tiered_roles(_t(rows), _t(dev_map), BS, G, H, pass_entries)
    role, block, pas, leader = (plan[k].numpy() for k in
                                ("role", "block", "pass_", "leader"))
    missed, keys = _keys(rows, dev_map)
    assert np.array_equal(missed, (role == LEADER) | (role == FOLLOWER))
    assert np.array_equal(rows < 0, role == ZERO)
    assert np.array_equal((rows >= 0) & ~missed, role == STAGED)
    flat_keys, flat_role = keys.ravel(), role.ravel()
    for key in np.unique(flat_keys[flat_keys >= 0]):
        at = np.flatnonzero(flat_keys == key)
        assert (flat_role[at] == LEADER).sum() == 1, key
        lead = at[flat_role[at] == LEADER][0]
        assert set(block.ravel()[at]) == {(key // G) % H}
        assert (pas.ravel()[at] >= pas.ravel()[lead]).all()
        fol = at[flat_role[at] == FOLLOWER]
        assert (leader.ravel()[fol] == lead).all()
    assert (leader[role != FOLLOWER] == -1).all()
    # positions: kv head g's entries j = batch row · Q·k + position
    for g in range(G):
        pos = ~missed[:, g].reshape(-1)
        own = block[:, g].reshape(-1)[pos]
        assert (np.diff(own) >= 0).all() and ((0 <= own) & (own < H)).all()
    slots = GO.tiered_plan(NB * BS, G, blocks_per_head=H)["slots"]
    assert (rows[missed] // H < slots).all()
    if name != "degraded":
        assert len(np.unique(flat_keys[flat_keys >= 0])) < missed.sum()


@pytest.mark.parametrize("H,pass_entries", PLANS)
@pytest.mark.parametrize("name", ["free_slot", "all_missed", "all_staged",
                                  "degraded"])
def test_plan_blend_and_count_match_reference(name, H, pass_entries):
    """The blend built from the plan (zeros, staged rows, leaders from
    the host pool, followers from their leader's output) equals the
    reference's: staged rows from the staging pool, the misses through
    ``_dedup_heads_gather``, zeros for -1; its count (the leaders) is
    ``_dedup_heads_gather``'s distinct count, 0 on a degraded step. The
    port's plain wrapper agrees."""
    host, dev_map, staging, rows = _case(name)
    missed, _ = _keys(rows, dev_map)
    miss_rows = np.where(missed, rows, -1)
    want = [np.zeros(rows.shape + (D,), np.float32) for _ in range(2)]
    _, uniq = JO._dedup_heads_gather(host[0], host[1], miss_rows, *want)
    phys = np.maximum(rows, 0)
    s = dev_map[phys // BS]
    resident = (rows >= 0) & (s >= 0)
    g = np.arange(G)[None, :, None, None]
    for i in (0, 1):
        hit = staging[i].reshape(-1, G, D)[np.maximum(s, 0) * BS
                                           + phys % BS, g]
        want[i] = np.where(resident[..., None], hit, want[i])
    args = (_t(staging[0]), _t(staging[1]), _t(host[0]), _t(host[1]),
            _t(dev_map), _t(rows))
    k, v, distinct = gather_heads_tiered_plan_ref(*args, H, pass_entries)
    np.testing.assert_array_equal(k.numpy(), want[0])
    np.testing.assert_array_equal(v.numpy(), want[1])
    assert distinct == uniq
    assert (uniq == 0) == (name in ("all_staged", "degraded"))
    count = torch.zeros((1,), dtype=torch.int64)
    got = gather_heads_tiered(*args, count)
    assert torch.equal(got[0], k) and torch.equal(got[1], v)
    assert int(count) == distinct


def _pageable():
    out = []
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        if offload_support_reason(cfg) is None:
            out.append((arch, cfg.num_kv_heads, cfg.head_dim))
    return out


@pytest.mark.parametrize("host_rows", [65_536, 1_048_576, 8 * 1_048_576])
def test_plan_fits_shared_memory_at_every_pageable_config(host_rows):
    """At every config the offloaded engine serves (G from 2 to 32, head
    rows of 128, 256 and 512 bytes in bf16), over a pool of 65,536 rows
    (the kernel phase's), one 1,048,576-token context and eight: the
    block's shared memory fits an H100's 227 KB, the grid spans the card
    (a block per SM at least), the table never holds more than its cap,
    and a 1,048,576-token fill's prefix read (one batch row of 1,048,576
    entries a kv head) stays under 2^31 entries."""
    seen = _pageable()
    assert {G for _, G, _ in seen} >= {2, 32}
    assert {hd * 2 for *_, hd in seen} == {128, 256, 512}
    for arch, G_, hd in seen:
        for sms in (132, 114):
            plan = GO.tiered_plan(host_rows, G_, sms)
            H = plan["blocks_per_head"]
            assert plan["smem_bytes"] <= K.MAX_SMEM, (arch, plan)
            assert G_ * H >= sms and H < 2 ** 31 and G_ < 65_536
            assert plan["slots"] <= GO.TIERED_MAX_SLOTS
            assert plan["slots"] * H >= host_rows
            assert plan["pass_entries"] == GO.TIERED_THREADS * GO.TIERED_PASS
        assert G_ * 1_048_576 < 2 ** 31, arch
