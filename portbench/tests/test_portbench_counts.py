"""The frozen counts against counts by hand at smoke shapes, and the
decode schedule against the reference's."""
import pytest

from portbench.counts import work
from portbench.lib import spec, weights
from portbench.reference import pariskv as PK
from portbench.tests.smoke import smoke_config

PK_SMOKE = smoke_config("qwen2-1.5b")["pariskv"]


@pytest.mark.parametrize("L", [24, 40, 96, 300])
def test_region_matches_the_reference_schedule(L):
    steps = 200
    sched = PK.region_schedule(L, steps + 1, PK_SMOKE)
    for d in range(steps):
        enc, promotes = work.region(L, d, PK_SMOKE)
        assert enc == sched[d]
        assert promotes == (sched[d + 1] != sched[d])


def test_published_parameter_counts():
    """qwen2-1.5b's 1,543,714,304 parameters (tied embeddings)."""
    assert weights.count(spec.config("qwen2-1.5b")) == 1_543_714_304


def test_kernel_bytes_by_hand():
    """At smoke shapes: qwen2 smoke (G 2, Hg 2, hd 64 → B 8), n_max 256,
    batch 3, C = 32, k = 16, sink 8, W 48."""
    cfg = smoke_config("qwen2-1.5b")
    s = work.Shapes(cfg, 256, 3)
    assert (s.G, s.Hg, s.B, s.C, s.k, s.rng, s.nseg) == (2, 2, 8, 32, 16,
                                                          48, 1)
    regs = [100, 0, 10]
    ids = 110 * 2 * 8
    table = 3 * 2 * 2 * 8 * 256
    blk = 3 * 2 * 4 + 3 * 4
    out = 3 * 2 * 2 * (256 * 4 + 1 * 50 * 4)
    assert work.stage1_bytes(s, regs) == ids + table + blk + out
    hist = 3 * 2 * 2 * 1 * 50 * 4
    assert work.topc_bytes(s, regs) == hist + 2 * 256 * 4 * 4 + 3 * 4 * 32 * 4
    codes = (32 + 10) * 2 * 8 * 8
    assert work.stage2_bytes(s, regs) == (3 * 4 * 32 * 4 + codes
                                          + 3 * 4 * (64 + 1) * 4
                                          + 3 * 4 * (32 * 4 + 16 * 16))
    row = 64 * 2
    dense = 3 * (8 + 48) * 2 * row * 2
    wins = (16 + 10) * 2 * row * 2
    assert work.gather_bytes(s, regs) == 2 * dense + wins \
        + 3 * 2 * 2 * 16 * row * 2
    assert work.promote_gather_bytes(s) == 2 * 3 * 16 * 2 * 64 * 2


def test_decode_step_work_by_hand():
    cfg = smoke_config("qwen2-1.5b")
    s = work.Shapes(cfg, 256, 3)
    d, V, f = 256, 512, 512
    per_layer = 2 * d * 4 * 64 + 2 * d * 2 * 64 + 3 * d * f
    assert work.matmul_params(cfg) == 2 * per_layer + d * V
    # one row, prompt 96, first decode step: enc 64, pos 96, window
    # [64, 96] (33 keys), sink 8, winners min(16, 56)
    L, dd = 96, 0
    fl, by = work.decode_chunk(s, {"rows": [(L, dd, 1)], "steps": 1})
    keys = 8 + 16 + 33
    reg, C = 56, 32
    assert fl == 2 * work.matmul_params(cfg) + 4 * 4 * keys * 64 \
        + 2 * 2 * (reg * 8 + 2 * C * 8 * 8)
    assert by == weights_bytes(cfg) + keys * 2 * 64 * 2 * 2 + reg * 2 * 8 \
        + C * 2 * 8 * 8


def weights_bytes(cfg):
    """qwen2 smoke by hand: embedding (tied) and final norm, then per
    layer two norms, q/k/v/o, the biases and the MLP, 2 bytes each."""
    layer = 2 * 256 + 256 * 256 + 2 * 256 * 128 + 256 * 256 + 512 \
        + 3 * 256 * 512
    return 2 * (512 * 256 + 256 + 2 * layer)


def test_prefill_work_by_hand():
    cfg = smoke_config("qwen2-1.5b")
    fl, _ = work.prefill(cfg, 10)
    att = 2 * 4 * (64 + 64) * 55 * 2
    assert fl == 2 * work.matmul_params(cfg) * 10 + att
