"""The plain reference against the port's CPU path at smoke size. Only
this test imports both."""
import time

import numpy as np
import pytest
import torch

from portbench.lib import spec
from portbench.reference import pariskv as PK
from portbench.tests.smoke import smoke_cell, smoke_config
from repro_torch.core import encode as E
from repro_torch.core import quantizer, retrieval, srht
from repro_torch.core.config import ParisKVConfig

CELLS = [w["name"] for w in spec.manifest()["workloads"]]


def _pcfg(pk):
    pk = dict(pk)
    pk["tier_weights"] = tuple(pk["tier_weights"])
    pk["tier_pcts"] = tuple(pk["tier_pcts"])
    return ParisKVConfig(**pk)


@pytest.mark.parametrize("dim", [64, 128])
def test_rotation_and_codes_match_the_port(dim):
    pk = spec.config("qwen2-1.5b")["pariskv"]
    idx = PK.Index(pk, dim, "cpu")
    cfg = _pcfg(pk)
    signs = torch.from_numpy(srht.rademacher_signs(idx.dp, cfg.srht_seed))
    g = torch.Generator().manual_seed(dim)
    keys = torch.randn((300, dim), generator=g)
    ref_rot = srht.srht_rotate(keys / keys.norm(dim=-1, keepdim=True), signs)
    assert torch.allclose(idx.split(keys).reshape(300, -1), ref_rot,
                          atol=2e-6)
    ids, summary = idx.encode(keys)
    meta = E.encode_keys(keys, cfg, signs)
    assert torch.equal(ids, meta.centroid_ids.long())
    v = quantizer.decode_directions(meta.codes, cfg.m, cfg.magnitude_bits)
    want = (meta.weights[..., None] * v).reshape(300, -1)
    # the rotation's rounding (a product here, butterflies there) moves a
    # coordinate across a magnitude threshold now and then
    off = ~torch.isclose(summary, want, rtol=1e-5, atol=1e-6)
    assert off.float().mean() < 1e-3


def test_lloyd_max_levels_match_the_port():
    thr, lv = PK._lloyd_max(3, 8)
    t2, l2 = quantizer.lloyd_max_levels(8, 3)
    assert np.array_equal(thr, t2) and np.array_equal(lv, l2)


@pytest.mark.parametrize("n_valid", [5, 40, 700])
def test_winners_match_the_port(n_valid):
    pk = smoke_config("qwen2-1.5b")["pariskv"]
    cfg = _pcfg(pk)
    D, n, Hg = 64, 760, 3
    idx = PK.Index(pk, D, "cpu")
    signs = torch.from_numpy(srht.rademacher_signs(idx.dp, cfg.srht_seed))
    g = torch.Generator().manual_seed(n_valid)
    keys = torch.randn((n, D), generator=g)
    q = torch.randn((Hg, D), generator=g)
    sink = pk["sink_size"]
    enc_end = sink + n_valid
    C = PK.candidate_count(pk, n)
    meta = E.encode_keys(keys[None, None], cfg, signs)        # (1, 1, n, B)
    qt = E.encode_query(q[None, None], cfg, signs)
    res = retrieval.retrieve(meta.centroid_ids, meta.codes, meta.weights, qt,
                             torch.tensor([enc_end], dtype=torch.int32), cfg,
                             C, pk["top_k"])
    port = res.indices[0, 0]                                   # (Hg, k)
    ids, summ = idx.encode(keys[sink:enc_end])
    mine = PK.Index.winners(idx, q, ids, summ, n_valid, C, pk["top_k"])
    k = min(pk["top_k"], n_valid)
    for h in range(Hg):
        valid = port[h][(port[h] >= sink) & (port[h] < enc_end)]
        assert sorted(valid.tolist())[:k] == sorted((mine[h] + sink).tolist())


@pytest.mark.parametrize("cell", CELLS)
def test_smoke_cell_serves_the_references_tokens(cell):
    """The whole run at smoke size in float32: the port's served tokens
    are the reference's argmax at every compared position."""
    from portbench import run as R
    res = R.run_cell(smoke_cell(cell), 2 ** 31 + 99, 1.0, False, "cpu",
                     time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["checks"]["worst_request_median_gap"]["value"] == 0.0
    assert res["checks"]["tokens_compared"]["value"] >= 20
