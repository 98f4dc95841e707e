"""The comparison that decides ``correct`` catches a broken timed path:
a whole smoke-size run (the harness's look for a card skipped) with the
program broken underneath reads ``correct`` false, once for each fault
a serving cell can have: a step that returns its state unchanged
(positions never advance), half of the batch left out (its rows get the
other half's logits), and the served token altered where it is
produced. (No cell spans chips: there is no exchange to leave out.)

One fault touches only the later part of a request's positions, where
the worst request's median gap can stay under its limit and the mean gap
has to catch it: promotions that stop after each row's first (the region
end never advances again). The run decodes 200 tokens a request, so
that the later positions feel it."""
import time

import pytest
import torch

from portbench import run as R
from portbench.lib import spec
from portbench.tests.smoke import smoke_cell
from repro_torch.core import cache as CC
from repro_torch.models import serve as SV

CELLS = [w["name"] for w in spec.manifest()["workloads"]]


def _unchanged(monkeypatch):
    """decode_step hands back the state it was given: positions and
    region ends never advance."""
    orig = SV.decode_step

    def stale(params, cfg, token, state, *a, **k):
        logits, _ = orig(params, cfg, token, state, *a, **k)
        return logits, state
    monkeypatch.setattr(SV, "decode_step", stale)


def _half_batch(monkeypatch):
    orig = SV.decode_step

    def half(params, cfg, token, state, *a, **k):
        logits, new = orig(params, cfg, token, state, *a, **k)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = logits[0]      # rows never computed
        return logits, new
    monkeypatch.setattr(SV, "decode_step", half)


def _altered(monkeypatch):
    orig = SV.decode_chunk

    def alter(params, cfg, state, *a, **k):
        toks, st = orig(params, cfg, state, *a, **k)
        return torch.where(toks >= 0, (toks + 1) % cfg.vocab_size, toks), st
    monkeypatch.setattr(SV, "decode_chunk", alter)


def _promotions_stop(monkeypatch):
    """Each batch row promotes once; its later triggers are dropped."""
    orig = CC.promote_trigger
    done = {}

    def trigger(regions, pcfg):
        t = orig(regions, pcfg)
        seen = done.setdefault(t.shape[0], torch.zeros_like(t))
        out = t & ~seen
        seen |= t
        return out
    monkeypatch.setattr(CC, "promote_trigger", trigger)


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
          "token_altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_reads_incorrect(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = R.run_cell(smoke_cell(cell), 2 ** 31 + 7, 1.0, False, "cpu",
                     time.perf_counter())
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_promotions_that_stop_read_incorrect(cell, monkeypatch):
    c = smoke_cell(cell)
    c["traffic"]["output_tokens"]["value"] = 200
    c["engine"]["args"].update(n_max=512, num_blocks=128)
    _promotions_stop(monkeypatch)
    res = R.run_cell(c, 2 ** 31 + 7, 3.0, False, "cpu", time.perf_counter())
    chk = res["checks"]
    assert not res["correct"], chk
    assert (chk["worst_request_mean_gap"]["value"]
            > chk["worst_request_mean_gap"]["limit"]), chk
