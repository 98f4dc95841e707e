"""The check's two readings on the card, at each cell's own size: for
each seed, set the cell up, serve a window at the cell's own load, then
compare the served tokens with the float32 reference. The program has
to read within every limit of the cell; on the first three seeds the
reference in fp8, put in the program's place on the same prompts and
tokens, is read too and has to fail a limit. Each seed prints its
readings as one JSON line (PERF.md gives them, and the limits set from
them). At smoke size on the CPU fp8 rarely moves an argmax, so this test
needs the card.

    python3 -m pytest -m cuda -s portbench/tests/test_portbench_control.py"""
import gc
import json
import time

import pytest
import torch

from portbench.lib import check, driver, spec

CELLS = [w["name"] for w in spec.manifest()["workloads"]]
SEEDS = [2 ** 31 + 2027 + 1000 * i for i in range(12)]
CONTROL_SEEDS = SEEDS[:3]
WINDOW_S = 25.0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes_and_the_fp8_control_fails(cell, seed, card):
    c = spec.cell(cell)
    t = time.perf_counter()
    run = driver.Run(c, seed, card, t)
    try:
        run.setup()
        run.window(WINDOW_S, False)
        run.drain()
        run.close()
        picked = check.sample(run, c["check"]["sample"])
        if seed in CONTROL_SEEDS:
            got = check.control_numbers(run, picked)
        else:
            got = {"program": check.numbers(check.served_gaps(run, picked))}
        got.update(tokens=sum(len(p.tokens) for p in picked))
    finally:
        del run
        gc.unfreeze()               # set-up froze what it allocated
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(dict(cell=cell, seed=seed, seconds=time.perf_counter()
                          - t, **got)), flush=True)
    limits = c["check"]["limits"]
    assert all(got["program"][k] <= v for k, v in limits.items()), got
    if "control" in got:
        assert any(got["control"][k] > v for k, v in limits.items()), got
