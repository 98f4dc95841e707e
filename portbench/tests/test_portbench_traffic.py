"""The traffic generator: seeded, deterministic, and true to each traffic
file's parameters."""
import numpy as np
import pytest

from portbench.lib import spec, traffic

CELLS = [w["name"] for w in spec.manifest()["workloads"]]


def _requests(cell, seed, n):
    c = spec.cell(cell)
    gen = traffic.Traffic(c["traffic"], seed, c["config"]["vocab_size"])
    return c, gen, [gen.next() for _ in range(n)]


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_requests(cell):
    _, _, a = _requests(cell, 2 ** 31 + 12345, 40)
    _, _, b = _requests(cell, 2 ** 31 + 12345, 40)
    _, _, c = _requests(cell, 2 ** 31 + 12346, 40)
    assert all(np.array_equal(p, q) and m == n
               for (p, m), (q, n) in zip(a, b))
    assert any(not np.array_equal(p, q) for (p, _), (q, _) in zip(a, c))


@pytest.mark.parametrize("cell", CELLS)
def test_requests_follow_the_traffic_file(cell):
    c, gen, reqs = _requests(cell, 7, 300)
    t = c["traffic"]
    pre = t["shared_prefix_tokens"]
    assert gen.clients == t["clients"]
    for prompt, out in reqs:
        assert prompt.dtype == np.int32
        assert 0 <= prompt.min() and prompt.max() < c["config"]["vocab_size"]
        assert np.array_equal(prompt[:pre], reqs[0][0][:pre])
        for key, n in (("prompt_tokens", len(prompt) - pre),
                       ("output_tokens", out)):
            d = t[key]
            if d["dist"] == "fixed":
                assert n == d["value"]
            else:
                assert d["lo"] <= n <= d["hi"]
        # every request fits the engine's positions
        assert len(prompt) + out <= c["engine"]["args"]["n_max"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_gets_the_same_sizes(cell):
    """A round of ``sizes`` requests has the same lengths for every seed,
    in another order."""
    c = spec.cell(cell)
    n = c["traffic"]["sizes"]
    got = []
    for seed in (1, 2 ** 32 + 5):
        gen = traffic.Traffic(c["traffic"], seed, c["config"]["vocab_size"])
        reqs = [gen.next() for _ in range(n)]
        got.append((sorted(len(p) for p, _ in reqs),
                    sorted(o for _, o in reqs), [len(p) for p, _ in reqs]))
    assert got[0][0] == got[1][0] and got[0][1] == got[1][1]
    if c["traffic"]["prompt_tokens"]["dist"] != "fixed":
        assert got[0][2] != got[1][2]          # another order


def test_loguniform_grid_is_log_spaced():
    g = traffic.grid({"dist": "loguniform", "lo": 256, "hi": 2048}, 256)
    assert g[0] >= 256 and g[-1] <= 2048
    assert abs(np.exp(np.log(g).mean()) - np.sqrt(256 * 2048)) < 10
