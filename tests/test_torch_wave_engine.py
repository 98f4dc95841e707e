"""The port's ``WaveServingEngine`` against the JAX reference's (equal
prompt lengths, right-aligned batched prefill with no ``lengths``, lockstep
decode; qwen2 smoke config, float32, ParisKV and the full-attention
baseline), and the serving CLI ``python -m repro_torch.launch.serve`` on
the CPU: slots, waves and the baseline each print one line per request
and the aggregate line. Token identity is held against the JAX engines,
not between slots and waves: the reference's own batch-vs-solo
promotion test fails."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import WaveServingEngine as JWave  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import SyntheticLMStream  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import Request, WaveServingEngine  # noqa: E402

CFG_J = dataclasses.replace(JC.smoke("qwen2-1.5b"), dtype="float32")
CFG_T = dataclasses.replace(TC.smoke("qwen2-1.5b"), dtype="float32")
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("use_pariskv", [True, False])
def test_wave_engine_tokens_match_reference(use_pariskv):
    """Three 48-token prompts, two per wave, 24 and 20 new tokens: the
    windows fill and promote mid-wave."""
    pj = jax.tree.map(lambda a: a * 8.0,
                      JM.init_params(CFG_J, jax.random.PRNGKey(5)))
    params = convert.params_from_jax(jax.device_get(pj), CFG_T, device="cpu")
    rng = np.random.RandomState(5)
    gens = [24, 20, 22]
    prompts = [rng.randint(0, CFG_J.vocab_size, size=(48,)).astype(np.int32)
               for _ in gens]
    runs = []
    for make, req, p, kw in ((JWave, JRequest, pj, {}),
                             (WaveServingEngine, Request, params,
                              {"device": "cpu"})):
        eng = make(CFG_J if make is JWave else CFG_T, p, n_max=128,
                   max_batch=2, use_pariskv=use_pariskv, **kw)
        for i, (prompt, gen) in enumerate(zip(prompts, gens)):
            eng.submit(req(uid=i, prompt=prompt, max_new_tokens=gen))
        runs.append({r.uid: r for r in eng.run()})
    want, got = runs
    for uid, gen in enumerate(gens):
        np.testing.assert_array_equal(got[uid].output, want[uid].output,
                                      err_msg=f"request {uid}")
        assert got[uid].output.shape == (gen,)
        assert got[uid].ttft_s > 0 and len(got[uid].token_times) == gen
    assert len(set(np.concatenate([r.output for r in got.values()]))) > 5
    assert eng.peak_concurrency == 2 and int(eng.nonfinite_logits) == 0


def test_synthetic_stream_matches_reference():
    from repro.data import SyntheticLMStream as JStream
    a, b = SyntheticLMStream(512, seed=1), JStream(512, seed=1)
    for n in (192, 7, 300):
        np.testing.assert_array_equal(a.sequence(n), b.sequence(n))


ARGS = ["--smoke", "--device", "cpu", "--requests", "3", "--prompt-len",
        "40", "--gen", "6", "--n-max", "128", "--batch", "2", "--chunk", "4"]


@pytest.mark.parametrize("flags,tag", [
    ([], "[ParisKV/slots]"), (["--wave"], "[ParisKV/wave]"),
    (["--baseline"], "[full-attention/slots]"),
    (["--wave", "--baseline"], "[full-attention/wave]")])
def test_serve_cli_prints_requests_and_throughput(capsys, flags, tag):
    cli.main(ARGS + flags)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4
    for uid, line in enumerate(lines[:3]):
        assert line.startswith(f"req {uid}: ttft ") and "out[:8]=[" in line
    assert lines[-1].startswith(tag) and "tok/s (3 requests in" in lines[-1]


def test_serve_cli_runs_as_a_module_and_needs_a_card_without_device():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    ok = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                         *ARGS], cwd=ROOT, env=env, capture_output=True,
                        text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr
    assert "[ParisKV/slots] end-to-end throughput" in ok.stdout
    bad = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--smoke"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert bad.returncode != 0 and "no CUDA device" in bad.stderr
