"""The import guard: nothing the benchmark runs loads JAX or the JAX
package (top-level names compared whole: the port's name begins with
the JAX package's), and the reference loads nothing of the port."""
import subprocess
import sys
import types
from pathlib import Path

from portbench.lib import guard

REPO = Path(__file__).resolve().parents[2]


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert "repro" not in guard.loaded() or "repro" in {
        n.split(".", 1)[0] for n in sys.modules if n.split(".")[0] == "repro"}
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("x"))
    assert "repro" in guard.loaded()
    assert "jaxtyping" not in guard.loaded()


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_a_smoke_run_loads_no_jax():
    """A whole run of a smoke cell in a fresh process, every metric reader
    loaded: no forbidden top-level module afterwards."""
    code = f"""
import sys, time
sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]
import importlib.util
spec = importlib.util.spec_from_file_location("pbrun", {str(REPO / 'portbench/run.py')!r})
R = importlib.util.module_from_spec(spec); spec.loader.exec_module(R)
from portbench.lib import guard, spec as S
from portbench.tests.smoke import smoke_cell
for m in S.manifest()["per_layer"] + S.manifest()["end_to_end"]:
    R.metric_reader(m["name"])
R.run_cell(smoke_cell("qwen2-1.5b.longdoc-32k"), 5, 0.5, True, "cpu", time.perf_counter())
print(guard.loaded())
"""
    assert _fresh(code) == "[]"


def test_the_reference_loads_nothing_of_the_port():
    code = f"""
import sys
sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]
import portbench.reference.model, portbench.reference.pariskv
import portbench.counts.work, portbench.lib.traffic
print(sorted(n for n in sys.modules if n.split('.')[0] in ('repro', 'repro_torch', 'jax')))
"""
    assert _fresh(code) == "[]"
