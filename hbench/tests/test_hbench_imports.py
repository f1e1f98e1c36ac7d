"""What the benchmark loads, and how it refuses to run: no module of the
JAX stack or the JAX package is loaded by the harness, the drivers of the
configurations in `BENCHMARK.json` or the reference (top-level names
compared whole: the port's name begins with the JAX package's), the
reference loads nothing of the port, and `run.py` exits non-zero with no
result where there is no card or no port. Every driver, every module under
`reference/` and every cell is found here, with no edit for a new one."""

import json
import shutil
import subprocess
import sys

import pytest

from hbench import harness

ROOT = harness.ROOT
FORBIDDEN = ["jax", "jaxlib", "flax", "optax", "linkpred_tpu", "benchmarks",
             "bench"]
FIRST_CELL = harness.load_spec()["workloads"][0]["name"]
# every module under hbench/reference/, imported in the probe's process
REFERENCES = ("import importlib, pkgutil, hbench.reference as hr;"
              " [importlib.import_module(f'hbench.reference.{m.name}')"
              " for m in pkgutil.iter_modules(hr.__path__)]")


def loaded_after(code: str) -> set:
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; "
             "import json; print(json.dumps(sorted({n.split('.')[0] for n in "
             "sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole run of every cell at its small size on the CPU, in one
    process that also loads `run.py`, every reader, the driver of every
    configuration, every reference module and `calibrate.py`: what the port
    loads on the way counts too."""
    names = loaded_after(
        "import runpy, torch; runpy.run_path('hbench/run.py', "
        "run_name='hbench_run');"
        " from hbench import harness, calibrate;"
        " spec = harness.load_spec();"
        " [harness.reader(m['name']) for m in spec['per_layer']];"
        " [harness.driver(harness.load_data('configs', c['name']))"
        " for c in spec['configs']];"
        f" {REFERENCES};"
        " [harness.run_cell(w['name'], 1, 0.1, False, torch.device('cpu'),"
        " 0.0, spec, *harness.small(w['name'])) for w in spec['workloads']]")
    assert "linkpred_tpu_torch" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_reference_loads_neither_jax_nor_the_port():
    names = loaded_after(REFERENCES)
    assert "hbench" in names
    assert not names & set(FORBIDDEN + ["linkpred_tpu_torch"])


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "linkpred_tpu_torch_probe", sys)
    assert "linkpred_tpu_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()


def run_py(cwd, *args):
    return subprocess.run(
        [sys.executable, "hbench/run.py", "--workload", FIRST_CELL,
         "--seed", "3000000001", "--seconds", "1",
         "--trace", "0", *args], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_run_refuses_without_a_card():
    out = run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_run_refuses_in_a_checkout_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hbench", tmp_path / "hbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "hbench/run.py", "--workload", FIRST_CELL,
         "--seed", "3000000002", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
