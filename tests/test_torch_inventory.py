"""A checked inventory of the port: every public top-level function and class
of a module of the JAX package (`linkpred_tpu/**/*.py`) has a counterpart of
the same name in the port's module of the same path (`MODULES` names the one
module whose counterpart has another name), or stands on `OMITTED` with the
reason it is left out. Both packages are read with `ast`; neither is
imported.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = REPO / "linkpred_tpu", REPO / "linkpred_tpu_torch"

# the JAX module -> its counterpart, where the paths differ
MODULES = {"ops/pallas_kernels.py": "ops/hopper_kernels.py"}

# "module:name" in the JAX package -> (the port's counterpart under another
# name as "module:name", or None; why the name itself is not in the port,
# with the place in ROADMAP.md that says so)
OMITTED = {
    "ops/pallas_kernels.py:spmm_ell_pallas": (
        "ops/hopper_kernels.py:spmm_ell",
        "K1: a Pallas call becomes a CUDA kernel (ROADMAP section 2)"),
    "ops/pallas_kernels.py:sddmm_pallas": (
        "ops/hopper_kernels.py:sddmm",
        "K2: a Pallas call becomes a CUDA kernel (ROADMAP section 2)"),
    "ops/pallas_kernels.py:spmm_rowdma_pallas": (
        "ops/hopper_kernels.py:spmm_bucketed",
        "K3: a Pallas call becomes a CUDA kernel (ROADMAP section 2)"),
    "ops/pallas_kernels.py:spmm_rowdma_bucketed": (
        "ops/hopper_kernels.py:spmm_bucketed",
        "K3's wrapper: one CUDA launch takes every bucket (ROADMAP section 2)"),
    "ops/segment.py:take_rows": (
        None, "a TPU-only gather workaround (ROADMAP ground rules)"),
    "ops/segment.py:take_rows_fat": (
        None, "a TPU-only gather workaround (ROADMAP ground rules)"),
    "ops/segment.py:gather_rows_planned": (
        None, "a TPU-only gather workaround (ROADMAP ground rules)"),
    "ops/segment.py:segment_sum_onehot": (
        "ops/segment.py:segment_sum_ell",
        "the one-hot-MXU form of K1 is TPU-only (ROADMAP ground rules)"),
    "ops/spmm.py:choose_backend_1wl": (
        None, "picks a TPU-only 1-WL backend (ROADMAP ground rules)"),
    "models/twowl.py:train_scan": (
        "models/twowl.py:train_loop",
        "the 60 s chunking of train_scan is TPU-only (ROADMAP ground rules)"),
    "models/twowl.py:train_scan_trials": (
        "models/twowl.py:train_loop_trials",
        "the 60 s chunking of train_scan is TPU-only (ROADMAP ground rules)"),
    "models/seal.py:train_scan": (
        "models/seal.py:train_steps",
        "the 60 s chunking of train_scan is TPU-only (ROADMAP ground rules)"),
    "models/seal.py:train_scan_compact": (
        "models/seal.py:train_steps",
        "the 60 s chunking of train_scan is TPU-only (ROADMAP ground rules)"),
    "models/seal.py:train_step": (
        "models/seal.py:train_steps",
        "one jitted step of train_scan's loop (ROADMAP ground rules)"),
    "models/twowl.py:DropRates": (
        "models/twowl.py:TrialRates",
        "dropout rates as traced scalars for vmap; the trial-major layout "
        "holds them [T] (ROADMAP ground rules)"),
    "utils/device.py:honor_platform_env": (
        None, "re-applies JAX_PLATFORMS over the TPU plugin's config; the "
        "port takes its card from cuda_device() (ROADMAP ground rules)"),
    "utils/metrics.py:roc_auc_jax": (
        "utils/metrics.py:roc_auc",
        "named for jax, which the port does not use (ROADMAP ground rules)"),
}


def _public_names(path: Path) -> set:
    """The public functions and classes defined at a module's top level."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return {node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef))
            and not node.name.startswith("_")}


def _port_module(module: str) -> Path:
    return PORT / MODULES.get(module, module)


JAX_MODULES = sorted(p.relative_to(JAX).as_posix()
                     for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    port = _port_module(module)
    assert port.exists(), f"no counterpart of linkpred_tpu/{module}"
    missing = sorted(_public_names(JAX / module) - _public_names(port))
    unlisted = [name for name in missing if f"{module}:{name}" not in OMITTED]
    assert not unlisted, (
        f"linkpred_tpu/{module}: {unlisted} have no counterpart in "
        f"linkpred_tpu_torch/{MODULES.get(module, module)} and are not on "
        "OMITTED")


@pytest.mark.parametrize("entry", sorted(OMITTED))
def test_omitted_names_are_current(entry):
    """An entry names a public name the JAX package still has and the port
    still lacks, its counterpart (if any) exists, and its reason says where
    ROADMAP.md gives it."""
    module, name = entry.split(":")
    assert name in _public_names(JAX / module), f"{entry} is gone"
    assert name not in _public_names(_port_module(module)), (
        f"{entry} now has a counterpart of its own name: take it off")
    counterpart, reason = OMITTED[entry]
    if counterpart is not None:
        c_module, c_name = counterpart.split(":")
        assert c_name in _public_names(PORT / c_module), counterpart
    assert "ROADMAP" in reason, entry


def test_the_native_bindings_are_ported():
    """The last two host bindings of `native.py` are the port's own."""
    assert not [e for e in OMITTED if e.startswith("native.py:")]
    assert {"build_csr_ell", "sgns_train_ref"} <= _public_names(
        PORT / "native.py")
