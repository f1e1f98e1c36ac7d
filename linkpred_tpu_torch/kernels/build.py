"""Build the hand-written CUDA kernels of `linkpred_tpu_torch/csrc/` at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into its own shared library, which is loaded with
`ctypes`: no PyTorch headers, so a build takes seconds. Libraries go to
`build/kernels/` at the root of the checkout, keyed by a hash of the source,
the shared headers `csrc/*.cuh` and the flags, so an edited source is rebuilt
and an unchanged one is not. `libraries(names)` runs one `nvcc` per source,
all at once.

A source's first load in a process is a `kernels.load` span
(`utils.profiling`), with a nested `kernels.compile` around `nvcc` when its
hashed library was missing, so a kernel built again shows by name.

Nothing here runs at import: the CPU tests import every module, and this
machine need not have `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from linkpred_tpu_torch.utils.profiling import span

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills per kernel, kept in BUILD_LOGS
    "-Xptxas", "-v",
)

_LIBRARIES: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}  # name -> nvcc/ptxas report of the last build


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of linkpred_tpu_torch/csrc cannot be built")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` is built to: the name carries a hash of the
    source, the shared headers and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def library(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` unless its hashed library exists, then load it
    (once per process). Raises with nvcc's output when the build fails."""
    lib = _LIBRARIES.get(name)
    if lib is not None:
        return lib
    with span("kernels.load"):
        out = library_path(name)
        if not out.exists():
            with span("kernels.compile"):
                _compile(name, out)
        lib = ctypes.CDLL(str(out))
    _LIBRARIES[name] = lib
    return lib


def _compile(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename: concurrent builders of the
    # same source never load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
         str(CSRC_DIR / f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)


def libraries(names) -> dict[str, ctypes.CDLL]:
    """`library(name)` for each of `names`, the builds run concurrently (one
    `nvcc` process per source). Raises the first build error."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(library, names)))
