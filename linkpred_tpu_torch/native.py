"""ctypes bindings for the C++ host runtime (`native/graphlib.cpp`) — the part
of `linkpred_tpu/native.py` that the port's data modules call.

The port builds its own library from the same source, with `g++`, into the
ignored `build/native/` directory at the root of the checkout (never to
`native/libgraphlib.so`, which belongs to the JAX package), named by a hash
of the source and the flags. `sample_negatives` is the one entry point the
port's host modules use; `data.split.negative_sampling` falls back to its
numpy sampler when no compiler is at hand.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "graphlib.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
# the Makefile's flags without -march=native: a library built on one host
# may be loaded on another
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the port's library is built to: the name carries a hash of the
    source and the flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libgraphlib-{digest.hexdigest()[:16]}.so"


def load_library():
    """Build (if needed) and load the shared library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            out = library_path()
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # build under a private name and rename: concurrent builds
                # never load a half-written library
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                subprocess.run(
                    [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                     str(SOURCE)],
                    check=True, capture_output=True,
                )
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.sample_negatives.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def sample_negatives(exclude_pairs, num_nodes: int, num_samples: int, seed: int = 0):
    """Uniform non-edge pair sampling in C++; returns [num_samples, 2]."""
    lib = load_library()
    ex = np.asarray(exclude_pairs, dtype=np.int64)
    lo = np.minimum(ex[:, 0], ex[:, 1])
    hi = np.maximum(ex[:, 0], ex[:, 1])
    keys = np.unique(lo * num_nodes + hi)
    if lib is None:
        from linkpred_tpu_torch.data.split import negative_sampling

        return negative_sampling(
            exclude_pairs, num_nodes, num_samples,
            rng=np.random.default_rng(seed), use_native=False,
        )
    out = np.zeros((num_samples, 2), dtype=np.int32)
    got = lib.sample_negatives(
        _ptr(keys, ctypes.c_int64), ctypes.c_int64(len(keys)),
        ctypes.c_int32(num_nodes), ctypes.c_int64(num_samples),
        ctypes.c_uint64(seed), _ptr(out, ctypes.c_int32),
    )
    if got < num_samples:
        raise ValueError(f"sampled only {got}/{num_samples} negatives")
    return out.astype(np.int64)
