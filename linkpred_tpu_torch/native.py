"""ctypes bindings for the C++ host runtime (`native/graphlib.cpp`), the
counterpart of `linkpred_tpu/native.py`.

The port builds its own library from the same source, with `g++`, into the
ignored `build/native/` directory at the root of the checkout (never to
`native/libgraphlib.so`, which belongs to the JAX package), named by a hash
of the source and the flags. It binds all seven entry points of that source:

- `build_csr_ell` (sorted CSR + padded ELL arrays) and `sample_negatives`
  fall back to numpy when the library does not load (the latter to
  `data.split.negative_sampling`'s sampler);
- for node2vec, `build_alias_rows` falls back to `ops.walk.alias_setup_rows`;
  `edge_bias_probs` raises without the library, and `ops.walk.AliasTables.
  build` then takes its numpy path;
- for SEAL, `extract_subgraphs_csr` and `drnl_tags_batch` raise without the
  library, and `data.subgraph` then takes its numpy path or the BFS in torch;
- `sgns_train_ref`, the gensim-class SGNS loop on the host's cores, raises
  without the library: it is the measured host baseline beside the device
  trainer, and nothing of the port's pipelines calls it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

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
        lib.build_alias_rows.restype = None
        lib.edge_bias_probs.restype = None
        lib.extract_subgraphs_csr.restype = None
        lib.drnl_tags_batch.restype = None
        i32p, u8p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
        i64p, f32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float)
        # the largest degree found, or its negative when it exceeds max_deg
        lib.build_csr_ell.restype = ctypes.c_int32
        lib.build_csr_ell.argtypes = [
            i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i32p,
            i32p, i32p, u8p, i32p]
        # the words trained, which may pass 2^31
        lib.sgns_train_ref.restype = ctypes.c_int64
        lib.sgns_train_ref.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int32, i64p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_float, ctypes.c_float, ctypes.c_uint64, ctypes.c_int32,
            f32p, f32p]
        lib.extract_subgraphs_csr.argtypes = [
            i32p, i32p, ctypes.c_int32, i32p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_uint64, i32p, u8p, u8p, i32p]
        lib.drnl_tags_batch.argtypes = [u8p, u8p, i32p, ctypes.c_int64,
                                        ctypes.c_int32, i32p]
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


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _edge_arrays(src, dst, num_nodes: int):
    """int32 copies of a directed edge list, checked against `num_nodes`:
    the C++ indexes its row counts by `src` unchecked."""
    src, dst = _i32(src).reshape(-1), _i32(dst).reshape(-1)
    if src.shape != dst.shape:
        raise ValueError(f"src has {src.size} edges, dst {dst.size}")
    for name, a in (("src", src), ("dst", dst)):
        if a.size and (a.min() < 0 or a.max() >= num_nodes):
            raise ValueError(f"{name} names a node outside [0, {num_nodes})")
    return src, dst


def _ell_width(degree, max_degree: int | None) -> int:
    """The ELL width: the largest degree, at least 1 and `max_degree`."""
    return max(int(degree.max(initial=0)), 1, max_degree or 0)


def build_csr_ell_numpy(src, dst, num_nodes: int,
                        max_degree: int | None = None):
    """`build_csr_ell` in numpy: edges sorted by a stable `np.lexsort` on
    (src, dst), so duplicate edges keep their input order."""
    src, dst = _edge_arrays(src, dst, num_nodes)
    order = np.lexsort((dst, src)).astype(np.int32)
    degree = np.bincount(src, minlength=num_nodes).astype(np.int32)
    indptr = np.zeros(num_nodes + 1, dtype=np.int32)
    np.cumsum(degree, out=indptr[1:])
    d = _ell_width(degree, max_degree)
    nbr = np.zeros((num_nodes, d), dtype=np.int32)
    mask = np.zeros((num_nodes, d), dtype=bool)
    s_sorted, d_sorted = src[order], dst[order]
    pos = np.arange(len(src), dtype=np.int64) - indptr[s_sorted]
    nbr[s_sorted, pos] = d_sorted
    mask[s_sorted, pos] = True
    return order, indptr, nbr, mask, degree


def build_csr_ell(src, dst, num_nodes: int, max_degree: int | None = None):
    """Sorted CSR + padded ELL arrays from a directed edge list, in C++.

    Returns (order [E], indptr [N+1], nbr [N, d], mask [N, d] bool,
    degree [N]), all int32 but `mask`, with the edges sorted by (src, dst)
    through `order` and d = max(largest degree, 1, `max_degree`). The C++
    sorts each row by `dst` with `std::sort`, which is not stable: among
    duplicate edges `order` may differ from `build_csr_ell_numpy`'s, which
    this falls back to when the library does not load."""
    lib = load_library()
    if lib is None:
        return build_csr_ell_numpy(src, dst, num_nodes, max_degree)
    src, dst = _edge_arrays(src, dst, num_nodes)
    e = len(src)
    d = _ell_width(np.bincount(src, minlength=num_nodes), max_degree)
    indptr = np.zeros(num_nodes + 1, dtype=np.int32)
    order = np.zeros(e, dtype=np.int32)
    nbr = np.zeros((num_nodes, d), dtype=np.int32)
    mask = np.zeros((num_nodes, d), dtype=np.uint8)
    degree = np.zeros(num_nodes, dtype=np.int32)
    got = lib.build_csr_ell(
        _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32), e, num_nodes, d,
        _ptr(indptr, ctypes.c_int32), _ptr(order, ctypes.c_int32),
        _ptr(nbr, ctypes.c_int32), _ptr(mask, ctypes.c_uint8),
        _ptr(degree, ctypes.c_int32),
    )
    if got < 0:
        raise RuntimeError(f"build_csr_ell: a node has degree {-got}, more "
                           f"than the {d} ELL slots allocated")
    return order, indptr, nbr, mask.astype(bool), degree


def build_alias_rows(probs, valid):
    """Vose alias tables per row in C++; the contract of
    `linkpred_tpu_torch.ops.walk.alias_setup_rows`."""
    lib = load_library()
    if lib is None:
        from linkpred_tpu_torch.ops.walk import alias_setup_rows

        return alias_setup_rows(probs, valid)
    probs = np.ascontiguousarray(probs, dtype=np.float64)
    deg = np.ascontiguousarray(valid.sum(axis=1), dtype=np.int32)
    r, d = probs.shape
    J = np.zeros((r, d), dtype=np.int32)
    q = np.zeros((r, d), dtype=np.float32)
    lib.build_alias_rows(
        _ptr(probs, ctypes.c_double), _ptr(deg, ctypes.c_int32),
        ctypes.c_int64(r), ctypes.c_int32(d),
        _ptr(J, ctypes.c_int32), _ptr(q, ctypes.c_float),
    )
    return J, q


def edge_bias_probs(src, dst, nbr, mask, indptr, indices, p: float, q: float,
                    nbr_weight=None):
    """p/q-biased neighbor probabilities per directed edge (node2vec's
    2nd-order walk bias): [E, D] float64. `nbr_weight` ([N, D] float32 in
    ELL layout) scales each neighbor's bias by the edge weight. Raises
    without the library."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable; use the numpy path")
    src, dst, nbr_c = _i32(src), _i32(dst), _i32(nbr)
    mask_c = np.ascontiguousarray(mask, dtype=np.uint8)
    if nbr_weight is not None:
        w_c = np.ascontiguousarray(nbr_weight, dtype=np.float32)
        w_ptr = _ptr(w_c, ctypes.c_float)
    else:
        w_ptr = ctypes.POINTER(ctypes.c_float)()
    indptr_c, indices_c = _i32(indptr), _i32(indices)
    out = np.zeros((len(src), nbr.shape[1]), dtype=np.float64)
    lib.edge_bias_probs(
        _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
        ctypes.c_int64(len(src)),
        _ptr(nbr_c, ctypes.c_int32), _ptr(mask_c, ctypes.c_uint8),
        w_ptr, ctypes.c_int32(nbr.shape[1]),
        _ptr(indptr_c, ctypes.c_int32), _ptr(indices_c, ctypes.c_int32),
        ctypes.c_double(p), ctypes.c_double(q),
        _ptr(out, ctypes.c_double),
    )
    return out


def extract_subgraphs_csr(indptr, indices, num_nodes: int, pairs,
                          hop: int, max_neighbors: int, seed: int = 0):
    """Threaded C++ k-hop enclosing-subgraph extraction over CSR. Returns
    (nodes [P, K] int32, mask [P, K] bool, adj [P, K, K] uint8, sizes [P]
    int32), K = `max_neighbors`; the random truncation draws from `seed`.
    Raises without the library."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable; use the numpy path")
    pairs = _i32(pairs)
    P, K = pairs.shape[0], max_neighbors
    indptr_c, indices_c = _i32(indptr), _i32(indices)
    nodes = np.zeros((P, K), dtype=np.int32)
    mask = np.zeros((P, K), dtype=np.uint8)
    adj = np.zeros((P, K, K), dtype=np.uint8)
    sizes = np.zeros(P, dtype=np.int32)
    lib.extract_subgraphs_csr(
        _ptr(indptr_c, ctypes.c_int32), _ptr(indices_c, ctypes.c_int32),
        ctypes.c_int32(num_nodes), _ptr(pairs, ctypes.c_int32),
        ctypes.c_int64(P), ctypes.c_int32(hop), ctypes.c_int32(K),
        ctypes.c_uint64(seed),
        _ptr(nodes, ctypes.c_int32), _ptr(mask, ctypes.c_uint8),
        _ptr(adj, ctypes.c_uint8), _ptr(sizes, ctypes.c_int32),
    )
    return nodes, mask.astype(bool), adj, sizes


def drnl_tags_batch(adj, mask, sizes):
    """Threaded C++ DRNL labeling of a padded subgraph stack (adj [P, K, K]
    uint8, mask [P, K] bool, sizes [P]) -> tags [P, K] int32, the tags of
    `data.subgraph.drnl_tags`. Raises without the library."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable; use drnl_tags")
    adj = np.ascontiguousarray(adj, dtype=np.uint8)
    mask_u8 = np.ascontiguousarray(mask, dtype=np.uint8)
    sizes = _i32(sizes)
    P, K = mask_u8.shape
    tags = np.zeros((P, K), dtype=np.int32)
    lib.drnl_tags_batch(
        _ptr(adj, ctypes.c_uint8), _ptr(mask_u8, ctypes.c_uint8),
        _ptr(sizes, ctypes.c_int32), ctypes.c_int64(P), ctypes.c_int32(K),
        _ptr(tags, ctypes.c_int32),
    )
    return tags


def sgns_train_ref(walks, num_nodes: int, dim: int = 128, window: int = 10,
                   negatives: int = 5, epochs: int = 1, lr: float = 0.025,
                   min_lr: float = 1e-4, seed: int = 0, n_threads: int = 0):
    """The measured host baseline of SGNS: gensim's training loop in C++,
    hogwild over `n_threads` threads (0: every core the host reports), as
    the reference trains with workers=8 (`feature_extraction.py:17`).
    `walks` is an int [W, L] array or tensor, moved to the host. Returns
    (syn0 [num_nodes, dim] float32, words trained). It exists to give the
    device trainer a words/s denominator measured on the same machine; no
    pipeline of the port calls it, and it raises without the library."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if isinstance(walks, torch.Tensor):
        walks = walks.detach().cpu().numpy()
    walks = _i32(walks)
    if walks.ndim != 2:
        raise ValueError(f"walks must be [W, L], not {walks.shape}")
    if walks.size and (walks.min() < 0 or walks.max() >= num_nodes):
        raise ValueError(f"walks name a node outside [0, {num_nodes})")
    if window < 1 or dim < 1:
        raise ValueError(f"window {window} and dim {dim} must be >= 1")
    n_walks, walk_len = walks.shape
    counts = np.bincount(walks.reshape(-1), minlength=num_nodes).astype(
        np.int64)
    rng = np.random.default_rng(seed)
    syn0 = ((rng.random((num_nodes, dim)) - 0.5) / dim).astype(np.float32)
    syn1 = np.zeros((num_nodes, dim), dtype=np.float32)
    trained = lib.sgns_train_ref(
        _ptr(walks, ctypes.c_int32), n_walks, walk_len,
        _ptr(counts, ctypes.c_int64), num_nodes, dim, window, negatives,
        epochs, lr, min_lr, seed, n_threads,
        _ptr(syn0, ctypes.c_float), _ptr(syn1, ctypes.c_float),
    )
    return syn0, int(trained)
