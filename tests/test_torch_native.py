"""The port's bindings of `build_csr_ell` and `sgns_train_ref`
(`linkpred_tpu_torch/native.py`) against the JAX package's bindings of the
same C++ source, against their numpy counterparts, and on the two-clique
oracle. Both libraries are built under the lock of `test_torch_data`'s
helper, once across the suite's worker processes.
"""

import numpy as np
import pytest
import torch

from linkpred_tpu import native as jnative
from linkpred_tpu_torch import native as tnative
from linkpred_tpu_torch.data.graph import Graph
from linkpred_tpu_torch.ops.walk import WalkEngine
from test_torch_data import build_native_libraries

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

build_native_libraries()

# The JAX package's library is built with -march=native, the port's
# without, so the compiler may contract and vectorise the SGNS loop
# differently: over 200 seeds of `_sgns_inputs` the tables never came out
# bitwise equal, and differed by at most 1.1e-8.
SGNS_ATOL = 1e-6


def _edges(case):
    """(src, dst, num_nodes, max_degree) of a named case."""
    rng = np.random.default_rng(7)
    if case == "duplicates":
        return rng.integers(0, 40, 300), rng.integers(0, 40, 300), 40, None
    if case == "hub with duplicates":
        # a row of 120 edges among 30 targets: std::sort leaves its
        # insertion sort beyond 16 elements
        src = np.concatenate([np.zeros(120, np.int64), rng.integers(1, 20, 80)])
        return src, rng.integers(0, 30, 200), 30, None
    if case == "isolated nodes":
        return rng.integers(0, 40, 150), rng.integers(0, 40, 150), 64, None
    if case == "no edges":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 12, None
    if case == "no duplicates":
        keys = rng.choice(50 * 50, 400, replace=False)
        return keys // 50, keys % 50, 50, None
    src, dst = rng.integers(0, 40, 300), rng.integers(0, 40, 300)
    return src, dst, 40, {"max_degree above": 25, "max_degree below": 2}[case]


CASES = ["duplicates", "hub with duplicates", "isolated nodes", "no edges",
         "no duplicates", "max_degree above", "max_degree below"]


def _assert_arrays_equal(got, ref, names=("order", "indptr", "nbr", "mask",
                                          "degree")):
    for name, a, b in zip(names, got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_build_csr_ell_equals_jax_binding(case):
    """The same source and algorithm: all five arrays equal, `order` among
    duplicate edges too."""
    src, dst, n, max_degree = _edges(case)
    got = tnative.build_csr_ell(src, dst, n, max_degree)
    _assert_arrays_equal(got, jnative.build_csr_ell(src, dst, n, max_degree))
    assert [a.dtype for a in got] == [np.int32] * 3 + [bool, np.int32]
    d = max(int(np.bincount(src, minlength=n).max(initial=0)), 1,
            max_degree or 0)
    assert got[2].shape == (n, d)


@pytest.mark.parametrize("case", CASES)
def test_build_csr_ell_numpy_path_equals_cpp(case, monkeypatch):
    """Without the library `build_csr_ell` takes its numpy path. Its stable
    lexsort may order duplicate edges otherwise than the C++'s unstable
    `std::sort`, so `order` is held exactly only where no (src, dst) edge
    repeats, and elsewhere through the edges it puts in order."""
    src, dst, n, max_degree = _edges(case)
    cpp = tnative.build_csr_ell(src, dst, n, max_degree)
    monkeypatch.setattr(tnative, "load_library", lambda: None)
    got = tnative.build_csr_ell(src, dst, n, max_degree)
    _assert_arrays_equal(got[1:], cpp[1:], names=("indptr", "nbr", "mask",
                                                  "degree"))
    assert got[0].dtype == np.int32 and got[0].shape == cpp[0].shape
    np.testing.assert_array_equal(src[got[0]], src[cpp[0]])
    np.testing.assert_array_equal(dst[got[0]], dst[cpp[0]])
    if len(np.unique(np.asarray(src) * n + dst)) == len(src):
        np.testing.assert_array_equal(got[0], cpp[0])


def test_build_csr_ell_matches_graph_from_edges():
    """The CSR and ELL views of `Graph.from_edges` on the same edges."""
    src, dst, n, _ = _edges("isolated nodes")
    order, indptr, nbr, mask, degree = tnative.build_csr_ell(src, dst, n)
    g = Graph.from_edges(src, dst, num_nodes=n)
    np.testing.assert_array_equal(indptr, g.indptr)
    np.testing.assert_array_equal(degree, g.degree)
    np.testing.assert_array_equal(src[order], g.src)
    np.testing.assert_array_equal(dst[order], g.indices)
    assert nbr.shape == g.nbr.shape
    np.testing.assert_array_equal(nbr, g.nbr)
    np.testing.assert_array_equal(mask, g.nbr_mask)


def test_build_csr_ell_rejects_what_the_cpp_cannot_index(monkeypatch):
    """Edges outside [0, num_nodes) or of unequal lengths raise before any
    pointer is passed; a capacity error of the C++ names both numbers."""
    with pytest.raises(ValueError, match="src names a node outside"):
        tnative.build_csr_ell([0, 5], [1, 2], 5)
    with pytest.raises(ValueError, match="dst names a node outside"):
        tnative.build_csr_ell([0, 1], [1, -1], 5)
    with pytest.raises(ValueError, match="src has 2 edges, dst 1"):
        tnative.build_csr_ell([0, 1], [1], 5)

    class TooNarrow:
        @staticmethod
        def build_csr_ell(*args):
            return -9

    monkeypatch.setattr(tnative, "load_library", lambda: TooNarrow)
    with pytest.raises(RuntimeError, match="degree 9, more than the 2 ELL"):
        tnative.build_csr_ell([0, 0, 1], [1, 2, 2], 3)


def _sgns_inputs(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 60, (40, 12)).astype(np.int32), 60


@pytest.mark.parametrize("seed", [0, 1])
def test_sgns_train_ref_equals_jax_binding(seed):
    """One thread, so no hogwild race: the word count is exact and the table
    within `SGNS_ATOL`; the table has moved from its init."""
    walks, n = _sgns_inputs(seed)
    kw = dict(dim=16, window=4, epochs=1, seed=seed, n_threads=1)
    syn0, words = tnative.sgns_train_ref(walks, n, **kw)
    ref, ref_words = jnative.sgns_train_ref(walks, n, **kw)
    assert words == ref_words == walks.size
    assert syn0.dtype == np.float32 and syn0.shape == (n, 16)
    np.testing.assert_allclose(syn0, ref, rtol=0, atol=SGNS_ATOL)
    init = ((np.random.default_rng(seed).random((n, 16)) - 0.5) / 16)
    assert np.abs(syn0 - init.astype(np.float32)).max() > 1e-3


def test_sgns_train_ref_learns_cliques():
    """Two 8-cliques joined by one edge, walked by the port's `WalkEngine`
    on the CPU: the embeddings separate (the oracle of the JAX package's
    `test_sgns_ref_learns_cliques`). The walk tensor goes in as it is."""
    k = 8
    pairs = [(a + base, b + base) for base in (0, k)
             for a in range(k) for b in range(a + 1, k)] + [(0, k)]
    pairs = np.asarray(pairs)
    g = Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1], num_nodes=2 * k)
    walks = WalkEngine(g, device="cpu").walks(
        torch.Generator().manual_seed(0), 40, 12)
    emb, trained = tnative.sgns_train_ref(walks, 2 * k, dim=16, window=4,
                                          epochs=5, lr=0.05, n_threads=1)
    assert trained == walks.numel() * 5
    e = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sim = e @ e.T
    intra = (sim[:k, :k].sum() - k) / (k * (k - 1)) / 2 + (
        sim[k:, k:].sum() - k) / (k * (k - 1)) / 2
    inter = sim[:k, k:].mean()
    assert intra > inter + 0.2, (intra, inter)


def test_sgns_train_ref_raises_without_library(monkeypatch):
    """The baseline has no fallback; inputs the C++ cannot index raise."""
    walks, n = _sgns_inputs(0)
    with pytest.raises(ValueError, match="outside"):
        tnative.sgns_train_ref(walks, 30, dim=8, n_threads=1)
    with pytest.raises(ValueError, match="window 0"):
        tnative.sgns_train_ref(walks, n, dim=8, window=0, n_threads=1)
    with pytest.raises(ValueError, match=r"walks must be \[W, L\]"):
        tnative.sgns_train_ref(walks.reshape(-1), n, dim=8, n_threads=1)
    monkeypatch.setattr(tnative, "load_library", lambda: None)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        tnative.sgns_train_ref(walks, n, dim=8, n_threads=1)
