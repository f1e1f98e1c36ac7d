"""The port's own host data modules (`linkpred_tpu_torch.data`, numpy only)
against the JAX package's originals on the same inputs, made from a numpy
seed: every array must be equal, since the copies run the same code on the
same random streams (both packages' C++ libraries are built and loaded at
import, once across the suite's worker processes). Then the byte counts and
the CSR constructors that `chip_smoke.py` uses for a kernel's bound and its
library yardstick, on layouts small enough to count by hand.
"""

import dataclasses
import fcntl
import os
import sys
import time

import numpy as np
import pytest
import torch

from linkpred_tpu import native as jnative
from linkpred_tpu.data import graph as jgraph
from linkpred_tpu.data import io as jio
from linkpred_tpu.data import split as jsplit
from linkpred_tpu.data import twowl as jtwowl
from linkpred_tpu_torch import native as tnative
from linkpred_tpu_torch.data import graph as tgraph
from linkpred_tpu_torch.data import io as tio
from linkpred_tpu_torch.data import split as tsplit
from linkpred_tpu_torch.data import synth as tsynth
from linkpred_tpu_torch.data import twowl as ttwowl
from linkpred_tpu_torch.ops import hopper_kernels as hk
from linkpred_tpu_torch.ops import segment as tseg
from linkpred_tpu_torch.ops import spmm as tspmm

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

import chip_smoke as cs  # noqa: E402
import scaling as jscaling  # noqa: E402  (benchmarks/scaling.py)


def build_native_libraries(attempts: int = 60) -> None:
    """Load both packages' graph libraries in this process, building each
    at most once across processes: the builds run under a lock file in the
    ignored `build/` directory. The JAX package's loader builds
    `native/libgraphlib.so` with `make` and remembers a failed load (as when
    another process was still writing the file); such a failure is cleared
    and the load retried until it succeeds."""
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            tnative.load_library()
            for _ in range(attempts):
                if jnative.load_library() is not None:
                    break
                jnative._tried = False
                time.sleep(1.0)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


# every worker process of the suite imports this module before it runs a
# test: the C++ plane is then loaded in each, whichever built it
build_native_libraries()


def _assert_fields_equal(a, b):
    """Two dataclass instances of the same fields hold equal values, arrays
    compared element by element with their dtypes."""
    fa, fb = dataclasses.fields(a), dataclasses.fields(b)
    assert [f.name for f in fa] == [f.name for f in fb]
    for f in fa:
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(va):
            _assert_fields_equal(va, vb)
        elif isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb or (va is None and vb is None), f.name


def _pairs(seed, n=60, e=200):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, (e, 2)), n


# ---------------------------------------------------------------------------
# io, graph
# ---------------------------------------------------------------------------


def test_load_fb_pages_food_equal():
    gj, ej = jio.load_fb_pages_food()
    gt, et = tio.load_fb_pages_food()
    np.testing.assert_array_equal(et, ej)
    _assert_fields_equal(gt, gj)
    assert tio.load_node_names() == jio.load_node_names()


@pytest.mark.parametrize("text", [
    "a,b\n10,20\n20,30\n30,10\n10,20\n5,5\n",
    "7 9 2019\n9 11 2020\n11 7 2021\n3 7 2021\n",
], ids=["csv with header", "whitespace with extra column"])
def test_load_edge_pairs_equal(tmp_path, text):
    path = tmp_path / "edges.txt"
    path.write_text(text)
    lo_j, hi_j, n_j = jio.load_edge_pairs(str(path))
    lo_t, hi_t, n_t = tio.load_edge_pairs(str(path))
    assert n_t == n_j
    np.testing.assert_array_equal(lo_t, lo_j)
    np.testing.assert_array_equal(hi_t, hi_j)


def test_load_edgelist_equal():
    path = os.path.join(REPO, "examples", "karate.edgelist")
    _assert_fields_equal(tio.load_edgelist(path), jio.load_edgelist(path))


@pytest.mark.parametrize("seed", [0, 1])
def test_graph_fields_equal(seed):
    pairs, n = _pairs(seed)
    w = np.random.default_rng(seed + 7).random(len(pairs)).astype(np.float32)
    for build in (
        lambda mod: mod.Graph.from_edges(pairs[:, 0], pairs[:, 1],
                                         num_nodes=n),
        lambda mod: mod.Graph.from_edges(pairs[:, 0], pairs[:, 1],
                                         num_nodes=n, weight=w),
        lambda mod: mod.Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1],
                                                    num_nodes=n),
    ):
        gj, gt = build(jgraph), build(tgraph)
        _assert_fields_equal(gt, gj)
        np.testing.assert_array_equal(gt.dense_adjacency(),
                                      gj.dense_adjacency())
        np.testing.assert_array_equal(gt.has_edge_matrix(),
                                      gj.has_edge_matrix())
        np.testing.assert_array_equal(gt.undirected_pairs(),
                                      gj.undirected_pairs())


@pytest.mark.parametrize("symmetric", [False, True])
def test_graph_degree_cap_equal(symmetric):
    pairs, n = _pairs(3, n=40, e=400)
    caps = []
    for mod in (jgraph, tgraph):
        g = mod.Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1],
                                            num_nodes=n)
        caps.append(g.with_degree_cap(6, rng=np.random.default_rng(5),
                                      symmetric=symmetric))
    _assert_fields_equal(caps[1], caps[0])
    assert caps[1].max_degree <= 6 or not symmetric


# ---------------------------------------------------------------------------
# split, native
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_random_split_edges_equal(seed):
    pairs, n = _pairs(seed)
    sj = jsplit.random_split_edges(pairs, n, rng=np.random.default_rng(seed))
    st = tsplit.random_split_edges(pairs, n, rng=np.random.default_rng(seed))
    _assert_fields_equal(st, sj)


@pytest.mark.parametrize("seed", [0, 1])
def test_negative_sampling_numpy_equal(seed):
    pairs, n = _pairs(seed)
    nj = jsplit.negative_sampling(pairs, n, 150,
                                  rng=np.random.default_rng(seed),
                                  use_native=False)
    nt = tsplit.negative_sampling(pairs, n, 150,
                                  rng=np.random.default_rng(seed),
                                  use_native=False)
    np.testing.assert_array_equal(nt, nj)
    assert nt.shape == (150, 2) and (nt[:, 0] < nt[:, 1]).all()


def test_negative_sampling_native_equal():
    """Both packages' C++ samplers are builds of one source, so the same
    generator state gives the same pairs; the port's library is its own
    file under build/, never the JAX package's."""
    if not (jnative.available() and tnative.available()):
        pytest.skip("no C++ compiler: the C++ sampler is not built")
    pairs, n = _pairs(2)
    nj = jsplit.negative_sampling(pairs, n, 150,
                                  rng=np.random.default_rng(2),
                                  use_native=True)
    nt = tsplit.negative_sampling(pairs, n, 150,
                                  rng=np.random.default_rng(2),
                                  use_native=True)
    np.testing.assert_array_equal(nt, nj)
    port_lib = tnative.library_path()
    assert port_lib.exists() and port_lib.parent.name == "native"
    assert port_lib.parent.parent.name == "build"
    np.testing.assert_array_equal(
        tnative.sample_negatives(pairs, n, 40, seed=9),
        jnative.sample_negatives(pairs, n, 40, seed=9))


def test_negative_sampling_keeps_the_documented_choice(monkeypatch):
    """`use_native=None` takes the C++ sampler when its library loads and the
    numpy sampler otherwise; `use_native=True` without a library raises."""
    pairs, n = _pairs(4)
    monkeypatch.setattr(tnative, "load_library", lambda: None)
    got = tsplit.negative_sampling(pairs, n, 50,
                                   rng=np.random.default_rng(4))
    ref = tsplit.negative_sampling(pairs, n, 50,
                                   rng=np.random.default_rng(4),
                                   use_native=False)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(RuntimeError, match="use_native=True"):
        tsplit.negative_sampling(pairs, n, 50, use_native=True)


@pytest.mark.parametrize("name", ["shuffled_non_edges", "two_hop_negatives",
                                  "removable_positive_edges"])
def test_other_samplers_equal(name):
    pairs, n = _pairs(6, n=30, e=80)
    args = {"shuffled_non_edges": (pairs, n, 40),
            "two_hop_negatives": (pairs, n),
            "removable_positive_edges": (pairs, n)}[name]

    def call(mod):
        kw = ({"rng": np.random.default_rng(1)}
              if name == "shuffled_non_edges" else {})
        return getattr(mod, name)(*args, **kw)

    np.testing.assert_array_equal(call(tsplit), call(jsplit))


# ---------------------------------------------------------------------------
# twowl, synth
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_build_twowl_data_equal(seed, monkeypatch):
    """Every array of every split, from the same generator. Both packages
    are pinned to the numpy sampler so the test does not depend on a
    compiler."""
    monkeypatch.setattr(jnative, "load_library", lambda: None)
    monkeypatch.setattr(tnative, "load_library", lambda: None)
    _, edges = tio.load_fb_pages_food()
    n = int(edges.max()) + 1
    dj = jtwowl.build_twowl_data(edges, n, rng=np.random.default_rng(seed))
    dt = ttwowl.build_twowl_data(edges, n, rng=np.random.default_rng(seed))
    _assert_fields_equal(dt, dj)
    assert dt.train.num_msg == dj.train.num_msg
    assert dt.test.num_rows == dj.test.num_rows


def test_twowl_helpers_equal():
    pairs, n = _pairs(8, n=25, e=60)
    np.testing.assert_array_equal(ttwowl.double_pairs(pairs),
                                  jtwowl.double_pairs(pairs))
    msg = jtwowl.double_pairs(pairs[:40])
    pred = jtwowl.double_pairs(pairs[40:])
    np.testing.assert_array_equal(ttwowl.build_ei2(n, msg, pred),
                                  jtwowl.build_ei2(n, msg, pred))


@pytest.mark.parametrize("name,kw", [
    ("synth_powerlaw_graph", {}),
    ("synth_powerlaw_graph", {"alpha": 0.7, "seed": 3}),
    ("synth_community_graph", {}),
    ("synth_community_graph", {"n_comm": 7, "p_intra": 0.8, "seed": 2}),
], ids=["powerlaw", "powerlaw alpha seed", "community", "community 7"])
def test_synthetic_generators_equal(name, kw):
    lo_j, hi_j = getattr(jscaling, name)(900, 3000, **kw)
    lo_t, hi_t = getattr(tsynth, name)(900, 3000, **kw)
    np.testing.assert_array_equal(lo_t, lo_j)
    np.testing.assert_array_equal(hi_t, hi_j)
    assert (lo_t < hi_t).all() and len(lo_t) <= 3000


# ---------------------------------------------------------------------------
# the bounds and library yardsticks of chip_smoke.py
# ---------------------------------------------------------------------------

# five output rows over a 6-row x: row 0 names rows 1 and 2, row 1 names
# row 2 twice (one weight 0), row 2 is all pads, row 3 names row 9 (outside
# x) and row 5, row 4 names rows 0 and 1
_NBR = torch.tensor([[1, 2, 0], [2, 2, 0], [0, 0, 0], [9, 5, 0], [0, 1, 0]],
                    dtype=torch.int32)
_W = torch.tensor([[1., 2., 0.], [3., 0., 0.], [0., 0., 0.], [4., 5., 0.],
                   [6., 7., 0.]])


def test_spmm_ell_work_by_hand():
    x = torch.arange(6 * 8, dtype=torch.float32).reshape(6, 8)
    nbytes, flops = cs.spmm_ell_work(_NBR, _W, x)
    # live slots: (1, 2), (2), (), (5), (0, 1) = 6; rows of x named: 0, 1, 2,
    # 5 = 4
    assert nbytes == 4 * 8 * 4 + 6 * (4 + 4) + 5 * 8 * 4
    assert flops == 2 * 6 * 8
    b = cs.bound((nbytes, flops))
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert cs.bound((10, 10**9))["bound_by"] == "operations"
    assert cs.bound((10, 10**9))["bound_ms"] == pytest.approx(1e9 / 67e12 * 1e3)


def test_spmm_bucketed_work_by_hand():
    # the same five rows as two buckets: width 1 (rows 1, 2 of the layout
    # above, cut to a slot) and width 2; inv_perm also names the zero row
    shapes = ((2, 1), (3, 2))
    nbr = torch.tensor([2, 0, 1, 2, 9, 5, 0, 1], dtype=torch.int32)
    w = torch.tensor([3., 0., 1., 2., 4., 5., 6., 7.])
    inv_perm = torch.tensor([2, 0, 1, 3, 4, 5], dtype=torch.int32)
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        x = torch.ones((6, 8), dtype=dtype)
        nbytes, flops = cs.spmm_bucketed_work(x, inv_perm, shapes, nbr, w)
        assert nbytes == (4 * 8 * size + 6 * (4 + 4) + 6 * 4
                          + 6 * 8 * size)
        assert flops == 2 * 6 * 8
    # the library yardstick's matrix is the same function
    x = torch.arange(6 * 8, dtype=torch.float32).reshape(6, 8)
    got = torch.sparse.mm(cs.bucketed_csr(inv_perm, shapes, nbr, w, 6), x)
    torch.testing.assert_close(
        got, hk.spmm_bucketed_reference(x, inv_perm, shapes, nbr, w))
    assert not got[5].any() and not got[2].any() and got[1].any()
    got = torch.sparse.mm(cs.ell_csr(_NBR, _W, 6), x)
    torch.testing.assert_close(got, hk.spmm_ell_reference(_NBR, _W, x))


def test_sddmm_work_by_hand():
    src = torch.tensor([0, 1, 1, 7, 2], dtype=torch.int32)
    dst = torch.tensor([1, 1, 3, 0, -1], dtype=torch.int32)
    x = torch.ones((4, 16), dtype=torch.bfloat16)
    y = torch.ones((5, 16), dtype=torch.bfloat16)
    # pairs inside both tables: (0, 1), (1, 1), (1, 3); x rows 0, 1; y rows
    # 1, 3
    nbytes, flops = cs.sddmm_work(src, dst, x, y)
    assert nbytes == (2 + 2) * 16 * 2 + 5 * (4 + 4) + 5 * 4
    assert flops == 2 * 3 * 16
    # one table on both sides: rows 0, 1, 3 once
    nbytes, _ = cs.sddmm_work(src, dst, x, x)
    assert nbytes == 3 * 16 * 2 + 5 * (4 + 4) + 5 * 4


def test_sddmm_grad_work_by_hand():
    """K2's gradient: the outputs written in full, the rows that pairs
    inside both tables name read once from the table the gradient reads,
    the order (2E), both index arrays and g read once."""
    src = torch.tensor([0, 1, 1, 7, 2], dtype=torch.int32)
    dst = torch.tensor([1, 1, 3, 0, -1], dtype=torch.int32)
    g = torch.ones(5)
    x = torch.ones((4, 16), dtype=torch.bfloat16)
    y = torch.ones((5, 16), dtype=torch.bfloat16)
    # pairs inside both tables: (0, 1), (1, 1), (1, 3): dx reads y rows 1,
    # 3; dy reads x rows 0, 1
    nbytes, flops = cs.sddmm_grad_work(g, src, dst, x, y)
    assert nbytes == ((4 + 5) * 16 * 2 + (2 + 2) * 16 * 2 + 2 * 5 * 4
                      + 5 * (4 + 4 + 4))
    assert flops == 2 * 2 * 3 * 16
    # one table: dh written once, rows 0, 1, 3 read once
    nbytes, _ = cs.sddmm_grad_work(g, src, dst, x)
    assert nbytes == (4 * 16 * 2 + 3 * 16 * 2 + 2 * 5 * 4
                      + 5 * (4 + 4 + 4))


@pytest.mark.parametrize("seed", [0, 1])
def test_library_matrices_match_the_plain_versions(seed):
    """`bucketed_csr` and `ell_csr` on the layouts the port builds: a graph's
    `BucketedEll` and a composed gather-sum with sentinel pads."""
    rng = np.random.default_rng(seed)
    pairs, n = _pairs(seed, n=50, e=180)
    g = tgraph.Graph.from_undirected_edges(pairs[:, 0], pairs[:, 1],
                                           num_nodes=n + 3)
    ops = tspmm.BucketedEll.from_graph(g).operands("cpu")
    x = torch.from_numpy(rng.standard_normal((n + 3, 9)).astype(np.float32))
    torch.testing.assert_close(
        torch.sparse.mm(cs.bucketed_csr(*ops, n + 3), x),
        hk.spmm_bucketed_reference(x, *ops))
    ids = rng.integers(0, 41, 300)  # 40 = the sentinel segment
    src = np.where(ids < 40, rng.integers(0, 300, 300), 300)
    plan = tseg.SegmentPlan.build(ids, 40)
    cops = tseg.composed_operands(plan, src, 300, "cpu")
    xs = torch.from_numpy(rng.standard_normal((300, 5)).astype(np.float32))
    torch.testing.assert_close(
        torch.sparse.mm(cs.bucketed_csr(*cops.k3[:4], 300), xs),
        hk.spmm_bucketed_reference(xs, *cops.k3))
    slots, w = plan.ell_operands("cpu")
    torch.testing.assert_close(
        torch.sparse.mm(cs.ell_csr(slots, w, 300), xs),
        hk.spmm_ell_reference(slots, w, xs))
    xe, k3e = cs.edge_case_operands(cops.k3, xs)
    got = hk.spmm_bucketed(xe, *k3e)
    assert torch.isfinite(got).all() and not got[3].any()


@pytest.mark.parametrize("case", ["random", "hub and repeats", "outside"])
def test_gradient_library_matrix_matches_the_plain_gradient(case):
    """`sddmm_grad_csr`, the library yardstick of K2's one-table gradient:
    `torch.sparse.mm` of it with the table is the plain gradient, with a
    hub named by a third of the pairs and every pair twice, and with pairs
    outside the table (left out, as they contribute nothing)."""
    rng = np.random.default_rng(21)
    n, e = 40, 300
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if case == "hub and repeats":
        src[::3] = 5
        src, dst = np.tile(src[: e // 2], 2), np.tile(dst[: e // 2], 2)
    if case == "outside":
        src[::7], dst[3::11] = -1, n
    g = torch.from_numpy(rng.standard_normal(e).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, 12)).astype(np.float32))
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    torch.testing.assert_close(
        torch.sparse.mm(cs.sddmm_grad_csr(g, s, d, n), x),
        hk.sddmm_grad_reference(g, s, d, x)[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("captures, expect, estimated", [
    # the first two captures agree
    ([(1.00, False), (1.02, False)], 1.01, 0),
    # a capture at half its time is left out
    ([(0.50, False), (1.00, False), (1.04, False)], 1.02, 0),
    # a capture the profiler gave up on, then a pair with an estimate in it
    ([(None, False), (2.0, True), (2.0, False)], 2.0, 1),
])
def test_kernel_ms_takes_two_captures_that_agree(monkeypatch, capsys,
                                                 captures, expect, estimated):
    feed = iter(captures)
    monkeypatch.setattr(cs, "profiled_ms", lambda fn, iters, dropped:
                        next(feed))
    before = cs.ESTIMATED_READINGS[0]
    assert cs.kernel_ms(lambda: None) == pytest.approx(expect)
    assert cs.ESTIMATED_READINGS[0] - before == estimated
    # more than two captures are printed, two that agree at once are not
    printed = "kernel_ms_captures" in capsys.readouterr().out
    assert printed == (len(captures) > 2)


def test_kernel_ms_fails_when_no_two_captures_agree(monkeypatch):
    feed = iter([(float(2 ** i), False) for i in range(8)])
    monkeypatch.setattr(cs, "profiled_ms", lambda fn, iters, dropped:
                        next(feed))
    with pytest.raises(AssertionError, match="no two of eight"):
        cs.kernel_ms(lambda: None)


# ---------------------------------------------------------------------------
# node2vec's native routines, the progress line, comma-separated edge lists
# ---------------------------------------------------------------------------


def _walk_graph(seed, weighted):
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, 50, 180), rng.integers(0, 50, 180)
    keep = u != v
    src, dst = np.concatenate([u[keep], v[keep]]), np.concatenate(
        [v[keep], u[keep]])
    w = np.tile(rng.uniform(0.5, 2.0, keep.sum()).astype(np.float32), 2)
    return tgraph.Graph.from_edges(src, dst, num_nodes=50,
                                   weight=w if weighted else None)


def test_native_build_alias_rows_equal():
    if not (jnative.available() and tnative.available()):
        pytest.skip("no C++ compiler: the alias routine is not built")
    rng = np.random.default_rng(0)
    probs = rng.random((200, 17))
    valid = np.arange(17)[None, :] < rng.integers(0, 18, 200)[:, None]
    for got, ref in zip(tnative.build_alias_rows(probs, valid),
                        jnative.build_alias_rows(probs, valid)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("weighted", [False, True])
def test_native_edge_bias_probs_equal(weighted):
    if not (jnative.available() and tnative.available()):
        pytest.skip("no C++ compiler: the bias routine is not built")
    g = _walk_graph(1, weighted)
    args = (g.src, g.dst, g.nbr, g.nbr_mask, g.indptr, g.indices, 0.25, 4.0)
    got = tnative.edge_bias_probs(*args, nbr_weight=g.nbr_weight)
    ref = jnative.edge_bias_probs(*args, nbr_weight=g.nbr_weight)
    assert got.dtype == np.float64 and got.shape == (g.num_edges,
                                                      g.nbr.shape[1])
    np.testing.assert_array_equal(got, ref)
    if not weighted:  # 1/p to return, 1 to a common neighbor, 1/q outward
        assert set(np.unique(got[g.nbr_mask[g.dst]])) <= {4.0, 1.0, 0.25}


def test_native_seal_entry_points_equal():
    """`extract_subgraphs_csr` and `drnl_tags_batch` of the port's library
    against the JAX package's: the same source, the same arrays."""
    e, n = _pairs(4, n=80, e=400)
    e = e[e[:, 0] != e[:, 1]]
    g = tgraph.Graph.from_undirected_edges(e[:, 0], e[:, 1], num_nodes=n)
    pairs = np.random.default_rng(1).integers(0, 80, (30, 2))
    got = tnative.extract_subgraphs_csr(g.indptr, g.indices, 80, pairs, 2,
                                        16, seed=3)
    ref = jnative.extract_subgraphs_csr(g.indptr, g.indices, 80, pairs, 2,
                                        16, seed=3)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    nodes, mask, adj, sizes = got
    np.testing.assert_array_equal(tnative.drnl_tags_batch(adj, mask, sizes),
                                  jnative.drnl_tags_batch(adj, mask, sizes))


@pytest.mark.parametrize("hop", [1, 2])
def test_subgraph_host_functions_equal(hop):
    """The dense extraction, tag compaction and host input assembly of
    `data.subgraph` against the JAX package's on a shared generator."""
    from linkpred_tpu.data import subgraph as jsg
    from linkpred_tpu_torch.data import subgraph as tsg

    pairs, n = _pairs(hop, n=40, e=120)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    adj = np.zeros((n, n), dtype=bool)
    adj[pairs[:, 0], pairs[:, 1]] = adj[pairs[:, 1], pairs[:, 0]] = True
    targets = pairs[:12]
    got = tsg.build_subgraph_batch(targets, adj, hop, 10,
                                   np.random.default_rng(0), device="cpu")
    ref = jsg.build_subgraph_batch(targets, adj, hop, 10,
                                   np.random.default_rng(0))
    _assert_fields_equal(got, ref)
    emb = np.random.default_rng(2).standard_normal((n, 3)).astype(np.float32)
    for a, b in zip(tsg.gnn_inputs(got, emb), jsg.gnn_inputs(ref, emb)):
        np.testing.assert_array_equal(a, b)


def test_native_alias_routines_without_library(monkeypatch):
    """Without the library `build_alias_rows` takes the numpy version and
    `edge_bias_probs` raises (its caller then takes its numpy path)."""
    from linkpred_tpu_torch.ops import walk as twalk

    monkeypatch.setattr(tnative, "load_library", lambda: None)
    probs = np.random.default_rng(2).random((6, 5))
    valid = np.ones((6, 5), bool)
    for got, ref in zip(tnative.build_alias_rows(probs, valid),
                        twalk.alias_setup_rows(probs, valid)):
        np.testing.assert_array_equal(got, ref)
    g = _walk_graph(3, False)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        tnative.edge_bias_probs(g.src, g.dst, g.nbr, g.nbr_mask, g.indptr,
                                g.indices, 0.5, 2.0)
    tables = twalk.AliasTables.build(g, p=0.5, q=2.0)  # the numpy path
    assert tables.edge_J.shape == (g.num_edges, g.nbr.shape[1])


def test_alias_tables_numpy_path_close_to_native(monkeypatch):
    """The dense numpy path of `AliasTables.build` builds the same
    distributions as the C++ path: the alias tables may pair slots in
    another order, so the per-slot probabilities are compared."""
    if not tnative.available():
        pytest.skip("no C++ compiler")
    from linkpred_tpu_torch.ops import walk as twalk

    def slot_probs(J, q, deg):
        out = np.zeros(J.shape)
        for r in range(J.shape[0]):
            for k in range(deg[r]):
                out[r, k] += q[r, k] / deg[r]
                out[r, J[r, k]] += (1.0 - q[r, k]) / deg[r]
        return out

    g = _walk_graph(4, True)
    native_tab = twalk.AliasTables.build(g, p=0.25, q=4.0)
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "load_library", lambda: None)
    numpy_tab = twalk.AliasTables.build(g, p=0.25, q=4.0)
    deg = g.nbr_mask[g.dst].sum(axis=1)
    np.testing.assert_allclose(
        slot_probs(numpy_tab.edge_J, numpy_tab.edge_q, deg),
        slot_probs(native_tab.edge_J, native_tab.edge_q, deg), atol=1e-6)


def test_live_progress_equal():
    """The port's copy of the progress line writes what the original
    writes, on a stream that is no terminal."""
    import io as stdio

    from linkpred_tpu.utils import progress as jprogress
    from linkpred_tpu_torch.utils import progress as tprogress

    outs = []
    for mod in (tprogress, jprogress):
        stream = stdio.StringIO()
        bar = mod.LiveProgress(40, label="twowl-scale", stream=stream)
        for step in range(1, 41):
            bar.update(step, loss=1.0 / step,
                       auc=0.5 + step / 100 if step % 4 == 0 else -1.0)
        bar.close()
        outs.append(stream.getvalue())
        assert mod.sparkline([1, 2, float("nan"), -1.0, 3]) == \
            tprogress.sparkline([1, 2, 3])
    assert outs[0] == outs[1] and outs[0].count("\n") >= 10


def test_load_edgelist_reads_comma_separated(tmp_path):
    """The port's loader also takes the comma-separated fb-pages-food dump,
    which the `node2vec` command is run on; the result is the whitespace
    file's."""
    path = os.path.join(REPO, "raw_data", "fb-pages-food",
                        "fb-pages-food.edges")
    pairs = np.loadtxt(path, delimiter=",", dtype=np.int64)
    spaced = tmp_path / "fb.edgelist"
    np.savetxt(spaced, pairs, fmt="%d")
    _assert_fields_equal(tio.load_edgelist(path),
                         jio.load_edgelist(str(spaced)))


def test_native_libraries_loaded_in_every_process():
    """The build at import leaves both libraries loaded: no test of the
    C++ plane in this process skips or falls back for want of one."""
    assert tnative.available() and jnative.available()
    assert tnative.library_path().exists()
