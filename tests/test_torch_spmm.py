"""Parity of the port's bucketed SpMM (`linkpred_tpu_torch.ops.spmm`) and
SDDMM (`ops.sddmm`) with the JAX package, and of the plain versions of
kernels K3 and K2 with the TPU kernels in interpret mode.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: host structures are array-equal. f32 results: rtol 1e-5, atol
1e-6 (sums of at most 64 products taken in another order). bf16 results:
both sides sum in f32 and round once to bf16, so they differ by at most one
bf16 ulp where the two f32 sums straddle a rounding boundary: rtol 8e-3
(2^-7), atol 1e-2 for sums that cancel to near 0. The Pallas kernels' own
test holds them to 1e-4 against numpy; so do these.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linkpred_tpu.data.graph import Graph
from linkpred_tpu.ops import pallas_kernels as jpk
from linkpred_tpu.ops import sddmm as jsd
from linkpred_tpu.ops import spmm as jspmm
from linkpred_tpu_torch.ops import hopper_kernels as hk
from linkpred_tpu_torch.ops import sddmm as tsd
from linkpred_tpu_torch.ops import spmm as tspmm

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL, BF16_ATOL = 8e-3, 1e-2


def _np(t):
    return t.detach().float().cpu().numpy()


def _gcn_weights(g):
    """The GCN slice's symmetric normalisation on `g`'s ELL view."""
    d = np.asarray(g.degree, np.float64) + 1.0
    inv = (1.0 / np.sqrt(d)).astype(np.float32)
    w = inv[:, None] * inv[np.asarray(g.nbr)]
    return dataclasses.replace(g, nbr_weight=np.ascontiguousarray(w))


def _graph(n, m, seed, isolated=0, weighted=True):
    """Random undirected graph on `n` nodes; the last `isolated` nodes have
    degree 0."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n - isolated, m)
    v = rng.integers(0, n - isolated, m)
    g = Graph.from_undirected_edges(u, v, num_nodes=n)
    return _gcn_weights(g) if weighted else g


def _hub_graph(seed=7, n=80, cap=6):
    """4 hubs joined to every node plus a random tail, capped symmetrically
    (as `tests/test_parallel.py::TestNodeShardedSymVJP`)."""
    rng = np.random.default_rng(seed)
    hubs = np.arange(4)
    u = np.concatenate([np.repeat(hubs, n - 1), rng.integers(0, n, 120)])
    v = np.concatenate([np.tile(np.arange(1, n), 4) % n,
                        rng.integers(0, n, 120)])
    keep = u != v
    g = Graph.from_undirected_edges(u[keep], v[keep], num_nodes=n)
    g = g.with_degree_cap(cap, rng=np.random.default_rng(seed), symmetric=True)
    assert int(g.degree.max()) <= cap
    return _gcn_weights(g)


def _dense(g):
    a = np.zeros((g.num_nodes, g.num_nodes), np.float64)
    nbr, m = np.asarray(g.nbr), np.asarray(g.nbr_mask)
    w = np.ones(nbr.shape) if g.nbr_weight is None else g.nbr_weight
    for i in range(g.num_nodes):
        a[i, nbr[i][m[i]]] = w[i][m[i]]
    return a


GRAPHS = {
    "weighted+isolated": lambda: _graph(60, 150, 0, isolated=7),
    "unweighted": lambda: _graph(45, 300, 1, weighted=False),
    "hubs capped": _hub_graph,
    "no edges": lambda: Graph.from_undirected_edges(
        np.zeros(0, np.int64), np.zeros(0, np.int64), num_nodes=9),
}


# ---------------------------------------------------------------------------
# host layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("min_width", [1, 2, 4])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_bucketed_ell_build_equal(name, min_width):
    g = GRAPHS[name]()
    lt = tspmm.BucketedEll.build(g.nbr, g.nbr_mask, g.nbr_weight, min_width)
    lj = jspmm.BucketedEll.build(g.nbr, g.nbr_mask, g.nbr_weight, min_width)
    assert (lt.num_nodes, lt.num_edges) == (lj.num_nodes, lj.num_edges)
    np.testing.assert_array_equal(lt.inv_perm, lj.inv_perm)
    assert lt.inv_perm.dtype == np.int32
    assert len(lt.buckets) == len(lj.buckets)
    for bt, bj in zip(lt.buckets, lj.buckets):
        for a, b in zip(bt, bj):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_operands_flatten_the_buckets():
    g = _graph(60, 150, 0, isolated=7)
    lay = tspmm.BucketedEll.from_graph(g)
    inv_perm, shapes, nbr, w = lay.operands("cpu")
    assert inv_perm.dtype == nbr.dtype == torch.int32
    assert w.dtype == torch.float32
    assert shapes == tuple(nb.shape for _, nb, _ in lay.buckets)
    np.testing.assert_array_equal(
        nbr.numpy(), np.concatenate([nb.ravel() for _, nb, _ in lay.buckets]))
    np.testing.assert_array_equal(
        w.numpy(), np.concatenate([wb.ravel() for _, _, wb in lay.buckets]))
    # degree-0 nodes map to the zero row past the concat rows
    n_rows = sum(r for r, _ in shapes)
    assert (inv_perm.numpy()[np.asarray(g.degree) == 0] == n_rows).all()
    # the optional launch order: a permutation of the rows, widest bucket first
    order = hk.launch_order(inv_perm.numpy())
    assert order.dtype == np.int32
    np.testing.assert_array_equal(np.sort(order), np.arange(g.num_nodes))
    assert (np.diff(inv_perm.numpy()[order]) <= 0).all()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f", [1, 8, 33])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_spmm_bucketed_f32_matches_jax_and_dense(name, f):
    g = GRAPHS[name]()
    x = np.random.default_rng(f).standard_normal((g.num_nodes, f)).astype(
        np.float32)
    ops = tspmm.BucketedEll.from_graph(g).operands("cpu")
    got = tspmm.spmm_bucketed(torch.from_numpy(x), g.num_nodes, *ops)
    assert got.dtype == torch.float32 and got.shape == (g.num_nodes, f)
    ref = jspmm.spmm_bucketed(jnp.asarray(x), g.num_nodes,
                              *jspmm.BucketedEll.from_graph(g).operands())
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(got), _dense(g) @ x, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("f", [16, 64])
def test_spmm_bucketed_bf16_matches_jax(f):
    g = _hub_graph()
    x = np.random.default_rng(3).standard_normal((g.num_nodes, f)).astype(
        np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ops = tspmm.BucketedEll.from_graph(g).operands("cpu")
    got = tspmm.spmm_bucketed(xt, g.num_nodes, *ops)
    assert got.dtype == torch.bfloat16
    ref = jspmm.spmm_bucketed(jnp.asarray(x).astype(jnp.bfloat16),
                              g.num_nodes,
                              *jspmm.BucketedEll.from_graph(g).operands())
    assert ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                               rtol=BF16_RTOL, atol=BF16_ATOL)
    # against the f64 product of the bf16-rounded inputs: one rounding
    xr = xt.float().numpy().astype(np.float64)
    wr = torch.from_numpy(_dense(g).astype(np.float32)).to(
        torch.bfloat16).double().numpy()
    np.testing.assert_allclose(_np(got), wr @ xr, rtol=BF16_RTOL,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("f", [8, 33])
def test_spmm_bucketed_reference_matches_pallas_rowdma(f):
    """K3's plain version against the TPU kernel `spmm_rowdma_bucketed` in
    interpret mode; that kernel takes the (ids, nbr, w) triples without
    `inv_perm` and merges the buckets by row `.set`."""
    g = _graph(60, 150, 0, isolated=7)
    x = np.random.default_rng(f).standard_normal((g.num_nodes, f)).astype(
        np.float32)
    got = hk.spmm_bucketed_reference(
        torch.from_numpy(x), *tspmm.BucketedEll.from_graph(g).operands("cpu"))
    ref = jpk.spmm_rowdma_bucketed(
        jnp.asarray(x), g.num_nodes,
        *jspmm.BucketedEll.from_graph(g).operands()[1:])
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_spmm_bucketed_guards_indices_and_zero_weights():
    """Slots outside [0, NX) or of weight 0 contribute nothing; an
    `inv_perm` entry equal to the concat row count gives a zero row."""
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 1.0
    inv_perm = torch.tensor([0, 2, 1, 3], dtype=torch.int32)
    shapes = ((1, 2), (2, 1))
    nbr = torch.tensor([1, 7, -1, 3], dtype=torch.int32)
    w = torch.tensor([2.0, 5.0, 1.0, 0.0])
    got = hk.spmm_bucketed(x, inv_perm, shapes, nbr, w)
    expect = torch.stack([2.0 * x[1], torch.zeros(3), torch.zeros(3),
                          torch.zeros(3)])
    torch.testing.assert_close(got, expect, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["hubs capped", "weighted+isolated"])
def test_spmm_bucketed_sym_grad_matches_jax(name):
    g = GRAPHS[name]()
    a = _dense(g)
    assert np.allclose(a, a.T)  # the symmetric VJP is right only for A == A^T
    rng = np.random.default_rng(11)
    x = rng.standard_normal((g.num_nodes, 8)).astype(np.float32)
    t = rng.standard_normal((g.num_nodes, 8)).astype(np.float32)

    ops_j = jspmm.BucketedEll.from_graph(g).operands()

    def loss_j(xx):
        return jnp.sum(jspmm.spmm_bucketed_sym(xx, g.num_nodes, ops_j) * t)

    gj = np.asarray(jax.grad(loss_j)(jnp.asarray(x)))
    ops = tspmm.BucketedEll.from_graph(g).operands("cpu")
    for sym in (tspmm.spmm_bucketed_sym, tspmm.spmm_bucketed_sym_reference):
        xt = torch.from_numpy(x).requires_grad_()
        (sym(xt, g.num_nodes, ops) * torch.from_numpy(t)).sum().backward()
        np.testing.assert_allclose(_np(xt.grad), gj, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_np(xt.grad), a.T @ t, rtol=RTOL,
                                   atol=1e-5)


def test_spmm_bucketed_sym_bf16_grad_dtype():
    g = _hub_graph()
    ops = tspmm.BucketedEll.from_graph(g).operands("cpu")
    x = torch.randn((g.num_nodes, 16), generator=torch.Generator().manual_seed(0))
    xb = x.to(torch.bfloat16).requires_grad_()
    out = tspmm.spmm_bucketed_sym(xb, g.num_nodes, ops)
    out.float().sum().backward()
    assert out.dtype == xb.grad.dtype == torch.bfloat16
    ones = torch.ones_like(x)
    expect = hk.spmm_bucketed_reference(ones.to(torch.bfloat16), *ops)
    torch.testing.assert_close(xb.grad, expect, rtol=0, atol=0)


def test_spmm_bucketed_row_count_checked():
    g = _graph(20, 40, 0)
    ops = tspmm.BucketedEll.from_graph(g).operands("cpu")
    with pytest.raises(ValueError, match="rows"):
        tspmm.spmm_bucketed(torch.zeros((20, 4)), 21, *ops)


# ---------------------------------------------------------------------------
# SDDMM (K2)
# ---------------------------------------------------------------------------


def _sddmm_inputs(n, e, f, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.standard_normal((n, f)).astype(np.float32)
    return src, dst, x, y


@pytest.mark.parametrize("n,e,f", [(50, 130, 24), (7, 1, 1), (40, 300, 33)])
def test_sddmm_reference_matches_pallas_and_coo(n, e, f):
    src, dst, x, y = _sddmm_inputs(n, e, f, e)
    got = hk.sddmm_reference(*map(torch.from_numpy, (src, dst, x, y)))
    assert got.dtype == torch.float32 and got.shape == (e,)
    pallas = jpk.sddmm_pallas(*map(jnp.asarray, (src, dst, x, y)),
                              block_edges=32, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(pallas), rtol=1e-4,
                               atol=1e-4)
    coo = jsd.sddmm_coo(*map(jnp.asarray, (src, dst, x, y)))
    np.testing.assert_allclose(_np(got), np.asarray(coo), rtol=RTOL,
                               atol=ATOL)


def test_sddmm_reference_guards_indices():
    x = torch.ones((3, 4))
    src = torch.tensor([0, 3, -1, 2], dtype=torch.int32)
    dst = torch.tensor([1, 0, 0, 5], dtype=torch.int32)
    torch.testing.assert_close(hk.sddmm_reference(src, dst, x, x),
                               torch.tensor([4.0, 0.0, 0.0, 0.0]))


@pytest.mark.parametrize("two_tables", [True, False])
def test_sddmm_coo_grad_matches_jax(two_tables):
    src, dst, x, y = _sddmm_inputs(30, 90, 7, 2)
    t = np.random.default_rng(5).standard_normal(90).astype(np.float32)

    def loss_j(xx, yy):
        return jnp.sum(jsd.sddmm_coo(src, dst, xx, yy if two_tables else None)
                       * t)

    gx, gy = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    out = tsd.sddmm_coo(torch.from_numpy(src), torch.from_numpy(dst), xt,
                        yt if two_tables else None)
    (out * torch.from_numpy(t)).sum().backward()
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx), rtol=RTOL,
                               atol=ATOL)
    if two_tables:
        np.testing.assert_allclose(_np(yt.grad), np.asarray(gy), rtol=RTOL,
                                   atol=ATOL)
    else:
        assert yt.grad is None


def test_sddmm_coo_bf16_matches_jax():
    src, dst, x, y = _sddmm_inputs(64, 500, 128, 9)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tsd.sddmm_coo(torch.from_numpy(src), torch.from_numpy(dst), xb)
    assert got.dtype == torch.bfloat16
    ref = jsd.sddmm_coo(jnp.asarray(src), jnp.asarray(dst),
                        jnp.asarray(x).astype(jnp.bfloat16))
    assert ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


# ---------------------------------------------------------------------------
# K2's gradient (`hopper_kernels.sddmm_grad`; its plain version on the CPU)
# against `jax.vjp` of the reference's `sddmm_coo`
# ---------------------------------------------------------------------------


def _grad_case(n, e, f, seed, hub=None, repeats=False):
    """Pairs, two tables and a cotangent from `seed`; `hub` names node 3 in
    that many pairs (at either end), `repeats` makes every pair appear
    twice."""
    src, dst, x, y = _sddmm_inputs(n, e, f, seed)
    rng = np.random.default_rng(seed + 1)
    if hub:
        at = rng.choice(e, hub, replace=False)
        src[at[: hub // 2]] = 3
        dst[at[hub // 2:]] = 3
    if repeats:
        src, dst = np.tile(src[: e // 2], 2), np.tile(dst[: e // 2], 2)
    g = rng.standard_normal(len(src)).astype(np.float32)
    return src, dst, x, y, g


def _jax_grad(src, dst, x, y, g, two_tables):
    """`jax.vjp` of the reference's `sddmm_coo` in f32: (dx, dy or None)."""
    if two_tables:
        _, vjp = jax.vjp(lambda a, b: jsd.sddmm_coo(src, dst, a, b),
                         jnp.asarray(x), jnp.asarray(y))
        return tuple(np.asarray(v) for v in vjp(jnp.asarray(g)))
    _, vjp = jax.vjp(lambda a: jsd.sddmm_coo(src, dst, a), jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(g))[0]), None


def _port_grad(src, dst, x, y, g, two_tables, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype)
    yt = torch.from_numpy(y).to(dtype) if two_tables else None
    return hk.sddmm_grad(torch.from_numpy(g), torch.from_numpy(src),
                         torch.from_numpy(dst), xt, yt)


@pytest.mark.parametrize("two_tables", [False, True],
                         ids=["one table", "two tables"])
@pytest.mark.parametrize("case", ["random", "hub and repeats"])
def test_sddmm_grad_matches_jax_vjp(two_tables, case):
    """f32: the plain gradient against `jax.vjp` of the reference, with
    random pairs, and with a hub named by 400 of 1,000 pairs and every pair
    repeated; with one table both ends' terms land in one gradient."""
    if case == "random":
        src, dst, x, y, g = _grad_case(60, 700, 24, 11)
    else:
        src, dst, x, y, g = _grad_case(60, 1000, 24, 12, hub=400,
                                       repeats=True)
    dx, dy = _port_grad(src, dst, x, y, g, two_tables)
    jx, jy = _jax_grad(src, dst, x, y, g, two_tables)
    assert dx.dtype == torch.float32 and dx.shape == x.shape
    np.testing.assert_allclose(_np(dx), jx, rtol=RTOL, atol=ATOL * 10)
    if two_tables:
        np.testing.assert_allclose(_np(dy), jy, rtol=RTOL, atol=ATOL * 10)
    else:
        assert dy is None


@pytest.mark.parametrize("two_tables", [False, True],
                         ids=["one table", "two tables"])
def test_sddmm_grad_bf16_matches_jax_vjp(two_tables):
    """bf16 tables: the port sums in f32 and rounds once to bf16; the
    reference's vjp, taken in f32 on the same bf16 values, is rounded once
    to bf16 too. Compared in f32 within one bf16 ulp (rtol 2^-7), atol 1e-2
    where a sum cancels to near 0; F = 128, the GCN's width."""
    src, dst, x, y, g = _grad_case(64, 600, 128, 13, hub=150)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    yb = torch.from_numpy(y).to(torch.bfloat16)
    dx, dy = _port_grad(src, dst, xb.float().numpy(), yb.float().numpy(), g,
                        two_tables, torch.bfloat16)
    jx, jy = _jax_grad(src, dst, xb.float().numpy(), yb.float().numpy(), g,
                       two_tables)
    assert dx.dtype == torch.bfloat16
    for got, ref in ((dx, jx), (dy, jy)):
        if ref is None:
            assert got is None
            continue
        once = torch.tensor(ref).to(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(_np(got), once, rtol=BF16_RTOL,
                                   atol=BF16_ATOL)


@pytest.mark.parametrize("two_tables", [False, True],
                         ids=["one table", "two tables"])
def test_sddmm_grad_no_pairs_and_outside_indices(two_tables):
    """E = 0 gives zero gradients; a pair with an index outside its table
    scored 0 and contributes nothing (the reference's gather would clamp or
    wrap such an index, so its cotangent is zeroed there). With two tables
    x has one row more than y, a NaN row that only such pairs name."""
    src, dst, x, y, g = _grad_case(40, 300, 16, 14)
    empty = np.zeros(0, np.int32)
    dx, dy = _port_grad(empty, empty, x, y, np.zeros(0, np.float32),
                        two_tables)
    assert not _np(dx).any() and (dy is None or not _np(dy).any())
    src[::7], dst[3::11] = -1, 40
    if two_tables:
        src[5::13], dst[5::13] = 40, 40
        x = np.concatenate([x, np.full((1, 16), np.nan, np.float32)])
    outside = (src < 0) | (dst >= 40)
    g_in = np.where(outside, 0.0, g).astype(np.float32)
    dx, dy = _port_grad(src, dst, x, y, g, two_tables)
    if two_tables:
        clean = np.where(np.isnan(x), 0.0, x).astype(np.float32)
        jx, jy = _jax_grad(src, dst, clean, y, g_in, True)
        np.testing.assert_allclose(_np(dy), jy, rtol=RTOL, atol=ATOL * 10)
    else:
        jx, _ = _jax_grad(src, dst, x, y, g_in, False)
    np.testing.assert_allclose(_np(dx), jx, rtol=RTOL, atol=ATOL * 10)


@pytest.mark.parametrize("two_tables", [False, True],
                         ids=["one table", "two tables"])
def test_incidence_order_is_numpy_stable_argsort(two_tables):
    """K2's gradient order, for one batch and for a stack of three, is
    numpy's stable argsort of the receiving rows (one sort over both ends,
    or each end apart), as int32."""
    rng = np.random.default_rng(15)
    src = rng.integers(-1, 30, (3, 200)).astype(np.int32)
    dst = rng.integers(0, 31, (3, 200)).astype(np.int32)
    got = hk.incidence_order(torch.from_numpy(src), torch.from_numpy(dst),
                             two_tables)
    assert got.dtype == torch.int32 and got.shape == (3, 400)
    for b in range(3):
        if two_tables:
            ref = np.concatenate([np.argsort(src[b], kind="stable"),
                                  200 + np.argsort(dst[b], kind="stable")])
        else:
            ref = np.argsort(np.concatenate([src[b], dst[b]]), kind="stable")
        np.testing.assert_array_equal(got[b].numpy(), ref)
        one = hk.incidence_order(torch.from_numpy(src[b]),
                                 torch.from_numpy(dst[b]), two_tables)
        np.testing.assert_array_equal(one.numpy(), ref)


@pytest.mark.parametrize("two_tables", [False, True],
                         ids=["one table", "two tables"])
def test_sddmm_coo_backward_is_the_plain_gradient(two_tables):
    """`sddmm_coo`'s backward on CPU tensors gives `sddmm_grad`'s plain
    version bit for bit (one table: one gradient, both ends' terms in it),
    and the reference's autodiff within f32 tolerance."""
    src, dst, x, y, g = _grad_case(50, 400, 16, 16, hub=100)
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_() if two_tables else None
    out = tsd.sddmm_coo(torch.from_numpy(src), torch.from_numpy(dst), xt, yt)
    (out * torch.from_numpy(g)).sum().backward()
    plain = hk.sddmm_grad_reference(torch.from_numpy(g),
                                    torch.from_numpy(src),
                                    torch.from_numpy(dst), xt.detach(),
                                    None if yt is None else yt.detach())
    assert torch.equal(xt.grad, plain[0])
    jx, jy = _jax_grad(src, dst, x, y, g, two_tables)
    np.testing.assert_allclose(_np(xt.grad), jx, rtol=RTOL, atol=ATOL * 10)
    if two_tables:
        assert torch.equal(yt.grad, plain[1])
        np.testing.assert_allclose(_np(yt.grad), jy, rtol=RTOL,
                                   atol=ATOL * 10)
