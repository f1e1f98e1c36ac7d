"""Parity of the port's ops (`linkpred_tpu_torch.ops`) with the JAX package.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs its Pallas kernel in interpret mode, as its own tests do.
Tolerances: host structures are array-equal; f32 sums taken in another
order agree to rtol 1e-5, atol 1e-6 (1e-5 where the reference test of the
Pallas kernel uses it).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linkpred_tpu.ops import pallas_kernels as jpk
from linkpred_tpu.ops import sddmm as jsd
from linkpred_tpu.ops import segment as jseg
from linkpred_tpu_torch.kernels import build
from linkpred_tpu_torch.ops import hopper_kernels as hk
from linkpred_tpu_torch.ops import sddmm as tsd
from linkpred_tpu_torch.ops import segment as tseg

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _np(t):
    return t.detach().cpu().numpy()


def _ids(rng, n_slots, n_seg, pad_frac=0.15):
    """Segment ids with some pads (id == n_seg) and some empty segments."""
    ids = rng.integers(0, max(n_seg - 2, 1), n_slots)
    ids[rng.random(n_slots) < pad_frac] = n_seg
    return ids.astype(np.int32)


def _assert_plans_equal(pt, pj):
    assert pt.num_segments == pj.num_segments
    assert pt.num_slots == pj.num_slots
    np.testing.assert_array_equal(pt.dst_clipped, pj.dst_clipped)
    np.testing.assert_array_equal(pt.inv_perm, pj.inv_perm)
    assert len(pt.slot_buckets) == len(pj.slot_buckets)
    for a, b in zip(pt.slot_buckets, pj.slot_buckets):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# host plans
# ---------------------------------------------------------------------------


class TestPlans:
    @pytest.mark.parametrize("n_slots,n_seg", [(1, 1), (50, 9), (400, 37),
                                               (3000, 620)])
    def test_segment_plan_equal(self, n_slots, n_seg):
        ids = _ids(np.random.default_rng(n_slots), n_slots, n_seg)
        pt = tseg.SegmentPlan.build(ids, n_seg)
        pj = jseg.SegmentPlan.build(ids, n_seg)
        _assert_plans_equal(pt, pj)
        dst, inv, buckets = pt.operands("cpu")
        np.testing.assert_array_equal(_np(dst), pj.dst_clipped)
        np.testing.assert_array_equal(_np(inv), pj.inv_perm)
        for a, b in zip(buckets, pj.slot_buckets):
            np.testing.assert_array_equal(_np(a), b)

    @pytest.mark.parametrize("n_slots,n_seg", [(50, 9), (3000, 620)])
    def test_ell_operands_equal(self, n_slots, n_seg):
        ids = _ids(np.random.default_rng(n_slots + 1), n_slots, n_seg)
        slots_j, valid_j = jseg.SegmentPlan.build(ids, n_seg).ell_operands()
        slots, weight = tseg.SegmentPlan.build(ids, n_seg).ell_operands("cpu")
        assert slots.dtype == torch.int32 and weight.dtype == torch.float32
        assert slots.is_contiguous() and weight.is_contiguous()
        np.testing.assert_array_equal(_np(slots), np.asarray(slots_j))
        np.testing.assert_array_equal(_np(weight), np.asarray(valid_j))

    def test_composed_operands_equal(self):
        rng = np.random.default_rng(5)
        R, S = 64, 700
        dst = _ids(rng, S, R)
        src = np.where(dst < R, rng.integers(0, R, S), R)
        pj = jseg.SegmentPlan.build(dst, R)
        pt = tseg.SegmentPlan.build(dst, R)
        inv_j, buckets_j = jseg.composed_operands(pj, src, R)
        inv_t, buckets_t = tseg.composed_operands(pt, src, R, "cpu")[:2]
        np.testing.assert_array_equal(_np(inv_t), np.asarray(inv_j))
        assert len(buckets_t) == len(buckets_j)
        for a, b in zip(buckets_t, buckets_j):
            np.testing.assert_array_equal(_np(a), np.asarray(b))


# ---------------------------------------------------------------------------
# kernel K1 and its plain version
# ---------------------------------------------------------------------------


def _dense_ell(nbr, w, x):
    out = np.zeros((nbr.shape[0], x.shape[1]), np.float64)
    for i in range(nbr.shape[0]):
        for k in range(nbr.shape[1]):
            if 0 <= nbr[i, k] < x.shape[0] and w[i, k] != 0:
                out[i] += w[i, k] * x[nbr[i, k]]
    return out


class TestSpmmEll:
    @pytest.mark.parametrize("n,d,f,weighted", [(70, 9, 20, False),
                                                (33, 5, 8, True),
                                                (48, 32, 16, True),
                                                (40, 32, 24, False)])
    def test_reference_matches_pallas(self, n, d, f, weighted):
        """The `TestPallasSpMM` shapes, and slot matrices of 32 columns at
        F = 16 and 24 (the 50k-node TwoWL's 1-WL shapes, cut in rows): the
        plain version against the JAX package's Pallas kernel in interpret
        mode."""
        rng = np.random.default_rng(n)
        nbr = rng.integers(0, n, (n, d)).astype(np.int32)
        w = (rng.random((n, d)) if weighted
             else rng.random((n, d)) < 0.6).astype(np.float32)
        x = rng.standard_normal((n, f)).astype(np.float32)
        ref = np.asarray(jpk.spmm_ell_pallas(
            jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(x),
            block_rows=16, block_feats=8, interpret=True))
        got = hk.spmm_ell_reference(torch.from_numpy(nbr), torch.from_numpy(w),
                                    torch.from_numpy(x))
        np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("f", [24, 192, 512])
    def test_hub_layout_matches_pallas(self, f):
        """fb-pages-food's 1-WL layout in miniature, the shape K1's split
        kernel takes: one hub row of 114 live slots among rows of 1-32
        (pads trailing, weight 0 on index 0), D = 114, at the one trial's
        F = 24, a rank's 192 and the sweep's 512: the plain version against
        the Pallas kernel in interpret mode."""
        rng = np.random.default_rng(f)
        m, d, nx = 40, 114, 300
        live = rng.integers(1, 33, m)
        live[7] = d
        nbr = rng.integers(0, nx, (m, d)).astype(np.int32)
        w = rng.standard_normal((m, d)).astype(np.float32)
        pad = np.arange(d)[None, :] >= live[:, None]
        nbr[pad], w[pad] = 0, 0.0
        x = rng.standard_normal((nx, f)).astype(np.float32)
        ref = np.asarray(jpk.spmm_ell_pallas(
            jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(x),
            block_rows=8, block_feats=128, interpret=True))
        got = hk.spmm_ell_reference(torch.from_numpy(nbr), torch.from_numpy(w),
                                    torch.from_numpy(x))
        np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=5e-5)
        np.testing.assert_allclose(_np(got), _dense_ell(nbr, w, x),
                                   rtol=1e-5, atol=5e-5)

    @pytest.mark.parametrize("m,d,nx,f", [(40, 1, 30, 7), (25, 6, 11, 33),
                                          (12, 4, 5, 1)])
    def test_ragged_against_loop(self, m, d, nx, f):
        """F not a multiple of 32, D = 1, all-zero rows, sentinel and
        negative indices: the wrapper on CPU tensors (its plain version)
        against a loop."""
        rng = np.random.default_rng(m * d)
        nbr = rng.integers(-2, nx + 3, (m, d)).astype(np.int32)
        w = rng.standard_normal((m, d)).astype(np.float32)
        w[::3] = 0.0
        x = rng.standard_normal((nx, f)).astype(np.float32)
        got = hk.spmm_ell(torch.from_numpy(nbr), torch.from_numpy(w),
                          torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (m, f)
        np.testing.assert_allclose(_np(got), _dense_ell(nbr, w, x),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(_np(got)[::3], 0.0)

    def test_cpu_tensors_do_not_count_launches(self):
        before, by_width = dict(hk.LAUNCHES), dict(hk.LAUNCHES_BY_WIDTH)
        hk.spmm_ell(torch.zeros((2, 1), dtype=torch.int32),
                    torch.ones((2, 1)), torch.ones((1, 4)))
        assert hk.LAUNCHES == before
        assert hk.LAUNCHES_BY_WIDTH == by_width

    def test_no_nvcc_raises(self, monkeypatch, tmp_path):
        """A kernel that cannot be built raises; nothing falls back."""
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(build, "_LIBRARIES", {})
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
        with pytest.raises(RuntimeError, match="nvcc"):
            build.library("spmm_ell")

    def test_library_path_keys_on_source(self, monkeypatch, tmp_path):
        src = tmp_path / "k.cu"
        monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
        src.write_text("// a")
        first = build.library_path("k")
        src.write_text("// b")
        assert build.library_path("k") != first
        assert first.parent == build.BUILD_DIR


# ---------------------------------------------------------------------------
# aggregations with custom backward
# ---------------------------------------------------------------------------


def _segment_case(seed, n_slots=300, n_seg=40, f=6):
    rng = np.random.default_rng(seed)
    ids = _ids(rng, n_slots, n_seg)
    msgs = rng.standard_normal((n_slots, f)).astype(np.float32)
    cot = rng.standard_normal((n_seg, f)).astype(np.float32)
    return ids, msgs, cot


def _torch_value_and_grad(fn, x_np, cot_np):
    x = torch.from_numpy(x_np).requires_grad_()
    out = fn(x)
    (out * torch.from_numpy(cot_np)).sum().backward()
    return _np(out), _np(x.grad)


def _jax_value_and_grad(fn, x_np, cot_np):
    out, vjp = jax.vjp(jax.jit(fn), jnp.asarray(x_np))
    (g,) = vjp(jnp.asarray(cot_np))
    return np.asarray(out), np.asarray(g)


class TestAggregations:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_segment_sum_planned(self, seed):
        ids, msgs, cot = _segment_case(seed)
        n = cot.shape[0]
        ops_j = jseg.SegmentPlan.build(ids, n).operands()
        ops_t = tseg.SegmentPlan.build(ids, n).operands("cpu")
        vj, gj = _jax_value_and_grad(
            lambda x: jseg.segment_sum_planned(n, x, *ops_j), msgs, cot)
        vt, gt = _torch_value_and_grad(
            lambda x: tseg.segment_sum_planned(x, *ops_t), msgs, cot)
        np.testing.assert_allclose(vt, vj, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_segment_sum_ell_matches_onehot(self, seed):
        """The port's K1 segment sum against the reference's one-hot Pallas
        segment sum (interpret mode): forward and gradient."""
        ids, msgs, cot = _segment_case(seed)
        n = cot.shape[0]
        pj = jseg.SegmentPlan.build(ids, n)
        pt = tseg.SegmentPlan.build(ids, n)
        slots_j, valid_j = pj.ell_operands()
        dst_j = pj.operands()[0]
        dst_t = pt.operands("cpu")[0]
        slots_t, w_t = pt.ell_operands("cpu")
        vj, gj = _jax_value_and_grad(
            lambda x: jseg.segment_sum_onehot(n, x, dst_j, slots_j, valid_j,
                                              True), msgs, cot)
        vt, gt = _torch_value_and_grad(
            lambda x: tseg.segment_sum_ell(n, x, dst_t, slots_t, w_t),
            msgs, cot)
        np.testing.assert_allclose(vt, vj, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_segment_sum_ell_without_zero_row(self, seed, monkeypatch):
        """Trial-major messages `[S, T, C]` with sentinel slots: K1 gets the
        messages as they are (no copy with a zero row appended; the
        sentinel `S` lies outside their rows and is dropped), and the sum
        equals the planned bucket-sum and the reference's one-hot Pallas
        segment sum (interpret mode) to 1e-6."""
        rng = np.random.default_rng(seed)
        n_slots, n_seg, t, c = 300, 40, 3, 4
        ids = _ids(rng, n_slots, n_seg)
        msgs = rng.standard_normal((n_slots, t, c)).astype(np.float32)
        cot = rng.standard_normal((n_seg, t, c)).astype(np.float32)
        pj = jseg.SegmentPlan.build(ids, n_seg)
        pt = tseg.SegmentPlan.build(ids, n_seg)
        slots_t, w_t = pt.ell_operands("cpu")
        assert int(slots_t.max()) == n_slots  # sentinel slots are there
        seen = []
        monkeypatch.setattr(
            tseg, "spmm_ell",
            lambda nbr, w, x: seen.append(x.shape) or hk.spmm_ell(nbr, w, x))
        v_ell, g_ell = _torch_value_and_grad(
            lambda x: tseg.segment_sum_ell(n_seg, x, pt.operands("cpu")[0],
                                           slots_t, w_t), msgs, cot)
        assert seen == [(n_slots, t * c)]
        v_plan, g_plan = _torch_value_and_grad(
            lambda x: tseg.segment_sum_planned(x, *pt.operands("cpu")),
            msgs, cot)
        slots_j, valid_j = pj.ell_operands()
        flat, cot_flat = msgs.reshape(n_slots, -1), cot.reshape(n_seg, -1)
        v_j, g_j = _jax_value_and_grad(
            lambda x: jseg.segment_sum_onehot(n_seg, x, pj.operands()[0],
                                              slots_j, valid_j, True),
            flat, cot_flat)
        for got, ref in ((v_ell, v_plan), (g_ell, g_plan),
                         (v_ell.reshape(n_seg, -1), v_j),
                         (g_ell.reshape(n_slots, -1), g_j)):
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)

    def test_segment_sum_ell_checks_rows(self):
        ids, msgs, _ = _segment_case(3)
        pt = tseg.SegmentPlan.build(ids, 40)
        with pytest.raises(ValueError):
            tseg.segment_sum_ell(41, torch.from_numpy(msgs),
                                 pt.operands("cpu")[0], *pt.ell_operands("cpu"))

    @pytest.mark.parametrize("seed", [0, 1])
    def test_gather_sum_composed(self, seed):
        rng = np.random.default_rng(seed)
        R, S, f = 48, 500, 5
        dst = _ids(rng, S, R)
        src = np.where(dst < R, rng.integers(0, R, S), R)
        x = rng.standard_normal((R, f)).astype(np.float32)
        cot = rng.standard_normal((R, f)).astype(np.float32)
        back = np.where(dst < R, dst, R)

        def ops(mod, *dev):
            fwd = mod.composed_operands(mod.SegmentPlan.build(dst, R), src, R,
                                        *dev)
            bwd = mod.composed_operands(mod.SegmentPlan.build(src, R), back, R,
                                        *dev)
            return fwd, bwd

        fj, bj = ops(jseg)
        ft, bt = ops(tseg, "cpu")
        vj, gj = _jax_value_and_grad(
            lambda v: jseg.gather_sum_composed(v, fj, bj), x, cot)
        vt, gt = _torch_value_and_grad(
            lambda v: tseg.gather_sum_composed(v, ft, bt), x, cot)
        np.testing.assert_allclose(vt, vj, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL)

    def test_segment_sum_and_gcn_norm(self):
        rng = np.random.default_rng(9)
        n, e = 25, 120
        src = rng.integers(0, n, e).astype(np.int32)
        dst = _ids(rng, e, n)
        mask = rng.random(e) < 0.8
        data = rng.standard_normal((e, 3)).astype(np.float32)
        got = tseg.segment_sum(torch.from_numpy(data),
                               torch.from_numpy(dst), n, torch.from_numpy(mask))
        ref = jseg.segment_sum(jnp.asarray(data), jnp.asarray(dst), n,
                               jnp.asarray(mask))
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
        src_c = np.minimum(src, n - 1)
        dst_c = np.minimum(dst, n - 1)
        plan_t = tseg.SegmentPlan.build(dst_c, n).operands("cpu")
        for plan in (None, plan_t):
            coeff, selfc = tseg.gcn_norm_coefficients(
                torch.from_numpy(src_c).long(), torch.from_numpy(dst_c).long(),
                n, torch.from_numpy(mask), plan=plan)
            cj, sj = jseg.gcn_norm_coefficients(
                jnp.asarray(src_c), jnp.asarray(dst_c), n, jnp.asarray(mask))
            np.testing.assert_allclose(_np(coeff), np.asarray(cj), rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(_np(selfc), np.asarray(sj), rtol=RTOL,
                                       atol=ATOL)


class TestSddmm:
    def test_edge_ops_match(self):
        rng = np.random.default_rng(2)
        n, e, f = 30, 90, 7
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
        x = rng.standard_normal((n, f)).astype(np.float32)
        y = rng.standard_normal((n, f)).astype(np.float32)
        ts, td = torch.from_numpy(src), torch.from_numpy(dst)
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        js, jd, jx, jy = map(jnp.asarray, (src, dst, x, y))
        for got, ref in [
            (tsd.edge_hadamard(ts, td, tx), jsd.edge_hadamard(js, jd, jx)),
            (tsd.edge_sum(ts, td, tx), jsd.edge_sum(js, jd, jx)),
            (tsd.sddmm_coo(ts, td, tx), jsd.sddmm_coo(js, jd, jx)),
            (tsd.sddmm_coo(ts, td, tx, ty), jsd.sddmm_coo(js, jd, jx, jy)),
        ]:
            np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=RTOL,
                                       atol=ATOL)
        for got, ref in [
            (hk.sddmm_auto(ts, td, tx), jpk.sddmm_auto(js, jd, jx)),
            (hk.sddmm_auto(ts, td, tx, ty), jpk.sddmm_auto(js, jd, jx, jy)),
        ]:
            assert got.dtype == torch.float32
            np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=RTOL,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# the rest of ops/spmm.py and ops/segment.py (mirrors of tests/test_ops.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def small_graph():
    """tests/test_ops.py's `small`: 40 nodes, random undirected edges."""
    from linkpred_tpu_torch.data.graph import Graph

    rng = np.random.default_rng(1234)
    n, m = 40, 150
    u = rng.integers(0, n, size=m)
    v = rng.integers(0, n, size=m)
    keep = u != v
    g = Graph.from_undirected_edges(u[keep], v[keep], num_nodes=n)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    return g, x


class TestSpmmRest:
    def test_spmm_coo_matches_jax_and_dense(self, small_graph):
        from linkpred_tpu.ops import spmm as jspmm
        from linkpred_tpu_torch.ops import spmm as tspmm

        g, x = small_graph
        got = tspmm.spmm_coo(torch.from_numpy(g.src), torch.from_numpy(g.dst),
                             torch.from_numpy(x), g.num_nodes)
        ref = jspmm.spmm_coo(jnp.asarray(g.src), jnp.asarray(g.dst),
                             jnp.asarray(x), g.num_nodes)
        np.testing.assert_allclose(_np(got), np.asarray(ref), RTOL, ATOL)
        np.testing.assert_allclose(_np(got), g.dense_adjacency() @ x,
                                   rtol=1e-5, atol=1e-5)

    def test_spmm_coo_weighted_masked(self, small_graph):
        from linkpred_tpu.ops import spmm as jspmm
        from linkpred_tpu_torch.ops import spmm as tspmm

        g, x = small_graph
        rng = np.random.default_rng(3)
        w = rng.random(g.num_edges).astype(np.float32)
        mask = rng.random(g.num_edges) > 0.3
        got = tspmm.spmm_coo(torch.from_numpy(g.src), torch.from_numpy(g.dst),
                             torch.from_numpy(x), g.num_nodes,
                             edge_weight=torch.from_numpy(w),
                             mask=torch.from_numpy(mask))
        ref = jspmm.spmm_coo(jnp.asarray(g.src), jnp.asarray(g.dst),
                             jnp.asarray(x), g.num_nodes,
                             edge_weight=jnp.asarray(w),
                             mask=jnp.asarray(mask))
        np.testing.assert_allclose(_np(got), np.asarray(ref), RTOL, ATOL)

    @pytest.mark.parametrize("weighted", [False, True])
    def test_spmm_ell_and_blocked_match_jax(self, small_graph, weighted):
        from linkpred_tpu.ops import spmm as jspmm
        from linkpred_tpu_torch.ops import spmm as tspmm

        g, x = small_graph
        w = (np.random.default_rng(4).random(g.nbr.shape).astype(np.float32)
             if weighted else None)
        tw = None if w is None else torch.from_numpy(w)
        jw = None if w is None else jnp.asarray(w)
        targs = (torch.from_numpy(g.nbr), torch.from_numpy(g.nbr_mask),
                 torch.from_numpy(x))
        jargs = (jnp.asarray(g.nbr), jnp.asarray(g.nbr_mask), jnp.asarray(x))
        ref = np.asarray(jspmm.spmm_ell(*jargs, jw))
        np.testing.assert_allclose(_np(tspmm.spmm_ell(*targs, tw)), ref,
                                   RTOL, ATOL)
        for block in (7, 40, 4096):
            np.testing.assert_allclose(
                _np(tspmm.spmm_ell_blocked(*targs, tw, block_rows=block)),
                np.asarray(jspmm.spmm_ell_blocked(*jargs, jw,
                                                  block_rows=block)),
                RTOL, ATOL)
        if not weighted:  # symmetric graph: ELL rows == COO by dst
            coo = tspmm.spmm_coo(torch.from_numpy(g.src),
                                 torch.from_numpy(g.dst), targs[2],
                                 g.num_nodes)
            np.testing.assert_allclose(_np(tspmm.spmm_ell(*targs)), _np(coo),
                                       rtol=1e-5, atol=1e-5)

    def test_degree(self, small_graph):
        g, _ = small_graph
        dst = torch.from_numpy(g.dst)
        d = tseg.degree_from_edges(dst, g.num_nodes)
        np.testing.assert_array_equal(_np(d), g.degree.astype(np.float32))
        np.testing.assert_array_equal(
            _np(d), np.asarray(jseg.degree_from_edges(jnp.asarray(g.dst),
                                                      g.num_nodes)))
        mask = np.arange(len(g.dst)) % 3 != 0
        np.testing.assert_array_equal(
            _np(tseg.degree_from_edges(dst, g.num_nodes,
                                       torch.from_numpy(mask))),
            np.asarray(jseg.degree_from_edges(jnp.asarray(g.dst), g.num_nodes,
                                              jnp.asarray(mask))))

    @pytest.mark.parametrize("self_loops", [True, False])
    def test_gcn_aggregate_matches_jax(self, small_graph, self_loops):
        from linkpred_tpu.ops import spmm as jspmm
        from linkpred_tpu_torch.ops import spmm as tspmm

        g, x = small_graph
        mask = np.arange(len(g.src)) % 4 != 1
        got = tspmm.gcn_aggregate(
            torch.from_numpy(g.src), torch.from_numpy(g.dst),
            torch.from_numpy(x), g.num_nodes, torch.from_numpy(mask),
            add_self_loops=self_loops)
        ref = jspmm.gcn_aggregate(jnp.asarray(g.src), jnp.asarray(g.dst),
                                  jnp.asarray(x), g.num_nodes,
                                  jnp.asarray(mask),
                                  add_self_loops=self_loops)
        np.testing.assert_allclose(_np(got), np.asarray(ref), RTOL, ATOL)
        if self_loops:  # unmasked: the dense symmetric normalisation
            full = tspmm.gcn_aggregate(
                torch.from_numpy(g.src), torch.from_numpy(g.dst),
                torch.from_numpy(x), g.num_nodes)
            a = g.dense_adjacency() + np.eye(g.num_nodes, dtype=np.float32)
            dinv = 1.0 / np.sqrt(a.sum(axis=1))
            np.testing.assert_allclose(
                _np(full), (dinv[:, None] * a * dinv[None, :]) @ x,
                rtol=1e-4, atol=1e-4)

    def test_segment_mean_and_max(self):
        rng = np.random.default_rng(1234)
        data = rng.standard_normal((20, 4)).astype(np.float32)
        ids = rng.integers(0, 7, size=20)  # segment 6 of 7 may be empty
        ids[:3] = 9  # outside: dropped
        mask = rng.random(20) > 0.2
        td, ti = torch.from_numpy(data), torch.from_numpy(ids)
        jd, ji = jnp.asarray(data), jnp.asarray(ids)
        np.testing.assert_allclose(
            _np(tseg.segment_mean(td, ti, 8)),
            np.asarray(jseg.segment_mean(jd, ji, 8)), RTOL, ATOL)
        np.testing.assert_allclose(
            _np(tseg.segment_mean(td, ti, 8, torch.from_numpy(mask))),
            np.asarray(jseg.segment_mean(jd, ji, 8, jnp.asarray(mask))),
            RTOL, ATOL)
        np.testing.assert_array_equal(_np(tseg.segment_max(td, ti, 8)),
                                      np.asarray(jseg.segment_max(jd, ji, 8)))
        iv = rng.integers(-50, 50, (20, 3)).astype(np.int32)
        np.testing.assert_array_equal(
            _np(tseg.segment_max(torch.from_numpy(iv), ti, 8)),
            np.asarray(jseg.segment_max(jnp.asarray(iv), ji, 8)))

    def test_spmm_auto_regimes_match_jax_and_dense(self, small_graph):
        from linkpred_tpu.ops import spmm as jspmm
        from linkpred_tpu_torch.ops import spmm as tspmm

        g, x = small_graph
        dense = g.dense_adjacency() @ x
        before = dict(hk.LAUNCHES)
        for force in ("pallas", "bucketed", "ell", None):
            got = tspmm.spmm_auto(g.nbr, g.nbr_mask, torch.from_numpy(x),
                                  force=force)
            ref = jspmm.spmm_auto(g.nbr, g.nbr_mask, jnp.asarray(x),
                                  force=force)
            np.testing.assert_allclose(_np(got), np.asarray(ref),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"regime {force}")
            np.testing.assert_allclose(_np(got), dense, rtol=1e-4, atol=1e-4)
        w = np.random.default_rng(0).random(g.nbr.shape).astype(np.float32)
        np.testing.assert_allclose(
            _np(tspmm.spmm_auto(g.nbr, g.nbr_mask, torch.from_numpy(x), w,
                                force="bucketed")),
            _np(tspmm.spmm_auto(g.nbr, g.nbr_mask, torch.from_numpy(x), w,
                                force="pallas")), rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError, match="regime"):
            tspmm.spmm_auto(g.nbr, g.nbr_mask, torch.from_numpy(x),
                            force="onehot")
        assert hk.LAUNCHES == before  # CPU tensors: the plain versions

    def test_spmm_ell_auto_matches_jax(self):
        rng = np.random.default_rng(6)
        n, d, nx, f = 50, 9, 70, 12
        nbr = rng.integers(0, nx, (n, d)).astype(np.int64)
        mask = rng.random((n, d)) > 0.3
        w = rng.standard_normal((n, d)).astype(np.float32)
        x = rng.standard_normal((nx, f)).astype(np.float32)
        for weight in (None, w):
            got = hk.spmm_ell_auto(
                torch.from_numpy(nbr), torch.from_numpy(mask),
                torch.from_numpy(x),
                None if weight is None else torch.from_numpy(weight))
            ref = jpk.spmm_ell_auto(
                jnp.asarray(nbr, dtype=jnp.int32), jnp.asarray(mask),
                jnp.asarray(x),
                None if weight is None else jnp.asarray(weight))
            np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                                       atol=1e-5)
