"""Card-only checks of the port: kernels K1, K3 and K2 and the paths through
them on a CUDA device, against their plain PyTorch versions on the same card:
the TwoWL slice (K1 on the 1-WL aggregation, K3 on the paired 2-WL
composed gather-sum, single-trial and trial-major), the GCN slice (K3,
K2), and SEAL (no kernel: DRNL on the card against the C++ plane, a DGCNN
step on the card against the CPU, and the dispatch entries of K1 and K2).
Each kernel path that K1 and K3 choose by shape is held to the plain
version, the narrow ones too (K3's slot kernel for rows under 16 bytes,
K3's and K1's packed kernels), and two launches of those agree bit for bit.

Every test here carries the `cuda` marker and skips without a card. The file
imports no JAX, so it also runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest`: the suite's conftest imports JAX.) Tolerances: K1 against
its plain version rtol 1e-5, atol 1e-5 (f32 sums of up to 120 products of
normal values reach magnitude ~40, where two summation orders differ by
~2e-5 absolute); rtol 1e-5, atol 1e-6 for the layers above it. K3 and K2
in f32: rtol 1e-5, atol 1e-5, as K1. K3 in bf16: kernel and plain version
both sum in f32 and round once to bf16, in another order, so they differ by
at most one bf16 ulp of the output: rtol 2^-7 (8e-3), atol 1e-6. K2 returns
f32 sums of exact products of bf16 values: rtol 1e-5, atol 1e-4 (sums of
128 products reach ~40). A GCN training step on the kernels against the
plain versions in f32: loss and gradients rtol 1e-4, atol 1e-6 (four
aggregations and a score, each summed in another order). A DGCNN step on
the card against the CPU from the same parameters: loss and updated
parameters rtol 1e-4, atol 1e-6 (cuBLAS and cuDNN sum in other orders;
TF32 is off).
"""

import dataclasses

import numpy as np
import pytest
import torch

from linkpred_tpu_torch.data import io
from linkpred_tpu_torch.data.twowl import build_twowl_data
from linkpred_tpu_torch.models import twowl as m
from linkpred_tpu_torch.ops import hopper_kernels as hk
from linkpred_tpu_torch.ops import sddmm as sd
from linkpred_tpu_torch.ops import segment as seg
from linkpred_tpu_torch.ops import spmm
from linkpred_tpu_torch.pipelines import gcn_scale as gs

pytestmark = pytest.mark.cuda

# (M, D, NX, F): the slice's 1-WL shapes (fb-pages-food train/test splits,
# layer widths 24 and 16), then F not a multiple of 32, D = 1 and F = 1
SHAPES = [(620, 114, 3557, 24), (620, 114, 3557, 16), (620, 120, 3765, 24),
          (40, 1, 30, 7), (25, 6, 11, 33), (12, 4, 5, 1)]


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from linkpred_tpu_torch.utils.device import cuda_device

    return cuda_device()


@pytest.fixture(scope="module")
def fb_data():
    _, edges = io.load_fb_pages_food()
    return build_twowl_data(edges, int(edges.max()) + 1,
                            rng=np.random.default_rng(0))


def _operands(shape, seed, dev):
    """Sentinel and negative indices, and every third row all-zero weight."""
    m_, d, nx, f = shape
    rng = np.random.default_rng(seed)
    nbr = rng.integers(-2, nx + 3, (m_, d)).astype(np.int32)
    w = rng.standard_normal((m_, d)).astype(np.float32)
    w[::3] = 0.0
    x = rng.standard_normal((nx, f)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (nbr, w, x)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_spmm_ell_matches_reference(cuda, shape):
    nbr, w, x = _operands(shape, sum(shape), cuda)
    before = hk.LAUNCHES["spmm_ell"]
    by_width = hk.LAUNCHES_BY_WIDTH.get(f"spmm_ell F={shape[3]}", 0)
    got = hk.spmm_ell(nbr, w, x)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["spmm_ell"] == before + 1
    assert hk.LAUNCHES_BY_WIDTH[f"spmm_ell F={shape[3]}"] == by_width + 1
    ref = hk.spmm_ell_reference(nbr, w, x)
    assert got.shape == ref.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert (got[::3] == 0).all()


def test_spmm_ell_rejects_what_the_kernel_does_not_take(cuda):
    nbr, w, x = _operands((16, 5, 40, 8), 0, cuda)
    before = hk.LAUNCHES["spmm_ell"]
    with pytest.raises(TypeError):
        hk.spmm_ell(nbr.long(), w, x)
    with pytest.raises(TypeError):
        hk.spmm_ell(nbr, w, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        hk.spmm_ell(nbr, w, x.t().contiguous().t())
    with pytest.raises(ValueError):
        hk.spmm_ell(nbr, w, x.cpu())
    with pytest.raises(ValueError):
        hk.spmm_ell(nbr, w[:, :4].contiguous(), x)
    assert hk.LAUNCHES["spmm_ell"] == before
    assert sum(hk.LAUNCHES_BY_WIDTH.values()) == sum(hk.LAUNCHES.values())


def test_segment_sum_ell_forward_and_grad(cuda):
    """The K1 segment sum against the planned bucket-sum on the card."""
    rng = np.random.default_rng(0)
    n_seg, n_slots, f = 620, 3556, 24
    ids = rng.integers(0, n_seg, n_slots).astype(np.int32)
    ids[rng.random(n_slots) < 0.1] = n_seg  # pads
    plan = seg.SegmentPlan.build(ids, n_seg)
    ops = plan.operands(cuda)
    slots, weight = plan.ell_operands(cuda)
    msgs = torch.from_numpy(
        rng.standard_normal((n_slots, f)).astype(np.float32)).to(cuda)
    cot = torch.from_numpy(
        rng.standard_normal((n_seg, f)).astype(np.float32)).to(cuda)

    def value_and_grad(fn):
        x = msgs.clone().requires_grad_()
        out = fn(x)
        (out * cot).sum().backward()
        return out.detach(), x.grad

    before = hk.LAUNCHES["spmm_ell"]
    v_ell, g_ell = value_and_grad(
        lambda x: seg.segment_sum_ell(n_seg, x, ops[0], slots, weight))
    assert hk.LAUNCHES["spmm_ell"] == before + 1
    v_plan, g_plan = value_and_grad(lambda x: seg.segment_sum_planned(x, *ops))
    torch.testing.assert_close(v_ell, v_plan, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g_ell, g_plan, rtol=1e-5, atol=1e-6)


def test_eval_scores_ell_matches_plan(cuda, fb_data):
    """The slice's model on the card: eval scores with the 1-WL aggregation
    on K1 against the plain bucketed plan, same parameters."""
    d = fb_data
    cfg = m.TwoWLConfig(max_degree=d.max_degree)
    params = m.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    deg = torch.as_tensor(d.node_deg, dtype=torch.long, device=cuda)
    arrays = m.SplitArrays.from_split(d.val, cuda)
    before = hk.LAUNCHES["spmm_ell"]
    got = m.eval_scores(params, deg, arrays,
                        dataclasses.replace(cfg, agg_1wl="ell"))
    assert hk.LAUNCHES["spmm_ell"] == before + cfg.depth1
    ref = m.eval_scores(params, deg, arrays, cfg)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the trial-major TwoWL sweep: K1 on [S, T*C], K3 on the composed structures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(32,), (32, 32)], ids=str)
def test_gather_sum_composed_on_k3_matches_plain(cuda, fb_data, shape):
    """The paired 2-WL aggregation of the fb-pages-food train split on K3
    (forward on the forward operands, backward on the transpose operands)
    against the plain bucket-sum, at T = 1 and T = 32 trials of 2C = 32
    channels; one K3 launch each way."""
    arrays = m.SplitArrays.from_split(fb_data.train, cuda)
    fwd, bwd = arrays.e1_cops
    R = arrays.num_rows
    x = _x(R, int(np.prod(shape)), torch.float32, cuda, 3).reshape(R, *shape)
    cot = _x(R, int(np.prod(shape)), torch.float32, cuda, 4).reshape(x.shape)
    results = []
    for kernel in (True, False):
        xx = x.clone().requires_grad_()
        before = hk.LAUNCHES["spmm_bucketed"]
        out = seg.gather_sum_composed(xx, fwd, bwd, kernel)
        out.backward(cot)
        torch.cuda.synchronize()
        results.append((out.detach(), xx.grad,
                        hk.LAUNCHES["spmm_bucketed"] - before))
    (v_k, g_k, n_k), (v_p, g_p, n_p) = results
    assert (n_k, n_p) == (2, 0)
    assert v_k.shape == g_k.shape == x.shape
    torch.testing.assert_close(v_k, v_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g_k, g_p, rtol=1e-5, atol=1e-5)


def test_segment_sum_ell_trial_major(cuda, fb_data):
    """K1 on the trial-major 1-WL messages [3556, 32, 24] (one [620, 114] x
    [3556, 768] launch) against the planned bucket-sum."""
    arrays = m.SplitArrays.from_split(fb_data.train, cuda)
    n = fb_data.num_nodes
    msgs = _x(arrays.num_msg, 32 * 24, torch.float32, cuda, 5).reshape(
        arrays.num_msg, 32, 24)
    before = hk.LAUNCHES["spmm_ell"]
    got = seg.segment_sum_ell(n, msgs, arrays.msg_plan[0], arrays.msg_slots,
                              arrays.msg_sweight)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["spmm_ell"] == before + 1 and got.shape == (n, 32, 24)
    torch.testing.assert_close(got, seg.segment_sum_planned(
        msgs, *arrays.msg_plan), rtol=1e-5, atol=1e-5)


def test_forward_trials_ell_matches_plan(cuda, fb_data):
    """The published-best architecture at T = 8 on the card: eval logits and
    the gradients of a masked training loss, with K1 and K3 ('ell') against
    the plain aggregations ('plan'), same parameters. Logits are held to
    atol 1e-5 of the largest logit; the conv biases that GraphNorm cancels
    get f32-noise gradients, held to atol 1e-5 of the largest gradient."""
    d = fb_data
    cfg = m.TwoWLConfig(max_degree=d.max_degree, dp_emb=0.0, dp_1wl0=0.0,
                        dp_1wl1=0.0, dp_2wl=0.0)
    params = m.init_params_trials(cfg, 8, torch.Generator().manual_seed(0),
                                  cuda)
    trn = m.SplitArrays.from_split(d.train, cuda)
    val = m.SplitArrays.from_split(d.val, cuda)
    deg = torch.as_tensor(d.node_deg, dtype=torch.long, device=cuda)
    pos = torch.arange(0, 200, device=cuda)
    neg = torch.arange(50, 250, device=cuda)
    val_sel = val.num_msg + torch.arange(val.num_rows - val.num_msg,
                                         device=cuda)
    val_mask = torch.ones(val.num_msg, dtype=torch.bool, device=cuda)
    results = {}
    for agg in ("ell", "plan"):
        c = dataclasses.replace(cfg, agg_1wl=agg)
        before = dict(hk.LAUNCHES)
        with torch.no_grad():
            logits = m.forward_trials(params, c, deg, val, val_mask, val_sel)
        msg_mask, deg_t, sel, y = m._step_inputs(pos, neg, trn, c,
                                                 d.num_nodes)
        out = m.forward_trials(params, c, deg_t, trn, msg_mask, sel)
        loss = torch.nn.functional.binary_cross_entropy_with_logits(
            out, y[:, None].expand_as(out))
        grads = torch.autograd.grad(loss, m.tree_leaves(params))
        torch.cuda.synchronize()
        results[agg] = (logits, loss.detach(), grads,
                        {k: hk.LAUNCHES[k] - before[k] for k in before})
    (l_e, loss_e, g_e, n_e), (l_p, loss_p, g_p, n_p) = (results["ell"],
                                                        results["plan"])
    # eval: depth1 K1 and 1 + depth2 K3; train: the same forward plus depth2
    # K3 backward launches (K1's backward is a gather). Both aggregations
    # gather on the row gather: the edge product (eval and train), its two
    # gradient terms, and depth1 segment-sum backwards (`_gather_dst`)
    gathers = 1 + 3 + cfg.depth1
    assert n_e == {"spmm_ell": 2 * cfg.depth1,
                   "spmm_bucketed": 2 * (1 + cfg.depth2) + cfg.depth2,
                   "sddmm": 0, "sddmm_grad": 0, "gather_rows": gathers}, n_e
    assert n_p == {"spmm_ell": 0, "spmm_bucketed": 0, "sddmm": 0,
                   "sddmm_grad": 0, "gather_rows": gathers}, n_p
    # random-init logits reach ~100, whose f32 sums round at ~1e-5
    torch.testing.assert_close(l_e, l_p, rtol=1e-5,
                               atol=1e-5 * float(l_p.abs().max()))
    torch.testing.assert_close(loss_e, loss_p, rtol=1e-5, atol=1e-6)
    scale = max(float(g.abs().max()) for g in g_p)
    cancelled = {id(layer["b"]) for key in ("conv1", "conv2", "conv2r")
                 for layer in params[key]}
    for leaf, a, b in zip(m.tree_leaves(params), g_e, g_p):
        atol = (1e-5 if id(leaf) in cancelled else 1e-6) * scale
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)


# ---------------------------------------------------------------------------
# K3 (bucketed SpMM) and K2 (SDDMM): the GCN slice
# ---------------------------------------------------------------------------

# the GCN slice's config at a twelfth of its node count: every bucket width
# of the full config (2-64) occurs, at the full feature widths
GCN_CFG = gs.ScaleGCNConfig(nodes=20_000, edges=110_000, batch_edges=1024,
                            dtype="f32")
FEATURE_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
               torch.bfloat16: dict(rtol=2**-7, atol=1e-6)}


@pytest.fixture(scope="module")
def gcn_problem():
    return gs.build_problem(GCN_CFG)


def _layouts():
    """Graphs beside the slice's: no edges at all, and a ring (one bucket)."""
    empty = spmm.BucketedEll.build(np.zeros((9, 1), np.int32),
                                   np.zeros((9, 1), bool))
    n = 50
    ring = np.stack([(np.arange(n) - 1) % n, (np.arange(n) + 1) % n], 1)
    one = spmm.BucketedEll.build(ring.astype(np.int32),
                                 np.ones((n, 2), bool),
                                 np.full((n, 2), 0.5, np.float32))
    assert len(empty.buckets) == 0 and len(one.buckets) == 1
    return {"no edges": empty, "one bucket": one}


def _x(rows, f, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((rows, f), generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("f", [64, 128, 33, 1])
def test_spmm_bucketed_matches_reference(cuda, gcn_problem, f, dtype):
    lay = spmm.BucketedEll.from_graph(gcn_problem[0])
    assert [nb.shape[1] for _, nb, _ in lay.buckets] == [
        2, 4, 6, 8, 12, 16, 24, 32, 48, 64]
    ops = lay.operands(cuda)
    x = _x(lay.num_nodes, f, dtype, cuda, f)
    before = hk.LAUNCHES["spmm_bucketed"]
    got = hk.spmm_bucketed(x, *ops)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["spmm_bucketed"] == before + 1
    ref = hk.spmm_bucketed_reference(x, *ops)
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), **FEATURE_TOL[dtype])
    assert (got[torch.from_numpy(gcn_problem[0].degree == 0).to(cuda)] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("name", ["no edges", "one bucket"])
def test_spmm_bucketed_small_layouts(cuda, name, dtype):
    lay = _layouts()[name]
    ops = lay.operands(cuda)
    x = _x(lay.num_nodes, 7, dtype, cuda)
    got = hk.spmm_bucketed(x, *ops)
    ref = hk.spmm_bucketed_reference(x, *ops)
    torch.testing.assert_close(got.float(), ref.float(), **FEATURE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_spmm_bucketed_sym_grad_matches_plain(cuda, gcn_problem, dtype):
    ops = spmm.BucketedEll.from_graph(gcn_problem[0]).operands(cuda)
    n = GCN_CFG.nodes
    x = _x(n, 64, dtype, cuda, 1)
    t = _x(n, 64, dtype, cuda, 2)
    grads = []
    for sym in (spmm.spmm_bucketed_sym, spmm.spmm_bucketed_sym_reference):
        xx = x.clone().requires_grad_()
        (sym(xx, n, ops).float() * t.float()).sum().backward()
        grads.append(xx.grad)
    torch.testing.assert_close(grads[0].float(), grads[1].float(),
                               **FEATURE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("e,f", [(16_384, 128), (16_384, 33), (1, 128),
                                 (51_200, 1)])
def test_sddmm_matches_reference(cuda, e, f, dtype):
    n = 20_000
    gen = torch.Generator(device=cuda).manual_seed(e + f)
    src = torch.randint(-1, n + 1, (e,), generator=gen, device=cuda,
                        dtype=torch.int32)
    dst = torch.randint(0, n, (e,), generator=gen, device=cuda,
                        dtype=torch.int32)
    x, y = _x(n, f, dtype, cuda, 1), _x(n, f, dtype, cuda, 2)
    before = hk.LAUNCHES["sddmm"]
    got = hk.sddmm(src, dst, x, y)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["sddmm"] == before + 1
    ref = hk.sddmm_reference(src, dst, x, y)
    assert got.dtype == torch.float32 and got.shape == (e,)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)


def test_sddmm_no_edges(cuda):
    x = _x(5, 8, torch.float32, cuda)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = hk.LAUNCHES["sddmm"]
    assert hk.sddmm(empty, empty, x, x).shape == (0,)
    assert hk.LAUNCHES["sddmm"] == before


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    lay = _layouts()["one bucket"]
    inv, shapes, nbr, w = lay.operands(cuda)
    x = _x(lay.num_nodes, 8, torch.float32, cuda)
    idx = torch.arange(4, dtype=torch.int32, device=cuda)
    before = dict(hk.LAUNCHES)
    with pytest.raises(TypeError):
        hk.spmm_bucketed(x.double(), inv, shapes, nbr, w)
    with pytest.raises(TypeError):
        hk.spmm_bucketed(x, inv.long(), shapes, nbr, w)
    with pytest.raises(ValueError, match="contiguous"):
        hk.spmm_bucketed(x.t().contiguous().t(), inv, shapes, nbr, w)
    with pytest.raises(ValueError):
        hk.spmm_bucketed(x, inv.cpu(), shapes, nbr, w)
    with pytest.raises(ValueError, match="slots"):
        hk.spmm_bucketed(x, inv, shapes, nbr[:-1].contiguous(), w)
    with pytest.raises(TypeError):
        hk.sddmm(idx.long(), idx, x, x)
    with pytest.raises(TypeError):
        hk.sddmm(idx, idx, x, x.to(torch.bfloat16))
    with pytest.raises(TypeError):
        hk.sddmm(idx, idx, x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        hk.sddmm(idx, idx, x.t().contiguous().t(), x)
    with pytest.raises(ValueError):
        hk.sddmm(idx, idx.cpu(), x, x)
    assert hk.LAUNCHES == before


def test_gcn_step_on_kernels_matches_plain(cuda, gcn_problem):
    """One step of the slice (f32) on K3 and K2 against the same step on
    their plain versions: same loss and gradients, and both launch counts
    move only on the kernel path."""
    g, train_pos, _, _ = gcn_problem
    ops = spmm.BucketedEll.from_graph(g).operands(cuda)
    batch = torch.from_numpy(gs.batch_schedule(GCN_CFG, train_pos)[0]).to(cuda)
    plain = (spmm.spmm_bucketed_sym_reference,
             lambda s, d, h: hk.sddmm_reference(s, d, h, h).to(h.dtype))
    results = []
    for agg, score in ((spmm.spmm_bucketed_sym, sd.sddmm_coo), plain):
        params = gs.init_params(GCN_CFG, torch.Generator().manual_seed(0),
                                cuda)
        before = dict(hk.LAUNCHES)
        loss = gs.loss_fn(params, batch, ops, GCN_CFG, agg, score)
        loss.backward()
        torch.cuda.synchronize()
        moved = {k: hk.LAUNCHES[k] - before[k] for k in before}
        results.append((loss.detach(), {k: p.grad for k, p in params.items()},
                         moved))
    (l_k, g_k, moved_k), (l_p, g_p, moved_p) = results
    # the score's backward is K2's gradient kernel
    assert moved_k == {"spmm_ell": 0, "spmm_bucketed": 4, "sddmm": 1,
                       "sddmm_grad": 1, "gather_rows": 0}
    assert moved_p == {"spmm_ell": 0, "spmm_bucketed": 0, "sddmm": 0,
                       "sddmm_grad": 0, "gather_rows": 0}
    torch.testing.assert_close(l_k, l_p, rtol=1e-4, atol=1e-6)
    for k in g_k:
        torch.testing.assert_close(g_k[k], g_p[k], rtol=1e-4, atol=1e-6,
                                   msg=k)


# ---------------------------------------------------------------------------
# wide rows: K3 and K1 choose a kernel by the shape and alignment of x
# ---------------------------------------------------------------------------


def _offset_copy(x):
    """`x` in storage that starts one element past an allocation (which is
    512-byte aligned): rows off the 16-byte grid, the unaligned path."""
    big = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = big[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 != 0
    return out


def _composed(cuda, seed=0, rows=700, slots=9000):
    """A composed gather-sum's K3 operands, both directions, with sentinel
    pads, empty segments, segments of about 13 slots and five of 120."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, rows - 50, slots)
    dst[:600] = np.repeat(np.arange(5), 120)
    dst[rng.random(slots) < 0.1] = rows
    src = np.where(dst < rows, rng.integers(0, rows, slots), rows)
    back = np.where(dst < rows, dst, rows)
    fwd = seg.composed_operands(seg.SegmentPlan.build(dst, rows), src, rows,
                                cuda)
    bwd = seg.composed_operands(seg.SegmentPlan.build(src, rows), back, rows,
                                cuda)
    return rows, fwd, bwd


# F: rows that take the warp-per-row kernel (34 and 100 f32, not whole
# 16-byte groups), the packed kernel (32 f32; 48, 96 and 128 bf16: 16-256
# bytes), and the wide kernel: part of a tile (96 f32), whole tiles (128, 768,
# 1024 f32; 256, 1024 bf16), a ragged last tile (1028 f32, 264 bf16)
WIDE_CASES = [(32, torch.float32), (34, torch.float32), (48, torch.bfloat16), (96, torch.float32), (100, torch.float32),
              (128, torch.float32), (768, torch.float32),
              (1024, torch.float32), (1028, torch.float32),
              (1024, torch.bfloat16), (256, torch.bfloat16),
              (264, torch.bfloat16), (128, torch.bfloat16),
              (96, torch.bfloat16)]


@pytest.mark.parametrize("direction", [0, 1], ids=["forward", "transpose"])
@pytest.mark.parametrize("f,dtype", WIDE_CASES, ids=str)
def test_spmm_bucketed_wide_rows(cuda, f, dtype, direction):
    """K3's kernels for rows of 16 bytes and more, with and without the
    launch order, and from storage offset by one element, against the plain
    version."""
    rows, *both = _composed(cuda)
    k3 = both[direction].k3
    x = _x(rows, f, dtype, cuda, f)
    ref = hk.spmm_bucketed_reference(x, *k3)
    before = hk.LAUNCHES["spmm_bucketed"]
    for got in (hk.spmm_bucketed(x, *k3), hk.spmm_bucketed(x, *k3[:4]),
                hk.spmm_bucketed(_offset_copy(x), *k3)):
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(),
                                   **FEATURE_TOL[dtype])
    assert hk.LAUNCHES["spmm_bucketed"] == before + 3


@pytest.mark.parametrize("f,dtype", [(100, torch.float32),
                                     (1024, torch.float32),
                                     (1024, torch.bfloat16)], ids=str)
def test_spmm_bucketed_nan_pad_zero_row_empty_bucket(cuda, f, dtype):
    """A pad (weight 0) that points at a NaN row contributes nothing, an
    output row mapped to the zero row is 0, an empty bucket is skipped."""
    rows, fwd, _ = _composed(cuda, seed=1)
    inv_perm, shapes, nbr, w, order = fwd.k3
    x = _x(rows, f, dtype, cuda)
    x[0] = float("nan")
    w = torch.where(nbr == 0, 0.0, w)
    inv_perm = inv_perm.clone()
    inv_perm[3] = sum(r for r, _ in shapes)
    shapes = shapes[:1] + ((0, 8),) + shapes[1:]
    got = hk.spmm_bucketed(x, inv_perm, shapes, nbr, w, order)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and not got[3].any()
    ref = hk.spmm_bucketed_reference(x, inv_perm, shapes, nbr, w)
    torch.testing.assert_close(got.float(), ref.float(), **FEATURE_TOL[dtype])


def test_spmm_bucketed_rejects_a_wrong_order(cuda):
    rows, fwd, _ = _composed(cuda)
    x = _x(rows, 8, torch.float32, cuda)
    inv_perm, shapes, nbr, w, order = fwd.k3
    before = hk.LAUNCHES["spmm_bucketed"]
    with pytest.raises(TypeError):
        hk.spmm_bucketed(x, inv_perm, shapes, nbr, w, order.long())
    with pytest.raises(ValueError):
        hk.spmm_bucketed(x, inv_perm, shapes, nbr, w, order[:-1].contiguous())
    assert hk.LAUNCHES["spmm_bucketed"] == before


@pytest.mark.parametrize("f", [24, 100, 128, 768, 772])
def test_spmm_ell_wide_rows(cuda, f):
    """Both kernels of K1 on rows of up to 130 slots (the wide kernel adds
    four warps' partial sums, so the order of the f32 sums differs from the
    plain version's: atol 5e-5 on sums of ~87 products of normal draws),
    from offset storage, with out-of-range indices and a NaN row that only
    weight-0 slots name."""
    gen = torch.Generator(device=cuda).manual_seed(f)
    nx = 500
    nbr = torch.randint(-2, nx + 3, (70, 130), generator=gen, device=cuda,
                        dtype=torch.int32)
    w = torch.randn((70, 130), generator=gen, device=cuda)
    w[::3] = 0.0
    w[nbr == 0] = 0.0
    x = _x(nx, f, torch.float32, cuda, f)
    x[0] = float("nan")
    ref = hk.spmm_ell_reference(nbr, w, x)
    before = hk.LAUNCHES["spmm_ell"]
    for got in (hk.spmm_ell(nbr, w, x), hk.spmm_ell(nbr, w, _offset_copy(x))):
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and (got[::3] == 0).all()
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=5e-5)
    assert hk.LAUNCHES["spmm_ell"] == before + 2


# ---------------------------------------------------------------------------
# narrow rows: K3's slot kernel (rows under 16 bytes), K3's packed kernel
# (rows of 16-256 bytes) and K1's packed kernel (slot matrices of at most 32
# columns)
# ---------------------------------------------------------------------------


def _narrow_layout(cuda, width1_rows=40, nx=400, seed=0):
    """K3 operands over buckets of widths 1, 7, 31, 33 and 130, trailing
    pads (index 0, weight 0), zero weights and indices outside [0, nx)
    among the slots, an empty bucket, and ten output rows mapped to the
    zero row (degree 0). With few rows the slot kernel sizes its group to
    the widest bucket (32 lanes); with `width1_rows` = 9,000 the rows
    outnumber the warps an H100 holds, the group is 2 lanes and the wide
    rows take several rounds. Returns (inv_perm, shapes, nbr, w, order)."""
    rng = np.random.default_rng(seed)
    shapes = ((width1_rows, 1), (30, 7), (0, 8), (20, 31), (12, 33),
              (5, 130))
    nbr, w = [], []
    for rows, width in shapes:
        n_ = rng.integers(-2, nx + 3, (rows, width)).astype(np.int32)
        w_ = rng.standard_normal((rows, width)).astype(np.float32)
        w_[rng.random((rows, width)) < 0.1] = 0.0
        live = rng.integers(1, width + 1, rows)
        pad = np.arange(width)[None, :] >= live[:, None]
        n_[pad] = 0
        w_[pad | (n_ == 0)] = 0.0  # row 0 is named by weight-0 slots only
        nbr.append(n_.ravel())
        w.append(w_.ravel())
    concat = sum(r for r, _ in shapes)
    inv_perm = rng.permutation(np.concatenate(
        [np.arange(concat), np.full(10, concat)])).astype(np.int32)
    order = hk.launch_order(inv_perm)
    return (torch.from_numpy(inv_perm).to(cuda), shapes,
            torch.from_numpy(np.concatenate(nbr)).to(cuda),
            torch.from_numpy(np.concatenate(w)).to(cuda),
            torch.from_numpy(order).to(cuda))


@pytest.mark.parametrize("width1_rows", [40, 9000])
@pytest.mark.parametrize("f,dtype", [(1, torch.float32), (2, torch.float32),
                                     (3, torch.float32),
                                     (2, torch.bfloat16)], ids=str)
def test_spmm_bucketed_slot_kernel(cuda, f, dtype, width1_rows):
    """K3 on rows under 16 bytes, with and without the launch order and
    from storage offset by one element, against the plain version; a pad
    that points at a NaN row contributes nothing and degree-0 rows are 0;
    two launches agree bit for bit."""
    k3 = _narrow_layout(cuda, width1_rows)
    nx = 400
    x = _x(nx, f, dtype, cuda, f)
    x[0] = float("nan")
    inv_perm, shapes = k3[:2]
    ref = hk.spmm_bucketed_reference(x, *k3)
    assert torch.isfinite(ref).all()
    zero_rows = inv_perm == sum(r for r, _ in shapes)
    before = hk.LAUNCHES["spmm_bucketed"]
    runs = [hk.spmm_bucketed(x, *k3), hk.spmm_bucketed(x, *k3),
            hk.spmm_bucketed(x, *k3[:4]), hk.spmm_bucketed(_offset_copy(x), *k3)]
    torch.cuda.synchronize()
    assert hk.LAUNCHES["spmm_bucketed"] == before + 4
    for got in runs:
        assert got.dtype == dtype and torch.isfinite(got).all()
        assert not got[zero_rows].any()
        torch.testing.assert_close(got.float(), ref.float(),
                                   **FEATURE_TOL[dtype])
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("width1_rows", [40, 9000])
@pytest.mark.parametrize("f,dtype", [(8, torch.bfloat16), (16, torch.bfloat16),
                                     (32, torch.bfloat16),
                                     (64, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (4, torch.float32), (16, torch.float32),
                                     (32, torch.float32), (64, torch.float32)],
                         ids=str)
def test_spmm_bucketed_packed_kernel(cuda, f, dtype, width1_rows):
    """K3 on rows of 16-256 bytes (with 9,000 rows of width 1 the output
    rows outnumber the warps an H100 holds and take the packed kernel),
    with and without the launch order and from storage offset by one
    element, against the plain version: buckets of widths 1, 7, 31, 33 and
    130 and an empty one, zero weights, indices outside [0, NX), a NaN row
    named only by weight-0 slots, degree-0 rows; two launches agree bit
    for bit."""
    k3 = _narrow_layout(cuda, width1_rows)
    nx = 400
    x = _x(nx, f, dtype, cuda, f)
    x[0] = float("nan")
    inv_perm, shapes = k3[:2]
    ref = hk.spmm_bucketed_reference(x, *k3)
    assert torch.isfinite(ref).all()
    zero_rows = inv_perm == sum(r for r, _ in shapes)
    before = hk.LAUNCHES["spmm_bucketed"]
    runs = [hk.spmm_bucketed(x, *k3), hk.spmm_bucketed(x, *k3),
            hk.spmm_bucketed(x, *k3[:4]),
            hk.spmm_bucketed(_offset_copy(x), *k3)]
    torch.cuda.synchronize()
    assert hk.LAUNCHES["spmm_bucketed"] == before + 4
    for got in runs:
        assert got.dtype == dtype and torch.isfinite(got).all()
        assert not got[zero_rows].any()
        torch.testing.assert_close(got.float(), ref.float(),
                                   **FEATURE_TOL[dtype])
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("f", [4, 16, 24, 28])
@pytest.mark.parametrize("d", [1, 8, 32, 33])
def test_spmm_ell_packed_kernel(cuda, d, f):
    """K1 on slot matrices of 1 to 33 columns (33 leaves the packed
    kernel), with indices outside [0, NX) and zero-weight slots that name a
    NaN row, against the plain version; two launches agree bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(d * 100 + f)
    nx, m_ = 600, 5000
    nbr = torch.randint(-2, nx + 3, (m_, d), generator=gen, device=cuda,
                        dtype=torch.int32)
    w = torch.randn((m_, d), generator=gen, device=cuda)
    w[::3] = 0.0
    w[nbr == 0] = 0.0
    x = _x(nx, f, torch.float32, cuda, f)
    x[0] = float("nan")
    ref = hk.spmm_ell_reference(nbr, w, x)
    before = hk.LAUNCHES["spmm_ell"]
    runs = [hk.spmm_ell(nbr, w, x) for _ in range(2)]
    torch.cuda.synchronize()
    assert hk.LAUNCHES["spmm_ell"] == before + 2
    assert torch.isfinite(runs[0]).all() and (runs[0][::3] == 0).all()
    torch.testing.assert_close(runs[0], ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(runs[0], runs[1])


def test_segment_sum_ell_trial_major_on_the_card(cuda):
    """`segment_sum_ell` on `[S, T, C]` messages with sentinel slots, no
    zero row appended, against the planned bucket-sum."""
    rng = np.random.default_rng(5)
    n_seg, n_slots, t, c = 620, 3556, 32, 24
    ids = rng.integers(0, n_seg, n_slots).astype(np.int32)
    ids[rng.random(n_slots) < 0.1] = n_seg
    plan = seg.SegmentPlan.build(ids, n_seg)
    ops = plan.operands(cuda)
    slots, weight = plan.ell_operands(cuda)
    msgs = torch.from_numpy(
        rng.standard_normal((n_slots, t, c)).astype(np.float32)).to(cuda)
    before = hk.LAUNCHES["spmm_ell"]
    got = seg.segment_sum_ell(n_seg, msgs, ops[0], slots, weight)
    assert hk.LAUNCHES["spmm_ell"] == before + 1
    assert got.shape == (n_seg, t, c)
    torch.testing.assert_close(got, seg.segment_sum_planned(msgs, *ops),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# TwoWL at scale: a capped-ei2 composed layout in bf16, K1 on [N, 32] slots,
# walks on the device
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scale_data():
    """A 3,000-node community graph through the scale pipeline's data build:
    degree cap 32, ei2 cap 128, as the published config."""
    from linkpred_tpu_torch.pipelines import twowl_scale as ts

    cfg = ts.ScaleTwoWLConfig(nodes=3000, edges=15000)
    return cfg, ts.build_scale_data(cfg)


@pytest.mark.parametrize("direction", [0, 1], ids=["forward", "transpose"])
def test_k3_bf16_on_capped_composed_layout(cuda, scale_data, direction):
    """K3 in bf16 at F = 32 on the composed layout of a capped ei2
    structure, with its launch order, against its plain version: one bf16
    ulp of the f32 sum."""
    _, data = scale_data
    trn = m.SplitArrays.from_split(data.train, cuda)
    ops = trn.e1_cops[direction]
    assert ops.k3[4] is not None and ops.k3[4].shape[0] == trn.num_rows
    x = _x(trn.num_rows, 32, torch.bfloat16, cuda, seed=direction)
    before = hk.LAUNCHES["spmm_bucketed"]
    got = hk.spmm_bucketed(x, *ops.k3)
    assert hk.LAUNCHES["spmm_bucketed"] == before + 1
    ref = hk.spmm_bucketed_reference(x, *ops.k3)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), rtol=2**-7, atol=1e-6)
    one = _x(trn.num_rows, 1, torch.float32, cuda, seed=2)
    torch.testing.assert_close(hk.spmm_bucketed(one, *ops.k3),
                               hk.spmm_bucketed_reference(one, *ops.k3),
                               rtol=1e-5, atol=1e-5)


def test_gather_sum_composed_bf16_grad_on_k3(cuda, scale_data):
    _, data = scale_data
    trn = m.SplitArrays.from_split(data.train, cuda)
    x = _x(trn.num_rows, 32, torch.bfloat16, cuda, seed=3)
    cot = _x(trn.num_rows, 32, torch.bfloat16, cuda, seed=4)
    outs, grads = [], []
    for kernel in (True, False):
        xx = x.clone().requires_grad_()
        out = seg.gather_sum_composed(xx, *trn.e1_cops, kernel)
        out.backward(cot)
        outs.append(out.detach())
        grads.append(xx.grad)
    assert outs[0].dtype == grads[0].dtype == torch.bfloat16
    for a, b in (outs, grads):
        torch.testing.assert_close(a.float(), b.float(), rtol=2**-7, atol=1e-6)


def test_k1_on_capped_slots_forward_and_grad(cuda, scale_data):
    """K1 at `[N, 32]` slots (the degree cap) and F = 24."""
    _, data = scale_data
    trn = m.SplitArrays.from_split(data.train, cuda)
    assert trn.msg_slots.shape == (data.num_nodes, 32)
    x = _x(trn.num_msg, 24, torch.float32, cuda, seed=5)
    before = hk.LAUNCHES["spmm_ell"]
    got = hk.spmm_ell(trn.msg_slots, trn.msg_sweight, x)
    assert hk.LAUNCHES["spmm_ell"] == before + 1
    torch.testing.assert_close(
        got, hk.spmm_ell_reference(trn.msg_slots, trn.msg_sweight, x),
        rtol=1e-5, atol=1e-5)
    cot = _x(data.num_nodes, 24, torch.float32, cuda, seed=6)
    grads = []
    for fn in (lambda v: seg.segment_sum_ell(data.num_nodes, v,
                                             trn.msg_plan[0], trn.msg_slots,
                                             trn.msg_sweight),
               lambda v: seg.segment_sum_planned(v, *trn.msg_plan)):
        xx = x.clone().requires_grad_()
        fn(xx).backward(cot)
        grads.append(xx.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)


def test_walks_valid_on_the_device(cuda, scale_data):
    from linkpred_tpu_torch.data.graph import Graph
    from linkpred_tpu_torch.ops.walk import WalkEngine

    _, data = scale_data
    msg = data.train.msg[::2]
    g = Graph.from_undirected_edges(msg[:, 0], msg[:, 1],
                                    num_nodes=data.num_nodes)
    eng = WalkEngine(g, p=0.5, q=2.0, device=cuda)
    walks = eng.walks(torch.Generator(device=cuda).manual_seed(0), 4, 12)
    assert walks.is_cuda and walks.shape == (4 * g.num_nodes, 12)
    w = walks.cpu().numpy()
    np.testing.assert_array_equal(w[:, 0], np.tile(np.arange(g.num_nodes), 4))
    a, b = w[:, :-1].reshape(-1), w[:, 1:].reshape(-1)
    key = set((g.src.astype(np.int64) * g.num_nodes + g.dst).tolist())
    hop = a.astype(np.int64) * g.num_nodes + b
    ok = np.fromiter((h in key for h in hop.tolist()), bool, len(hop))
    assert (ok | ((a == b) & (g.degree[a] == 0))).all()


def test_bf16_train_step_ell_matches_plan(cuda, scale_data):
    """One bf16 train step of the scale model on K1 and K3 against the
    plain aggregations from the same parameters: the losses agree to bf16
    rounding of the 2-WL stack, and every parameter moves by at most 2 lr
    apart (Adam turns a near-zero gradient's sign into an lr-size step)."""
    from linkpred_tpu_torch.pipelines import twowl_scale as ts

    cfg, data = scale_data
    trn = m.SplitArrays.from_split(data.train, cuda)
    pos, neg = (torch.as_tensor(a[0], dtype=torch.long, device=cuda)
                for a in ts.batch_schedule(
                    dataclasses.replace(cfg, epochs=1), data))
    start = m.init_params(ts.model_config(cfg, data, "ell"),
                          torch.Generator().manual_seed(0), cuda)
    losses, params = {}, {}
    for agg in ("ell", "plan"):
        mcfg = ts.model_config(cfg, data, agg)
        assert mcfg.compute_dtype == "bf16"
        p = m.tree_map(lambda t: t.detach().clone().requires_grad_(), start)
        before = dict(hk.LAUNCHES)
        loss, logits, _ = m.train_step(p, m.adam(p, 1e-3), None, pos, neg,
                                       trn, mcfg, data.num_nodes)
        launched = {k: hk.LAUNCHES[k] - before[k] for k in before}
        # both aggregations: the row gather for the node table, depth1
        # h[src], the edge product and its two gradient terms, the pair
        # select and depth1 segment-sum backwards (`_gather_dst`)
        assert launched.pop("gather_rows") == 9, launched
        if agg == "ell":
            # K1: depth1 forward passes; K3: the degree pass and depth2
            # forward and backward passes
            assert launched["spmm_ell"] == 2, launched
            assert launched["spmm_bucketed"] == 5, launched
        else:
            assert not any(launched.values()), launched
        assert torch.isfinite(logits).all()
        losses[agg], params[agg] = float(loss), p
    assert abs(losses["ell"] - losses["plan"]) <= 2e-2 * abs(losses["plan"])
    for a, b in zip(m.tree_leaves(params["ell"]),
                    m.tree_leaves(params["plan"])):
        assert float((a - b).detach().abs().max()) <= 2e-3 + 1e-6


# ---------------------------------------------------------------------------
# SEAL
# ---------------------------------------------------------------------------


def _subgraph_stack(seed, P=64, K=40, p_edge=0.08):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2, K + 1, P).astype(np.int32)
    mask = np.arange(K)[None, :] < sizes[:, None]
    adj = rng.random((P, K, K)) < p_edge
    adj = adj | adj.transpose(0, 2, 1)
    adj &= mask[:, :, None] & mask[:, None, :]
    adj = adj.astype(np.uint8)
    adj[:, 0, 1] = adj[:, 1, 0] = 0
    return adj, mask, sizes


@pytest.mark.parametrize("seed,K", [(0, 40), (1, 100)])
def test_drnl_tags_on_the_card_match_native(cuda, seed, K):
    from linkpred_tpu_torch import native
    from linkpred_tpu_torch.data import subgraph as sg

    assert native.available()
    adj, mask, sizes = _subgraph_stack(seed, K=K)
    got = sg.drnl_tags(torch.as_tensor(adj, device=cuda),
                       torch.as_tensor(mask, device=cuda))
    assert got.device.type == "cuda" and got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  native.drnl_tags_batch(adj, mask, sizes))


def test_dgcnn_step_on_the_card_matches_cpu(cuda):
    """One `train_steps` step (dropout off) from the same parameters on the
    card and on the CPU: the same loss and gradients; the updated
    parameters within 2 lr (Adam's first step moves each by lr times the
    sign of its gradient, and a gradient near 0 may take either sign)."""
    from linkpred_tpu_torch.data import subgraph as sg
    from linkpred_tpu_torch.models import seal

    adj, mask, sizes = _subgraph_stack(2, P=48, K=30, p_edge=0.15)
    tags, tsize = sg.compact_tags(
        sg.drnl_tags(torch.as_tensor(adj), torch.as_tensor(mask)).numpy(),
        mask)
    rng = np.random.default_rng(3)
    batch = sg.SubgraphBatch(
        nodes=(rng.integers(0, 90, mask.shape) * mask).astype(np.int32),
        node_mask=mask, adj=adj, sizes=sizes, tags=tags, tags_size=tsize)
    emb = rng.standard_normal((90, 16)).astype(np.float32)
    labels = rng.integers(0, 2, 48).astype(np.int32)
    idx = seal.batch_schedule(rng, np.arange(48), 16, 1)[:1]
    k = seal.threshold_from_sizes(sizes, 60.0)
    start = seal.init_params(torch.Generator().manual_seed(0),
                             tsize + 16, k, "cpu")
    lr, out = 1e-3, {}
    for dev in ("cpu", cuda):
        p = seal.params_from_jax(
            seal.DGCNNParams(tuple(w.detach().numpy() for w in start.gw),
                             *(t.detach().numpy() for t in start[1:])), dev)
        stack = seal.CompactStack.from_batch(batch, emb, labels, dev)
        rows = torch.as_tensor(idx, device=dev)
        d_inv, a_tilde, x, m_, y = stack.minibatch(rows[0])
        grads = torch.autograd.grad(
            seal.loss_fn(p, d_inv, a_tilde, x, m_, y, k, None, 0.0),
            seal.leaves(p), allow_unused=True)
        loss = seal.train_steps(p, seal.adam(p, lr), rows, stack, k, 0.0)
        out[str(dev)] = (loss.cpu(),
                         [None if g is None else g.cpu() for g in grads],
                         [t.detach().cpu() for t in seal.leaves(p)])
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-6)
    for a, b in zip(gg, gc):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    for a, b in zip(pg, pc):
        assert float((a - b).abs().max()) <= 2 * lr + 1e-6


def test_dispatch_entries_launch_k1_and_k2(cuda):
    """`spmm_ell_auto`, `sddmm_auto` and `spmm_auto(force='pallas')` launch
    their kernels on CUDA tensors and agree with the plain versions."""
    rng = np.random.default_rng(4)
    n, d, f = 300, 12, 40
    nbr = rng.integers(0, n, (n, d))
    # an ELL layout: each row's live slots first, as `Graph` builds them
    mask = np.arange(d)[None, :] < rng.integers(0, d + 1, n)[:, None]
    w = rng.random((n, d)).astype(np.float32)
    x = torch.as_tensor(rng.standard_normal((n, f)).astype(np.float32),
                        device=cuda)
    before = dict(hk.LAUNCHES)
    got = hk.spmm_ell_auto(torch.as_tensor(nbr, device=cuda),
                           torch.as_tensor(mask, device=cuda), x,
                           torch.as_tensor(w, device=cuda))
    ref = spmm.spmm_ell(torch.as_tensor(nbr, device=cuda),
                        torch.as_tensor(mask, device=cuda), x,
                        torch.as_tensor(w, device=cuda))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    pallas = spmm.spmm_auto(nbr, mask, x, force="pallas")
    bucketed = spmm.spmm_auto(nbr, mask, x, force="bucketed")
    torch.testing.assert_close(pallas, bucketed, rtol=1e-5, atol=1e-5)
    src = torch.as_tensor(rng.integers(0, n, 500), device=cuda)
    dst = torch.as_tensor(rng.integers(0, n, 500), device=cuda)
    torch.testing.assert_close(hk.sddmm_auto(src, dst, x),
                               hk.sddmm_reference(src, dst, x, x),
                               rtol=1e-5, atol=1e-4)
    launched = {k: hk.LAUNCHES[k] - before[k] for k in before}
    assert launched == {"spmm_ell": 2, "spmm_bucketed": 1, "sddmm": 1,
                        "sddmm_grad": 0, "gather_rows": 0}


@pytest.mark.parametrize("agg", ["plan", "ell"])
def test_entry_on_the_card_matches_cpu(cuda, agg):
    """`graft_entry.entry()` runs on the card by default and scores the toy
    graph as its CPU run does (the init is drawn on the host from seed 0);
    'ell' launches K1 and K3, 'plan' neither; both gather on the row
    gather."""
    from linkpred_tpu_torch.graft_entry import entry

    fn, args = entry(agg_1wl=agg)
    assert args[1].is_cuda
    before = dict(hk.LAUNCHES)
    got = fn(*args)
    torch.cuda.synchronize()
    launched = {k: hk.LAUNCHES[k] - before[k] for k in before}
    fn_cpu, args_cpu = entry(device="cpu", agg_1wl=agg)
    torch.testing.assert_close(got.cpu(), fn_cpu(*args_cpu), rtol=1e-5,
                               atol=1e-5)
    assert launched.pop("gather_rows") > 0, launched
    if agg == "ell":
        assert launched["spmm_ell"] > 0 and launched["spmm_bucketed"] > 0
    else:
        assert set(launched.values()) == {0}, launched


def test_device_trace_on_the_card_names_k1(cuda, tmp_path):
    """`device_trace` records the card's kernels whenever a card is visible:
    K1's kernel is named in the trace file. The profiler can lose a
    capture's first events, so K1 is launched many times."""
    import json
    import os

    from linkpred_tpu_torch.utils.profiling import device_trace

    nbr, w, x = _operands(SHAPES[0], 0, cuda)
    with device_trace(str(tmp_path)):
        for _ in range(1000):
            hk.spmm_ell(nbr, w, x)
        torch.cuda.synchronize()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("spmm_ell" in k for k in kernels), sorted(kernels)[:10]


# ---------------------------------------------------------------------------
# the multi-GPU stack: gloo ranks that share the one card
# ---------------------------------------------------------------------------


def test_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """Two gloo ranks on `cuda:0` (gloo moves the CUDA tensors through the
    host; NCCL refuses two ranks on one card): each rank's node-sharded,
    pipelined and halo aggregations and their gradients on K3 against K3's
    plain version on the same operands (f32: rtol 1e-5 as above, held as
    atol 1e-5 on values of order 1), and the TwoWL step with the ei2 slots
    split over the ranks against the whole split's, both on K1 and K3 (one
    SGD step, 1e-5). Every rank launched K3 (and K1)."""
    import torch_ranks
    from linkpred_tpu_torch.data.graph import Graph
    from linkpred_tpu_torch.parallel import multihost

    rng = np.random.default_rng(0)
    n = 301
    lo, hi = rng.integers(0, n, 1500), rng.integers(0, n, 1500)
    g = Graph.from_undirected_edges(lo[lo != hi], hi[lo != hi], num_nodes=n)
    d = np.asarray(g.degree, np.float64) + 1.0
    inv = (1.0 / np.sqrt(d)).astype(np.float32)
    g = dataclasses.replace(g, nbr_weight=np.ascontiguousarray(
        inv[:, None] * inv[g.nbr]))
    x = rng.standard_normal((n, 32)).astype(np.float32)
    t = rng.standard_normal((n, 32)).astype(np.float32)
    pairs = np.stack([rng.integers(0, 40, 160), rng.integers(0, 40, 160)], 1)
    data = build_twowl_data(pairs[pairs[:, 0] != pairs[:, 1]], 40, rng=rng,
                            ei2_bucket=64)
    cfg = m.TwoWLConfig(max_degree=data.max_degree, channels_1wl=16,
                        channels_2wl=8, agg_1wl="ell", dp_emb=0.0,
                        dp_1wl0=0.0, dp_1wl1=0.0, dp_2wl=0.0)
    params = m.tree_map(lambda p: p.detach().numpy(), m.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    out = multihost.launch(
        torch_ranks.card_job, 2, str(tmp_path),
        args=(g, x, t, (data.train, cfg, params, np.arange(4), np.arange(4),
                        data.num_nodes)), timeout_s=600)
    for err, launches in out:
        for k, v in err.items():
            assert v <= 1e-5, (k, v)
        assert launches["spmm_bucketed"] > 0 and launches["spmm_ell"] > 0


def test_distributed_node2vec_on_the_card(cuda, tmp_path):
    """Two gloo ranks on `cuda:0`: `train_sgns_mesh` (the int32 index
    gather and the f32 score all-reduce on CUDA tensors) against the
    one-process replay on the card (atol 2e-4, rtol 1e-3, the JAX test's
    tolerance), and both walk regimes: no walker lost, row r * N + v starts
    at v, every hop an edge."""
    import torch_ranks
    from linkpred_tpu_torch.data.graph import Graph
    from linkpred_tpu_torch.models.word2vec import SGNSConfig
    from linkpred_tpu_torch.parallel import multihost
    from linkpred_tpu_torch.parallel.sgns import train_sgns_mesh_reference

    rng = np.random.default_rng(0)
    n = 60
    lo, hi = rng.integers(0, n, 240), rng.integers(0, n, 240)
    g = Graph.from_undirected_edges(lo[lo != hi], hi[lo != hi], num_nodes=n)
    walks = rng.integers(0, n, (64, 12), dtype=np.int32)
    cfg = SGNSConfig(dim=32, window=4, epochs=10, batch_size=512,
                     ctx_per_center=4, neg_pool=64)
    out = multihost.launch(torch_ranks.card_n2v_job, 2, str(tmp_path),
                           args=(g, walks, cfg), timeout_s=600)
    ref = train_sgns_mesh_reference(5, walks, n, cfg, n_shards=2,
                                    device=cuda)
    has = g.has_edge_matrix()
    for emb, routed, lost, repl in out:
        np.testing.assert_allclose(emb, ref, atol=2e-4, rtol=1e-3)
        assert lost == 0
        for w in (routed, repl):
            assert w.shape == (20 * n, 8)
            np.testing.assert_array_equal(w[:, 0], np.tile(np.arange(n), 20))
            a, b = w[:, :-1].reshape(-1), w[:, 1:].reshape(-1)
            assert bool((has[a, b] | ((a == b) & (g.degree[a] == 0))).all())


# ---------------------------------------------------------------------------
# K2 redesigned: the packed forward (G lanes an edge) and the gradient
# kernel; K1's split kernel for few rows with a long tail
# ---------------------------------------------------------------------------

GRAD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            torch.bfloat16: dict(rtol=2**-7, atol=1e-6)}


def _pairs(e, n, dev, seed, lo=-1, hi=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    hi = n + 1 if hi is None else hi
    return [torch.randint(lo, hi, (e,), generator=gen, device=dev,
                          dtype=torch.int32) for _ in range(2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("f", [8, 16, 24, 64, 128, 256])
@pytest.mark.parametrize("e", [1, 16_384])
def test_sddmm_packed_forward(cuda, e, f, dtype):
    """K2's packed kernel (rows of whole 16-byte groups: G lanes an edge,
    two reads a lane at F = 256 f32) and, from offset storage, the
    warp-per-edge kernel, with indices outside the tables, against the plain
    version; two launches agree bit for bit."""
    n = 20_000
    src, dst = _pairs(e, n, cuda, e + f)
    x, y = _x(n, f, dtype, cuda, 1), _x(n, f, dtype, cuda, 2)
    ref = hk.sddmm_reference(src, dst, x, y)
    before = hk.LAUNCHES["sddmm"]
    runs = [hk.sddmm(src, dst, x, y) for _ in range(2)]
    unaligned = hk.sddmm(src, dst, _offset_copy(x), _offset_copy(y))
    torch.cuda.synchronize()
    assert hk.LAUNCHES["sddmm"] == before + 3
    for got in (runs[0], unaligned):
        assert got.dtype == torch.float32 and got.shape == (e,)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
    assert torch.equal(runs[0], runs[1])


def _grad_inputs(case, dtype, dev, f=128, n=20_000, e=16_384):
    """(g, src, dst, x, y or None) for K2's gradient: `one` / `two` tables,
    `hub` (node 7 named by 500 pairs at both ends, two tables), `outside`
    (indices outside the tables; a NaN row that only such pairs name)."""
    src, dst = _pairs(e, n, dev, 7, 0, n)
    if case == "hub":
        at = torch.arange(e, device=dev)
        src = torch.where(at % 64 == 0, 7, src).to(torch.int32)
        dst = torch.where(at % 66 == 1, 7, dst).to(torch.int32)
    x, y = _x(n, f, dtype, dev, 1), _x(n, f, dtype, dev, 2)
    if case == "outside":
        src, dst = _pairs(e, n, dev, 8)
        x = torch.cat([x, torch.full((1, f), float("nan"), device=dev,
                                     dtype=dtype)])
        # row n of x (NaN) is named only by pairs whose dst is outside y
        src = torch.where(src >= n, -1, src)
        src = torch.where(dst >= n, n, src).to(torch.int32)
    g = torch.randn(e, generator=torch.Generator(device=dev).manual_seed(9),
                    device=dev)
    return g, src, dst, x, (None if case == "one" else y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", ["one", "two", "hub", "outside"])
@pytest.mark.parametrize("f", [128, 64, 33])
def test_sddmm_grad_matches_plain(cuda, f, case, dtype):
    """K2's gradient kernel against its plain version (f32 1e-5; bf16: both
    sum in f32 and round once, so one ulp): one table (the GCN's case) and
    two, a hub of 500 pairs, indices outside the tables and a NaN row only
    they name, rows of 16-byte groups and not (F = 33); two launches agree
    bit for bit, with the order built ahead or by the wrapper."""
    g, src, dst, x, y = _grad_inputs(case, dtype, cuda, f)
    ref = hk.sddmm_grad_reference(g, src, dst, x, y)
    before = hk.LAUNCHES["sddmm_grad"]
    order = hk.incidence_order(src, dst, y is not None)
    runs = [hk.sddmm_grad(g, src, dst, x, y),
            hk.sddmm_grad(g, src, dst, x, y, order)]
    torch.cuda.synchronize()
    assert hk.LAUNCHES["sddmm_grad"] == before + 2
    for got, want in zip(runs[0], ref):
        if want is None:
            assert got is None
            continue
        assert got.dtype == dtype and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(),
                                   **GRAD_TOL[dtype])
    assert all(a is None or torch.equal(a, b)
               for a, b in zip(runs[0], runs[1]))


def test_sddmm_grad_no_pairs(cuda):
    x = _x(5, 8, torch.bfloat16, cuda)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = hk.LAUNCHES["sddmm_grad"]
    dx, dy = hk.sddmm_grad(torch.zeros(0, device=cuda), empty, empty, x, x)
    assert not dx.any() and not dy.any() and dx.dtype == torch.bfloat16
    assert hk.LAUNCHES["sddmm_grad"] == before


def _straddle_inputs(e, two_tables, dtype, dev, f, n=20_000):
    """(g, src, dst, x, y or None) with E odd, so the 2E sorted incidences
    end in a partial window of 16 and, with two tables, the window at
    position E holds the end of dx's incidences and the start of dy's:
    node n - 1 (sorted last) is named by every 33rd src and node 0 (sorted
    first) by every 33rd dst, so at E = 16,385 dx's last run and dy's first
    (~497 incidences each) both cross that window, and with one table row
    n - 1's run ends in the partial window."""
    src, dst = _pairs(e, n, dev, e, 0, n)
    at = torch.arange(e, device=dev)
    src = torch.where(at % 33 == 0, n - 1, src).to(torch.int32)
    dst = torch.where(at % 33 == 1, 0, dst).to(torch.int32)
    x, y = _x(n, f, dtype, dev, 3), _x(n, f, dtype, dev, 4)
    g = torch.randn(e, generator=torch.Generator(device=dev).manual_seed(e),
                    device=dev)
    return g, src, dst, x, (y if two_tables else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("f", [128, 33])
@pytest.mark.parametrize("two_tables", [False, True],
                         ids=["one table", "two tables"])
@pytest.mark.parametrize("e", [1, 7, 16_385])
def test_sddmm_grad_partial_and_straddling_windows(cuda, e, two_tables, f,
                                                   dtype):
    """K2's gradient where 2E is not a multiple of its 16-position window
    (E = 1, 7, 16,385): the partial last window, and with two tables the
    window that holds both halves, crossed by a hub's run on each side;
    against the plain version (f32 1e-5, bf16 one ulp), rows of 16-byte
    groups (F = 128) and not (F = 33); two launches agree bit for bit."""
    g, src, dst, x, y = _straddle_inputs(e, two_tables, dtype, cuda, f)
    ref = hk.sddmm_grad_reference(g, src, dst, x, y)
    before = hk.LAUNCHES["sddmm_grad"]
    runs = [hk.sddmm_grad(g, src, dst, x, y) for _ in range(2)]
    torch.cuda.synchronize()
    assert hk.LAUNCHES["sddmm_grad"] == before + 2
    for got, again, want in zip(*runs, ref):
        if want is None:
            assert got is None and again is None
            continue
        assert got.dtype == dtype and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(),
                                   **GRAD_TOL[dtype])
        assert torch.equal(got, again)


def test_sddmm_coo_backward_on_the_gradient_kernel(cuda):
    """`sddmm_coo`'s backward launches K2's gradient kernel once (one table:
    one gradient), agrees with the plain version, and is the same bit for
    bit from run to run."""
    g, src, dst, x, _ = _grad_inputs("hub", torch.bfloat16, cuda)
    grads = []
    for _ in range(3):
        xx = x.clone().requires_grad_()
        before = dict(hk.LAUNCHES)
        (sd.sddmm_coo(src, dst, xx).float() * g).sum().backward()
        torch.cuda.synchronize()
        assert hk.LAUNCHES["sddmm"] == before["sddmm"] + 1
        assert hk.LAUNCHES["sddmm_grad"] == before["sddmm_grad"] + 1
        grads.append(xx.grad)
    # the score is rounded to bf16, so the kernel's cotangent is g rounded
    ref = hk.sddmm_grad_reference(g.to(torch.bfloat16).float(), src, dst,
                                  x)[0]
    torch.testing.assert_close(grads[0].float(), ref.float(),
                               **GRAD_TOL[torch.bfloat16])
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])


@pytest.mark.parametrize("f", [4, 16, 24, 192, 512, 768])
@pytest.mark.parametrize("d", [114, 200, 512])
def test_spmm_ell_split_kernel(cuda, d, f):
    """K1 on few rows (620) with one long row of `d` live slots among short
    ones (1-32, pads trailing), the layout of fb-pages-food's 1-WL slots that
    the split kernel takes, with indices outside [0, NX) and zero-weight
    slots naming a NaN row, against the plain version (f32 sums of up to
    512 products in another order: atol 5e-5); two launches agree bit for
    bit."""
    gen = torch.Generator(device=cuda).manual_seed(d * 1000 + f)
    nx, m_ = 3556, 620
    nbr = torch.randint(-2, nx + 3, (m_, d), generator=gen, device=cuda,
                        dtype=torch.int32)
    w = torch.randn((m_, d), generator=gen, device=cuda)
    live = torch.randint(1, 33, (m_, 1), generator=gen, device=cuda)
    live[11] = d
    pad = torch.arange(d, device=cuda)[None, :] >= live
    nbr[pad], w[pad] = 0, 0.0
    w[nbr == 0] = 0.0
    w[::5] = 0.0
    x = _x(nx, f, torch.float32, cuda, f)
    x[0] = float("nan")
    ref = hk.spmm_ell_reference(nbr, w, x)
    before = hk.LAUNCHES["spmm_ell"]
    runs = [hk.spmm_ell(nbr, w, x) for _ in range(2)]
    torch.cuda.synchronize()
    assert hk.LAUNCHES["spmm_ell"] == before + 2
    assert torch.isfinite(runs[0]).all() and (runs[0][::5] == 0).all()
    torch.testing.assert_close(runs[0], ref, rtol=1e-5, atol=5e-5)
    assert torch.equal(runs[0], runs[1])


# ---------------------------------------------------------------------------
# fixed-order sums: the plain code between the kernels repeats bit for bit
# ---------------------------------------------------------------------------


def _hub_ids(e, n, dev, seed, hub=0, named=4096):
    """[e] int64 row ids in [0, n) on `dev`, `named` of them the hub row."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, n, (e,), generator=gen, device=dev)
    at = torch.randperm(e, generator=gen, device=dev)[:named]
    ids[at] = hub
    return ids


@pytest.mark.parametrize("f", [1, 25, 32, 100, 128])
def test_add_rows_repeats_on_the_card(cuda, f):
    """`add_rows_` and `add_rows` with one row named 4,096 times among
    16,384 terms, at the SGNS widths (100, 128, a rank's slices 25 and 32)
    and F = 1: two runs agree bit for bit, in place and out of place with
    its gradient, and the sums lie within f32 rounding of float64 ones."""
    from linkpred_tpu_torch.ops import rows

    ids = _hub_ids(16_384, 300, cuda, f)
    src = _x(16_384, f, torch.float32, cuda, f)
    base = _x(300, f, torch.float32, cuda, f + 1)
    runs = [rows.add_rows_(base.clone(), ids, src) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    exact = base.double().index_put((ids,), src.double(), accumulate=True)
    torch.testing.assert_close(runs[0].double(), exact, rtol=1e-5,
                               atol=1e-4)
    outs = []
    for _ in range(2):
        s = src.clone().requires_grad_()
        out = rows.add_rows(base, ids, s)
        out.backward(base)
        outs.append((out.detach(), s.grad))
    assert torch.equal(outs[0][0], runs[0])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_segment_sum_repeats_on_the_card(cuda):
    """`segment_sum` with a segment named 4,096 times, padding ids and a
    mask: two runs agree bit for bit."""
    ids = _hub_ids(16_384, 500, cuda, 7, hub=3)
    ids[::97] = 600  # ids >= num_segments are dropped
    mask = _x(16_384, 1, torch.float32, cuda, 8)[:, 0] > -1.0
    data = _x(16_384, 64, torch.float32, cuda, 9)
    runs = [seg.segment_sum(data, ids, 500, mask) for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and runs[0][3].abs().max() > 1


@pytest.mark.parametrize("kind", ["pooled", "classic"])
@pytest.mark.parametrize("d", [100, 128, 25])
def test_sgns_step_repeats_on_the_card(cuda, kind, d):
    """One SGNS step at the logistic family's width (100), phase (u)'s
    (128) and a rank's slice of the former (25), with 8,192 centers x 8
    contexts and row 0 named 4,096 times among the centers, the contexts
    and the noise rows: two steps from the same tables and draws give the
    same tables bit for bit."""
    from linkpred_tpu_torch.models import word2vec as w2v

    n, bc, nc = 20_000, 8192, 8
    center = _hub_ids(bc, n, cuda, 1)
    context = _hub_ids(bc * nc, n, cuda, 2).reshape(bc, nc)
    valid = _x(bc * nc, 1, torch.float32, cuda, 3).reshape(bc, nc) > -0.3
    if kind == "pooled":
        noise, cfg = _hub_ids(512, n, cuda, 4, named=128), w2v.SGNSConfig(
            dim=d, neg_pool=512)
        step = w2v.sgns_step_pooled
    else:
        noise = _hub_ids(bc * nc * 5, n, cuda, 4).reshape(bc, nc, 5)
        cfg, step = w2v.SGNSConfig(dim=d, neg_pool=0), w2v.sgns_step_classic
    w_in = (_x(n, d, torch.float32, cuda, 5) - 0.5) / d
    w_out = 0.01 * _x(n, d, torch.float32, cuda, 6)
    runs = []
    for _ in range(2):
        a, b = w_in.clone(), w_out.clone()
        step(a, b, center, context, valid, noise, 0.025, cfg)
        runs.append((a, b))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][1], w_out)


def test_gather_by_id_backward_repeats_on_the_card(cuda):
    """The sharded gather's gradient into a rank's block, with one of its
    rows named 4,096 times among 16,384 ids: two runs agree bit for bit."""
    from types import SimpleNamespace

    from linkpred_tpu_torch.parallel import collectives as C

    ids = _hub_ids(16_384, 4 * 5000, cuda, 11, hub=5003)
    own = (ids >= 5000) & (ids < 10_000)
    ctx = SimpleNamespace(saved_tensors=(own, torch.where(own, ids - 5000,
                                                          0)), rows=5000)
    g = _x(16_384, 128, torch.float32, cuda, 12)
    runs = [C._GatherById.backward(ctx, g)[0] for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and runs[0][3].abs().max() > 1


@pytest.mark.parametrize("two_tables", [False, True],
                         ids=["one table", "two tables"])
@pytest.mark.parametrize("f", [128, 33])
def test_sddmm_grad_reference_repeats_six_times(cuda, f, two_tables):
    """K2's plain gradient at E = 16,385 f32 with the hub runs of
    `test_sddmm_grad_partial_and_straddling_windows`: six runs agree bit
    for bit (float64 sums in a fixed order)."""
    g, src, dst, x, y = _straddle_inputs(16_385, two_tables, torch.float32,
                                         cuda, f)
    runs = [hk.sddmm_grad_reference(g, src, dst, x, y) for _ in range(6)]
    for run in runs[1:]:
        assert all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(runs[0], run))


def test_dgcnn_steps_repeat_on_the_card(cuda):
    """Four DGCNN steps with dropout (its generator seeded) from the same
    parameters, twice: the losses and every trained parameter agree bit for
    bit (cuDNN's `conv1d` gradient is deterministic under `cuda_device()`,
    the sort-pool gather names each row once)."""
    from linkpred_tpu_torch.data import subgraph as sg
    from linkpred_tpu_torch.models import seal

    adj, mask, sizes = _subgraph_stack(4, P=96, K=40, p_edge=0.12)
    tags, tsize = sg.compact_tags(
        sg.drnl_tags(torch.as_tensor(adj), torch.as_tensor(mask)).numpy(),
        mask)
    rng = np.random.default_rng(5)
    batch = sg.SubgraphBatch(
        nodes=(rng.integers(0, 200, mask.shape) * mask).astype(np.int32),
        node_mask=mask, adj=adj, sizes=sizes, tags=tags, tags_size=tsize)
    emb = rng.standard_normal((200, 16)).astype(np.float32)
    labels = rng.integers(0, 2, 96).astype(np.int32)
    idx = torch.as_tensor(seal.batch_schedule(rng, np.arange(96), 32, 2),
                          device=cuda)
    k = seal.threshold_from_sizes(sizes, 60.0)
    stack = seal.CompactStack.from_batch(batch, emb, labels, cuda)
    runs = []
    for _ in range(2):
        p = seal.init_params(torch.Generator().manual_seed(0), tsize + 16, k,
                             cuda)
        loss = seal.train_steps(
            p, seal.adam(p, 1e-3), idx, stack, k, seal.DROPOUT_RATE,
            torch.Generator(device=cuda).manual_seed(1))
        runs.append((loss, [t.detach() for t in seal.leaves(p)]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# one short run of each path under `torch.use_deterministic_algorithms`
# (warnings only), in a process of its own: the mode is global and needs
# CUBLAS_WORKSPACE_CONFIG before cuBLAS starts. It prints the messages of
# the ops that have no deterministic implementation on the card.
DETERMINISM_PROBE = r"""
import contextlib, dataclasses, io, json, os, sys, tempfile, warnings
import numpy as np
import torch
from linkpred_tpu_torch.utils.device import cuda_device

dev = cuda_device()
torch.use_deterministic_algorithms(True, warn_only=True)
from linkpred_tpu_torch.models import twowl as m
from linkpred_tpu_torch.models import word2vec as w2v
from linkpred_tpu_torch.pipelines import gcn_scale as gs
from linkpred_tpu_torch.pipelines import seal_pipeline as sp
from linkpred_tpu_torch.pipelines import twowl_pipeline as tp
from linkpred_tpu_torch.pipelines import twowl_scale as ts

def twowl():
    data = tp.build_data(*tp.load_edges(), tp.TwoWLRunConfig(),
                         np.random.default_rng(0))
    return tp.train_routine_fused(
        data, m.TwoWLConfig(max_degree=data.max_degree, agg_1wl="ell"),
        dataclasses.replace(tp.TwoWLRunConfig(), epochs=3), dev)

seen = {}
for name, run in (
    ("sgns", lambda: w2v.train_sgns_device(
        torch.Generator(device=dev).manual_seed(0),
        torch.randint(0, 5000, (4096, 16), device=dev), 5000,
        w2v.SGNSConfig(dim=128, epochs=1, batch_size=65_536))),
    ("twowl", twowl),
    ("gcn", lambda: gs.train_collab(gs.ScaleGCNConfig(
        nodes=20_000, edges=100_000, steps=3), device=dev, verbose=False)),
    ("twowl_scale", lambda: ts.run_twowl_scale(ts.ScaleTwoWLConfig(
        nodes=5000, edges=25_000, epochs=2), device=dev, verbose=False)),
    ("seal", lambda: sp.run_seal(sp.SEALConfig(
        epochs=1, records_dir=tempfile.mkdtemp()), device=dev,
        verbose=False, metrics_file=os.path.join(tempfile.mkdtemp(), "m"),
        checkpoint_prefix=None))):
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.redirect_stdout(io.StringIO()):
        warnings.simplefilter("always")
        run()
        torch.cuda.synchronize()
    seen[name] = sorted({str(w.message).split("\n")[0] for w in caught
                         if "determinis" in str(w.message)})
print(json.dumps(seen))
"""


def test_no_op_without_a_deterministic_implementation(cuda):
    """Short runs of SGNS, one TwoWL trial, the GCN, TwoWL at scale and
    SEAL under `torch.use_deterministic_algorithms(True, warn_only=True)`
    warn of no op that has no deterministic implementation on the card
    (the mode is not used by the package: it is a probe)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", DETERMINISM_PROBE], cwd=root,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(seen) == {"sgns", "twowl", "gcn", "twowl_scale", "seal"}
    assert not any(seen.values()), seen
