"""Card-only checks of the port: kernel K1 and the paths through it on a CUDA
device, against their plain PyTorch versions on the same card.

Every test here carries the `cuda` marker and skips without a card. The file
imports no JAX, so it also runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest`: the suite's conftest imports JAX.) Tolerances: K1 against
its plain version rtol 1e-5, atol 1e-5 (f32 sums of up to 120 products of
normal values reach magnitude ~40, where two summation orders differ by
~2e-5 absolute); rtol 1e-5, atol 1e-6 for the layers above it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from linkpred_tpu.data import io
from linkpred_tpu.data.twowl import build_twowl_data
from linkpred_tpu_torch.models import twowl as m
from linkpred_tpu_torch.ops import hopper_kernels as hk
from linkpred_tpu_torch.ops import segment as seg

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
    got = hk.spmm_ell(nbr, w, x)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["spmm_ell"] == before + 1
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
