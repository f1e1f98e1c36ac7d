"""The row gather of the port (`ops/hopper_kernels.gather_rows`, its
autograd form `ops/gather.gather_rows`, and `ops/sddmm.edge_hadamard`, the
gather with the edge product fused in) against PyTorch's `x[idx]` and
`x[src] * x[dst]`: forward and gradient bit for bit (`torch.equal`), the
zero-row sentinel, an index outside the table raising, and the card's
autograd Functions run on CPU tensors; that one train step
and one val forward of the `twowl-50k` configuration at its small size take
the gather at every call site of the TwoWL epoch; and, on a card (the `cuda`
marker), the kernel against the plain version at both benchmark cells'
shapes, bit for bit and repeatable.

The file imports no JAX, so it also runs on a machine with a card:

    python -m pytest tests/test_torch_gather_rows.py -m cuda --noconftest -q
"""

import collections
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from linkpred_tpu_torch.models import twowl as m  # noqa: E402
from linkpred_tpu_torch.ops import gather  # noqa: E402
from linkpred_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from linkpred_tpu_torch.ops import sddmm as sd  # noqa: E402
from linkpred_tpu_torch.ops.rows import with_zero_row  # noqa: E402
from linkpred_tpu_torch.pipelines import twowl_scale as ts  # noqa: E402
from linkpred_tpu_torch.pipelines import twowl_pipeline as tp  # noqa: E402

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

# (name, table rows, trailing shape, dtype, index count, sentinels): widths
# of the port's gathers (F = 16 and 24 f32; the bf16 2-WL rows), F = 1, the
# trial-major [R, T, C] rows, and an empty index
CASES = [
    ("f32 F=1", 40, (1,), torch.float32, 300),
    ("f32 F=16", 40, (16,), torch.float32, 300),
    ("f32 F=24", 40, (24,), torch.float32, 300),
    ("bf16 F=16", 40, (16,), torch.bfloat16, 300),
    ("bf16 F=32", 40, (32,), torch.bfloat16, 300),
    ("f32 [R,T,C]", 40, (4, 6), torch.float32, 300),
    ("f32 empty", 40, (16,), torch.float32, 0),
]


def _operands(n, tail, dtype, count, seed, device="cpu"):
    """A table with repeated and unused rows, indices with repeats, and a
    cotangent, all from numpy."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, *tail)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, count))
    g = torch.from_numpy(
        rng.standard_normal((count, *tail)).astype(np.float32))
    return (x.to(device, dtype), idx.to(device), g.to(device, dtype))


def _grad(fn, x, g):
    """The output of `fn(x)` and the gradient of `<fn(x), g>` at `x`."""
    x = x.detach().clone().requires_grad_()
    out = fn(x)
    out.backward(g)
    return out.detach(), x.grad


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gather_rows_is_indexing_bit_for_bit(case):
    _, n, tail, dtype, count = case
    x, idx, g = _operands(n, tail, dtype, count, seed=1)
    out, dx = _grad(lambda t: gather.gather_rows(t, idx), x, g)
    want, want_dx = _grad(lambda t: t[idx], x, g)
    assert out.dtype == dtype and out.shape == (count, *tail)
    assert torch.equal(out, want) and torch.equal(dx, want_dx)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_edge_hadamard_is_the_product_of_gathers_bit_for_bit(case):
    _, n, tail, dtype, count = case
    x, src, g = _operands(n, tail, dtype, count, seed=2)
    dst = torch.from_numpy(np.random.default_rng(3).integers(0, n, count))
    out, dx = _grad(lambda t: sd.edge_hadamard(src, dst, t), x, g)
    want, want_dx = _grad(lambda t: t[src] * t[dst], x, g)
    assert out.dtype == dtype and out.shape == (count, *tail)
    assert torch.equal(out, want) and torch.equal(dx, want_dx)


F32_CASES = [c for c in CASES if c[3] == torch.float32]


@pytest.mark.parametrize("case", F32_CASES, ids=[c[0] for c in F32_CASES])
def test_the_card_functions_on_cpu_tensors_are_indexing_bit_for_bit(case):
    """The autograd Functions that CUDA tensors take, on CPU tensors (their
    gather then the plain one, their row sums `index_add_`): forward and
    gradient bit for bit `x[idx]` and `x[src] * x[dst]` in f32, whose CPU
    row sums add in the same order."""
    _, n, tail, dtype, count = case
    x, idx, g = _operands(n, tail, dtype, count, seed=12)
    dst = idx.flip(0)
    flat = (lambda t: t.reshape(n, -1))
    rows_of = (lambda out: out.reshape((count, *tail)))
    out, dx = _grad(lambda t: rows_of(gather._GatherRows.apply(flat(t), idx)),
                    x, g)
    want, want_dx = _grad(lambda t: t[idx], x, g)
    assert torch.equal(out, want) and torch.equal(dx, want_dx)
    out, dx = _grad(
        lambda t: rows_of(sd._EdgeHadamard.apply(idx, dst, flat(t))), x, g)
    want, want_dx = _grad(lambda t: t[idx] * t[dst], x, g)
    assert torch.equal(out, want) and torch.equal(dx, want_dx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_sentinel_reads_a_zero_row_and_receives_nothing(dtype):
    """Plain on every dtype; the card's Functions on CPU tensors in f32."""
    x, idx, g = _operands(30, (16,), dtype, 200, seed=4)
    idx[::7] = 30
    dst = idx.flip(0)
    forms = {"gather": (lambda t: gather.gather_rows(t, idx),
                        lambda t: with_zero_row(t)[idx]),
             "hadamard": (lambda t: sd.edge_hadamard(idx, dst, t),
                          lambda t: with_zero_row(t)[idx]
                          * with_zero_row(t)[dst])}
    if dtype == torch.float32:
        forms["gather Function"] = (
            lambda t: gather._GatherRows.apply(t, idx), forms["gather"][1])
        forms["hadamard Function"] = (
            lambda t: sd._EdgeHadamard.apply(idx, dst, t),
            forms["hadamard"][1])
    for name, (fn, plain) in forms.items():
        out, dx = _grad(fn, x, g)
        want, want_dx = _grad(plain, x, g)
        assert torch.equal(out, want) and torch.equal(dx, want_dx), name
        assert not out[::7].any(), name
    # the product form: either operand's sentinel reads a zero row
    y, j, _ = _operands(50, (16,), dtype, 200, seed=5)
    j[::5] = 50
    assert torch.equal(hk.gather_rows(x, idx, y, j),
                       with_zero_row(x)[idx] * with_zero_row(y)[j])
    assert torch.equal(hk.gather_rows(x, idx, g),
                       with_zero_row(x)[idx] * g)


@pytest.mark.parametrize("bad", [31, -1])
@pytest.mark.parametrize("form", ["gather", "hadamard", "product"])
def test_an_index_outside_the_table_raises(form, bad):
    x, idx, _ = _operands(30, (16,), torch.float32, 50, seed=6)
    idx[17] = bad
    with pytest.raises(IndexError):
        if form == "gather":
            gather.gather_rows(x, idx)
        elif form == "hadamard":
            sd.edge_hadamard(idx, idx.flip(0), x)
        else:
            hk.gather_rows(x, idx.flip(0), x, idx)


def _callers():
    """Record each `hopper_kernels.gather_rows` call by the innermost
    package frame outside `ops/gather.py` and `ops/hopper_kernels.py`:
    (file, function) -> calls, and the shapes it gathered."""
    seen = collections.Counter()
    shapes = collections.defaultdict(list)
    package = REPO / "linkpred_tpu_torch"
    skip = {package / "ops" / "gather.py",
            package / "ops" / "hopper_kernels.py"}
    real = hk.gather_rows

    def spy(x, idx, y=None, j=None):
        for frame in inspect.stack()[1:]:
            path = Path(frame.filename).resolve()
            if path.is_relative_to(package) and path not in skip:
                key = (path.name, frame.function)
                seen[key] += 1
                shapes[key].append((tuple(x.shape), x.dtype, idx.shape[0],
                                    y is not None))
                break
        return real(x, idx, y, j)

    return spy, seen, shapes


def _small_50k_config():
    """The `twowl-50k` configuration at its small size, read from the
    benchmark's files (`hbench/configs/twowl-50k.json`, its cell's traffic
    `hbench/traffic/train.json`, both overlaid by
    `hbench/small/twowl-50k.train.json`), as a `ScaleTwoWLConfig` and the
    model's 1-WL aggregation."""
    def read(*parts):
        return json.loads((REPO / "hbench").joinpath(*parts).read_text())

    small = read("small", "twowl-50k.train.json")
    config = {**read("configs", "twowl-50k.json"), **small["config"]}
    traffic = {**read("traffic", "train.json"), **small["traffic"]}
    model = config["model"]
    cfg = ts.ScaleTwoWLConfig(
        **config["scale"], channels_1wl=model["channels_1wl"],
        channels_2wl=model["channels_2wl"], depth1=model["depth1"],
        depth2=model["depth2"], learning_rate=model["lr"],
        compute_dtype=model["dtype"], epochs=traffic["schedule_epochs"],
        seed=config["data_seed"])
    return cfg, model["agg_1wl"]


def test_the_50k_epoch_takes_the_gather_at_every_call_site(monkeypatch):
    """One train step and one val forward of `twowl-50k` at its small size
    (2,000 nodes): the node table's and the pair select's gathers in
    `forward`, `gcn_conv`'s `h[src]`, the edge product and K1's backward
    `_gather_dst`, each through the row gather's wrapper. (On CPU tensors
    the edge product's gradient is autograd's; on the card its two terms
    are fused gathers, which `tests/test_torch_cuda.py` counts.)"""
    cfg, agg = _small_50k_config()
    data = ts.build_scale_data(cfg)
    cpu = torch.device("cpu")
    trn, val = ts.split_operands(data, cpu)
    mcfg = ts.model_config(cfg, data, agg)
    params = m.init_params(mcfg, torch.Generator().manual_seed(7), cpu)
    pos, neg = (torch.as_tensor(a[0], dtype=torch.long)
                for a in ts.batch_schedule(cfg, data))
    spy, seen, shapes = _callers()
    monkeypatch.setattr(hk, "gather_rows", spy)
    m.train_step(params, m.adam(params, mcfg.learning_rate), None, pos, neg,
                 trn, mcfg, data.num_nodes)
    with torch.no_grad():
        m.eval_scores(params, tp.node_features(mcfg, data, cpu), val, mcfg)
    assert seen == {("twowl.py", "forward"): 4, ("twowl.py", "gcn_conv"): 4,
                    ("sddmm.py", "edge_hadamard"): 2,
                    ("segment.py", "_gather_dst"): 2}
    n, c1, c2 = data.num_nodes, mcfg.channels_1wl, mcfg.channels_2wl
    two_wl = torch.bfloat16  # the configuration's 2-WL stack
    assert shapes[("twowl.py", "forward")] == [
        ((n, c1), torch.float32, n, False),
        ((trn.num_rows, c2), two_wl, 2 * (pos.shape[0] + neg.shape[0]),
         False),
        ((n, c1), torch.float32, n, False),
        ((val.num_rows, c2), two_wl, val.num_rows - val.num_msg, False)]
    assert [s[2:] for s in shapes[("sddmm.py", "edge_hadamard")]] == [
        (trn.num_rows, True), (val.num_rows, True)]
    assert all(s[2] == trn.num_msg
               for s in shapes[("segment.py", "_gather_dst")])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from linkpred_tpu_torch.utils.device import cuda_device

    return cuda_device()


# (name, table rows, width, dtype, index count, second operand): the
# gathers of an epoch at both cells' shapes. twowl-50k.train: the 1-WL
# messages' h[src] and K1's backward (351,958 slots from 50,000 rows, F = 24
# and 16 f32), the node table, the train and val edge products (703,916 and
# 366,934 rows of F = 16 f32) and their gradient terms, the pair select
# (bf16); twowl-fbpages.trial1: the same at 620 nodes (3,556 messages, 7,112
# rows, 420 pairs, f32)
CARD_SHAPES = [
    ("50k msg F=24", 50000, 24, torch.float32, 351958, None),
    ("50k msg F=16", 50000, 16, torch.float32, 351958, None),
    ("50k emb", 50000, 24, torch.float32, 50000, None),
    ("50k hadamard", 50000, 16, torch.float32, 703916, "gathered"),
    ("50k val hadamard", 50000, 16, torch.float32, 366934, "gathered"),
    ("50k hadamard grad", 50000, 16, torch.float32, 703916, "rows"),
    ("50k select", 703916, 16, torch.bfloat16, 32768, None),
    ("fb msg F=24", 620, 24, torch.float32, 3556, None),
    ("fb msg F=16", 620, 16, torch.float32, 3556, None),
    ("fb hadamard", 620, 16, torch.float32, 7112, "gathered"),
    ("fb select", 7112, 16, torch.float32, 840, None),
    ("odd bf16 F=7", 300, 7, torch.bfloat16, 1000, "gathered"),
    ("f32 F=1", 300, 1, torch.float32, 1000, "rows"),
]


def _card_operands(shape, seed, dev):
    _, n, f, dtype, count, second = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    idx = rng.integers(0, n + 1, count)  # the sentinel n among them
    ops = [x.to(dev, dtype), torch.from_numpy(idx).to(dev)]
    if second == "gathered":
        j = rng.integers(0, n + 1, count)
        ops += [ops[0], torch.from_numpy(j).to(dev)]
    elif second == "rows":
        ops.append(torch.from_numpy(rng.standard_normal((count, f)).astype(
            np.float32)).to(dev, dtype))
    return ops


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=[s[0] for s in CARD_SHAPES])
def test_kernel_is_the_plain_version_bit_for_bit_and_repeats(cuda, shape):
    ops = _card_operands(shape, seed=8, dev=cuda)
    before = hk.LAUNCHES["gather_rows"]
    got = hk.gather_rows(*ops)
    again = hk.gather_rows(*ops)
    want = hk.gather_rows_reference(*ops)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["gather_rows"] == before + 2
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [s for s in CARD_SHAPES if s[5] is None],
                         ids=[s[0] for s in CARD_SHAPES if s[5] is None])
def test_gather_gradient_on_the_card_is_indexing_bit_for_bit(cuda, shape):
    x, idx = _card_operands(shape, seed=9, dev=cuda)
    idx = idx.clamp(max=x.shape[0] - 1)  # `x[idx]` has no zero row
    g = torch.randn((idx.shape[0], x.shape[1]), device=cuda).to(x.dtype)
    out, dx = _grad(lambda t: gather.gather_rows(t, idx), x, g)
    want, want_dx = _grad(lambda t: t[idx], x, g)
    assert torch.equal(out, want) and torch.equal(dx, want_dx)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_", [703916, 7112])
def test_edge_hadamard_on_the_card_is_the_product_bit_for_bit(cuda, rows_):
    n = 50000 if rows_ > 10000 else 620
    x, src, g = _operands(n, (16,), torch.float32, rows_, seed=10,
                          device=cuda)
    dst = torch.from_numpy(np.random.default_rng(11).integers(0, n, rows_)).to(
        cuda)
    out, dx = _grad(lambda t: sd.edge_hadamard(src, dst, t), x, g)
    want, want_dx = _grad(lambda t: t[src] * t[dst], x, g)
    assert torch.equal(out, want) and torch.equal(dx, want_dx)


@pytest.mark.cuda
def test_an_index_outside_the_table_stops_the_kernel(cuda):
    """In a process of its own: the trap ends that process's CUDA
    context, as a device-side assert of PyTorch's own indexing does."""
    code = ("import torch\n"
            "from linkpred_tpu_torch.ops import hopper_kernels as hk\n"
            "x = torch.zeros((10, 16), device='cuda')\n"
            "hk.gather_rows(x, torch.tensor([3, 11], device='cuda'))\n"
            "torch.cuda.synchronize()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0, proc.stdout
    assert "Error" in proc.stderr, proc.stderr[-2000:]
