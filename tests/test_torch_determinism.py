"""The port sums in a fixed order, as the JAX package does, so one seed gives
one result on the card (ROADMAP section 3, "runs that did not repeat").

- The guard: no module of `linkpred_tpu_torch/` adds into rows by
  `index_add(_)`, `scatter_add(_)`, `index_reduce(_)` or `scatter_reduce(_)`
  with "sum" or "mean" (atomics on the card, in an order that changes from
  run to run), read with `ast`, except at the entries of `ALLOWED`, each
  with its reason; a stale entry fails.
- The repaired sums on the CPU, where every one of them adds in input order
  (one compute thread): the row helper `ops.rows.add_rows(_)` against
  numpy's `np.add.at`, bit for bit; the SGNS steps against their parent
  (`index_add_` with `alpha=-lr`: it scales each term inside the add, where
  the port now rounds `-lr * grad` first, as the JAX package's
  `.at[].add(-lr * grad)` does, so the two differ by that rounding: 1e-7)
  and against the JAX package's update on the same draws (1e-6: the
  gradients are f32 products summed in another order); `_GatherById`'s
  backward, `segment_sum` and K2's plain gradient against their parents
  (bit for bit, bit for bit, 1e-6: the parent summed in f32, the plain
  gradient now in f64) and the plain gradient against numpy's float64
  `np.add.at`, rounded once, bit for bit.
- `cuda_device()` asks cuDNN for deterministic algorithms.

The same sums on the card, run twice on indices that collide, are in
`tests/test_torch_cuda.py`; whole runs repeat in `chip_smoke.py`'s repeat
phases.
"""

import ast
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linkpred_tpu_torch.models import word2vec as w2v
from linkpred_tpu_torch.ops import hopper_kernels as hk
from linkpred_tpu_torch.ops import rows
from linkpred_tpu_torch.ops import segment as seg
from linkpred_tpu_torch.parallel import collectives as C

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

PORT = Path(__file__).resolve().parents[1] / "linkpred_tpu_torch"

# calls that add into rows by atomics on the card
ADDS = {"index_add", "index_add_", "scatter_add", "scatter_add_",
        "index_reduce", "index_reduce_"}
REDUCES = {"scatter_reduce", "scatter_reduce_"}

# (module, function, call) -> why the call may stay
ALLOWED = {
    ("ops/rows.py", "add_rows_", "index_add_"): (
        "CPU tensors only: the CPU's index_add_ adds the terms one after "
        "another in input order; CUDA tensors take index_put_ with "
        "accumulate"),
    ("ops/rows.py", "add_rows", "index_add"): (
        "CPU tensors only, as add_rows_"),
}


def _reduce_arg(call):
    """The `reduce` argument of a `scatter_reduce` call: its constant, or
    None when it is not a constant."""
    for kw in call.keywords:
        if kw.arg == "reduce":
            node = kw.value
            break
    else:
        if len(call.args) < 4:
            return None
        node = call.args[3]
    return node.value if isinstance(node, ast.Constant) else None


def order_dependent_calls(source: str):
    """(function, call, line) of every call in `source` that adds into rows
    in an order the card does not fix: the `ADDS` names, and
    `scatter_reduce` with "sum" or "mean" (or a reduce that is no
    constant)."""
    found = []

    def visit(node, func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            name = node.func.attr
            if name in ADDS or (name in REDUCES and _reduce_arg(node) not in
                                ("amax", "amin", "prod")):
                found.append((func, name, node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child, func)

    visit(ast.parse(source), "<module>")
    return found


def test_scanner_finds_the_calls_it_looks_for():
    src = """
def a(x, i, s):
    return x.index_add(0, i, s)
def b(x, i, s):
    x.scatter_add_(0, i, s)
    return torch.index_add(x, 0, i, s)
def c(x, i, s, r):
    x.scatter_reduce(0, i, s, "sum")
    x.scatter_reduce(0, i, s, reduce="mean")
    x.scatter_reduce(0, i, s, r)
    x.scatter_reduce(0, i, s, "amax")
    return x.index_put_((i,), s, accumulate=True)
"""
    assert order_dependent_calls(src) == [
        ("a", "index_add", 3), ("b", "scatter_add_", 5), ("b", "index_add", 6),
        ("c", "scatter_reduce", 8), ("c", "scatter_reduce", 9),
        ("c", "scatter_reduce", 10)]


def test_no_order_dependent_sum_outside_the_allow_list():
    found = {}
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        for func, call, line in order_dependent_calls(path.read_text()):
            found.setdefault((rel, func, call), []).append(line)
    unlisted = {k: v for k, v in found.items() if k not in ALLOWED}
    assert not unlisted, f"sums whose order the card does not fix: {unlisted}"
    stale = set(ALLOWED) - set(found)
    assert not stale, f"allow-list entries with no such call: {stale}"
    assert all(reason for reason in ALLOWED.values())


# ---------------------------------------------------------------------------
# the row helper
# ---------------------------------------------------------------------------


def _hub_index(n, e, rng, hub=0, share=0.25):
    """[e] int64 row ids in [0, n), a `share` of them the hub row."""
    index = rng.integers(0, n, e)
    index[rng.random(e) < share] = hub
    return index


@pytest.mark.parametrize("f", [1, 25, 128])
def test_add_rows_is_numpy_add_at(f):
    """A hub row named by ~1,000 of 4,096 terms: the sum of `add_rows_`
    (in place) and `add_rows` (out of place, with its gradient) is numpy's
    `np.add.at`, which adds in input order, bit for bit."""
    rng = np.random.default_rng(f)
    index = _hub_index(40, 4096, rng)
    src = rng.standard_normal((4096, f)).astype(np.float32)
    base = rng.standard_normal((40, f)).astype(np.float32)
    want = base.copy()
    np.add.at(want, index, src)
    got = rows.add_rows_(torch.tensor(base), torch.from_numpy(index),
                         torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), want)
    src_t = torch.tensor(src, requires_grad=True)
    out = rows.add_rows(torch.tensor(base), torch.from_numpy(index), src_t)
    np.testing.assert_array_equal(out.detach().numpy(), want)
    g = torch.from_numpy(rng.standard_normal((40, f)).astype(np.float32))
    out.backward(g)
    np.testing.assert_array_equal(src_t.grad.numpy(), g.numpy()[index])


# ---------------------------------------------------------------------------
# SGNS: the step's row updates
# ---------------------------------------------------------------------------


def _sgns_case(kind, seed=3, n=40, d=16, bc=512, nc=8, pool=64, k=3):
    """Tables at the trainer's scale (the input table's init, a trained-size
    output table) and draws in which row 0 is a hub: a quarter of the
    centers and contexts name it, and a quarter of the pool or ~1,000 of
    the per-pair noise rows."""
    rng = np.random.default_rng(seed)
    w_in = ((rng.random((n, d)) - 0.5) / d).astype(np.float32)
    w_out = (0.01 * rng.standard_normal((n, d))).astype(np.float32)
    center = _hub_index(n, bc, rng)
    context = _hub_index(n, bc * nc, rng).reshape(bc, nc)
    valid = rng.random((bc, nc)) < 0.6
    shape = (pool,) if kind == "pooled" else (bc, nc, k)
    size = int(np.prod(shape))
    noise = _hub_index(n, size, rng, share=min(0.25, 1000 / size)).reshape(
        shape)
    cfg = w2v.SGNSConfig(dim=d, negatives=5 if kind == "pooled" else k,
                         neg_pool=pool if kind == "pooled" else 0)
    return w_in, w_out, center, context, valid, noise, cfg


def _port_step(kind, w_in, w_out, center, context, valid, noise, cfg, lr):
    t_in, t_out = torch.tensor(w_in), torch.tensor(w_out)
    step = w2v.sgns_step_pooled if kind == "pooled" else w2v.sgns_step_classic
    step(t_in, t_out, *(torch.as_tensor(a) for a in (center, context, valid,
                                                     noise)), lr, cfg)
    return t_in.numpy(), t_out.numpy()


def _parent_step(kind, w_in, w_out, center, context, valid, noise, cfg, lr):
    """The parent's step bodies: the same gradients, added by
    `index_add_(..., alpha=-lr)`."""
    t_in, t_out = torch.tensor(w_in), torch.tensor(w_out)
    center, context, noise = (torch.as_tensor(a) for a in (center, context,
                                                           noise))
    validf = torch.as_tensor(valid).float()
    Bc, nc = context.shape
    vc = t_in[center]
    uo = t_out[context.reshape(-1)].reshape(Bc, nc, -1)
    g_pos = (torch.sigmoid(torch.einsum("bd,bnd->bn", vc, uo)) - 1.0) * validf
    if kind == "pooled":
        U = t_out[noise]
        nvalid = validf.sum(dim=1) * (cfg.negatives / noise.shape[0])
        g_neg = torch.sigmoid(vc @ U.T) * nvalid[:, None]
        grad_vc = torch.einsum("bn,bnd->bd", g_pos, uo) + g_neg @ U
        rows_n, grad_n = noise, g_neg.T @ vc
    else:
        K = noise.shape[2]
        un_ = t_out[noise.reshape(-1)].reshape(Bc, nc, K, -1)
        g_neg = torch.sigmoid(torch.einsum("bd,bnkd->bnk", vc, un_)) \
            * validf[:, :, None]
        grad_vc = torch.einsum("bn,bnd->bd", g_pos, uo) + torch.einsum(
            "bnk,bnkd->bd", g_neg, un_)
        rows_n = noise.reshape(-1)
        grad_n = (g_neg[:, :, :, None] * vc[:, None, None, :]).reshape(
            Bc * nc * K, -1)
    grad_uo = g_pos[:, :, None] * vc[:, None, :]
    t_in.index_add_(0, center, grad_vc, alpha=-lr)
    t_out.index_add_(0, context.reshape(-1), grad_uo.reshape(Bc * nc, -1),
                     alpha=-lr)
    t_out.index_add_(0, rows_n, grad_n, alpha=-lr)
    return t_in.numpy(), t_out.numpy()


def _jax_step(kind, w_in, w_out, center, context, valid, noise, cfg, lr):
    """The JAX package's step bodies (`linkpred_tpu/models/word2vec.py`,
    `step_pooled` and `step_classic` of `_train`) on the given draws: the
    gradients, then `.at[].add(-lr * grad)`."""
    w_in, w_out = jnp.asarray(w_in), jnp.asarray(w_out)
    Bc, nc = context.shape
    vc = w_in[center]
    uo = w_out[context.reshape(-1)].reshape(Bc, nc, -1)
    validf = jnp.asarray(valid, jnp.float32)
    g_pos = (1 / (1 + jnp.exp(-jnp.einsum("bd,bnd->bn", vc, uo))) - 1.0) \
        * validf
    if kind == "pooled":
        U = w_out[noise]
        nvalid = validf.sum(axis=1) * (cfg.negatives / cfg.neg_pool)
        g_neg = 1 / (1 + jnp.exp(-(vc @ U.T))) * nvalid[:, None]
        grad_vc = jnp.einsum("bn,bnd->bd", g_pos, uo) + g_neg @ U
        rows_n, grad_n = noise, g_neg.T @ vc
    else:
        K = noise.shape[2]
        un_ = w_out[noise.reshape(-1)].reshape(Bc, nc, K, -1)
        g_neg = 1 / (1 + jnp.exp(-jnp.einsum("bd,bnkd->bnk", vc, un_))) \
            * validf[:, :, None]
        grad_vc = jnp.einsum("bn,bnd->bd", g_pos, uo) + jnp.einsum(
            "bnk,bnkd->bd", g_neg, un_)
        rows_n = noise.reshape(-1)
        grad_n = (g_neg[:, :, :, None] * vc[:, None, None, :]).reshape(
            Bc * nc * K, -1)
    grad_uo = g_pos[:, :, None] * vc[:, None, :]
    w_in = w_in.at[center].add(-lr * grad_vc)
    w_out = w_out.at[context.reshape(-1)].add(-lr * grad_uo.reshape(
        Bc * nc, -1))
    w_out = w_out.at[rows_n].add(-lr * grad_n)
    return np.asarray(w_in), np.asarray(w_out)


@pytest.mark.parametrize("kind", ["pooled", "classic"])
def test_sgns_step_against_parent_and_jax(kind):
    """One step whose hub row takes 128 updates of the input table and
    ~1,000-2,000 of the output table: against the parent's `index_add_`
    (1e-7), and against the JAX package's `.at[].add` step on the same
    draws (1e-6); the update moved the hub."""
    case = _sgns_case(kind)
    lr = 0.025
    got = _port_step(kind, *case, lr)
    parent = _parent_step(kind, *case, lr)
    ref = _jax_step(kind, *case, lr)
    for new, old, want, before in zip(got, parent, ref, case[:2]):
        np.testing.assert_allclose(new, old, rtol=0, atol=1e-7)
        np.testing.assert_allclose(new, want, rtol=0, atol=1e-6)
        assert np.abs(new[0] - before[0]).max() > 1e-4


def test_train_sgns_device_is_the_input_table_of_train_sgns_tables():
    walks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 30, (40, 12)))
    cfg = w2v.SGNSConfig(dim=8, window=3, epochs=1, batch_size=256,
                         neg_pool=16)
    tables = w2v.train_sgns_tables(torch.Generator().manual_seed(1), walks,
                                   30, cfg)
    emb = w2v.train_sgns_device(torch.Generator().manual_seed(1), walks, 30,
                                cfg)
    assert len(tables) == 2 and torch.equal(tables[0], emb)
    assert tables[1].shape == (30, 8) and tables[1].abs().max() > 0


# ---------------------------------------------------------------------------
# the sharded gather's gradient, segment_sum and K2's plain gradient
# ---------------------------------------------------------------------------


def test_gather_by_id_backward_against_parent():
    """The gradient of a rank's block: a hub row named by ~1,000 of 4,096
    ids, ids owned by other ranks dropped; the parent's `index_add_`, bit
    for bit (both add in input order on the CPU)."""
    rng = np.random.default_rng(5)
    rows_, lo = 50, 50  # this rank's block: global rows 50..99
    ids = torch.from_numpy(_hub_index(200, 4096, rng, hub=60))
    own = (ids >= lo) & (ids < lo + rows_)
    local = torch.where(own, ids - lo, 0)
    g = torch.from_numpy(rng.standard_normal((4096, 24)).astype(np.float32))
    ctx = SimpleNamespace(saved_tensors=(own, local), rows=rows_)
    dx = C._GatherById.backward(ctx, g)[0]
    parent = g.new_zeros((rows_, 24)).index_add_(0, local[own], g[own])
    assert torch.equal(dx, parent) and dx[10].abs().max() > 1


def test_segment_sum_against_parent():
    """`segment_sum` with a hub segment, capacity padding and a mask: the
    parent's `index_add`, bit for bit, and the gradient a gather."""
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(_hub_index(30, 3000, rng, hub=7))
    ids[::50] = 35  # ids >= num_segments are dropped
    mask = torch.from_numpy(rng.random(3000) < 0.8)
    data = torch.tensor(rng.standard_normal((3000, 5)).astype(np.float32),
                        requires_grad=True)
    got = seg.segment_sum(data, ids, 30, mask)
    masked = data.detach() * mask[:, None].float()
    parent = masked.new_zeros((31, 5)).index_add(
        0, ids.clamp(max=30), masked)[:30]
    assert torch.equal(got.detach(), parent)
    got.sum().backward()
    keep = mask & (ids < 30)
    assert torch.equal(data.grad, keep[:, None].float().expand(-1, 5))


def _parent_sddmm_grad(g, src, dst, x, y=None):
    """The parent's plain K2 gradient: f32 terms added by `index_add_`."""
    table = x if y is None else y
    keep = ((src >= 0) & (src < x.shape[0]) & (dst >= 0)
            & (dst < table.shape[0]))
    s = torch.where(keep, src, 0).long()
    d = torch.where(keep, dst, 0).long()
    gk = g.float()[:, None]

    def term(index, rows_):
        return index, torch.where(keep[:, None], gk * rows_.float(), 0.0)

    into_x = term(s, table.index_select(0, d))
    into_y = term(d, x.index_select(0, s))
    f = x.shape[1]
    if y is None:
        out = torch.zeros((x.shape[0], f))
        out.index_add_(0, torch.cat([into_x[0], into_y[0]]),
                       torch.cat([into_x[1], into_y[1]]))
        return out.to(x.dtype), None
    dx = torch.zeros((x.shape[0], f))
    dy = torch.zeros((y.shape[0], f))
    return (dx.index_add_(0, *into_x).to(x.dtype),
            dy.index_add_(0, *into_y).to(y.dtype))


def _sddmm_case(seed, n=200, e=2000, f=16):
    """Pairs with a hub (row 7 at either end of ~500 pairs), indices outside
    the tables, two tables of N(0, 0.01) values and a cotangent."""
    rng = np.random.default_rng(seed)
    src = rng.integers(-1, n + 1, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    src[rng.random(e) < 0.125] = 7
    dst[rng.random(e) < 0.125] = 7
    x, y = (0.1 * rng.standard_normal((2, n, f))).astype(np.float32)
    g = rng.standard_normal(e).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (g, src, dst, x, y))


@pytest.mark.parametrize("two_tables", [False, True],
                         ids=["one table", "two tables"])
def test_sddmm_grad_reference_is_the_rounded_exact_sum(two_tables):
    """K2's plain gradient is numpy's float64 `np.add.at` of the exact
    products, rounded once to f32, bit for bit; it lies within 1e-6 of the
    parent's f32 `index_add_`, and the bf16 tables' gradient is the f32
    one rounded to bf16."""
    g, src, dst, x, y = _sddmm_case(8 + two_tables)
    y = y if two_tables else None
    got = hk.sddmm_grad_reference(g, src, dst, x, y)
    parent = _parent_sddmm_grad(g, src, dst, x, y)
    table = x if y is None else y
    s, d = src.numpy().astype(np.int64), dst.numpy().astype(np.int64)
    keep = (s >= 0) & (s < x.shape[0]) & (d >= 0) & (d < table.shape[0])
    s, d, gk = s[keep], d[keep], g.numpy()[keep].astype(np.float64)[:, None]
    into_x = gk * table.numpy()[d].astype(np.float64)
    into_y = gk * x.numpy()[s].astype(np.float64)
    want = [np.zeros(x.shape), np.zeros(table.shape)]
    if y is None:
        np.add.at(want[0], np.concatenate([s, d]),
                  np.concatenate([into_x, into_y]))
        want[1] = None
    else:
        np.add.at(want[0], s, into_x)
        np.add.at(want[1], d, into_y)
    for new, old, exact in zip(got, parent, want):
        if exact is None:
            assert new is None and old is None
            continue
        np.testing.assert_array_equal(new.numpy(), exact.astype(np.float32))
        np.testing.assert_allclose(new.numpy(), old.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert np.abs(got[0].numpy()[7]).max() > 0.1
    bf = hk.sddmm_grad_reference(g, src, dst, x.bfloat16(),
                                 None if y is None else y.bfloat16())
    f32 = hk.sddmm_grad_reference(g, src, dst, x.bfloat16().float(),
                                  None if y is None else y.bfloat16().float())
    for a, b in zip(bf, f32):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == torch.bfloat16 and torch.equal(
                a, b.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# cuDNN
# ---------------------------------------------------------------------------


def test_cuda_device_asks_cudnn_for_deterministic_algorithms(monkeypatch):
    """`cuda_device()` sets cuDNN deterministic and without benchmarking,
    beside TF32 off (the card is faked: only the flags are read)."""
    from linkpred_tpu_torch.utils import device

    cudnn = torch.backends.cudnn
    for flag in ("deterministic", "benchmark", "allow_tf32"):
        monkeypatch.setattr(cudnn, flag, getattr(cudnn, flag))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cudnn.deterministic, cudnn.benchmark = False, True
    assert device.cuda_device() == torch.device("cuda", 0)
    assert cudnn.deterministic and not cudnn.benchmark
    assert not cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32

