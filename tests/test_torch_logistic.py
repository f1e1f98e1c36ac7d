"""Parity of the port's logistic family with the JAX package's, on the CPU:
the Newton fit (`models/logistic.py`) on the same `x, y` (rtol 1e-4, atol
1e-5: f32 Cholesky solves in two libraries), the pipeline at small size, and
the checkpoint format in both directions."""

import json
import os

import numpy as np
import jax
import pytest
import torch

from linkpred_tpu.models import logistic as jlog
from linkpred_tpu.models import twowl as jm
from linkpred_tpu.utils import checkpoint as jck
from linkpred_tpu_torch.models import logistic as tlog
from linkpred_tpu_torch.models import twowl as tm
from linkpred_tpu_torch.models.word2vec import SGNSConfig
from linkpred_tpu_torch.pipelines import logistic_pipeline as lp
from linkpred_tpu_torch.utils import checkpoint as tck
from linkpred_tpu_torch.utils import plots

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

FIT_TOL = dict(rtol=1e-4, atol=1e-5)


def _problem(seed, n=400, d=12, pos_share=0.2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d)
    logits = x @ w + np.log(pos_share / (1 - pos_share))
    y = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return x, y


@pytest.mark.parametrize("class_weight", ["balanced", None])
@pytest.mark.parametrize("seed", [0, 1])
def test_fit_and_predict_match_jax(class_weight, seed):
    x, y = _problem(seed)
    beta_t = tlog.fit_logistic(x, y, class_weight=class_weight, device="cpu")
    beta_j = jlog.fit_logistic(x, y, class_weight=class_weight)
    assert beta_t.shape == (13,) and beta_t.dtype == torch.float32
    np.testing.assert_allclose(beta_t.numpy(), beta_j, **FIT_TOL)
    x_new, _ = _problem(seed + 10, n=50)
    np.testing.assert_allclose(
        tlog.predict_proba(beta_t, x_new).numpy(),
        jlog.predict_proba(beta_j, x_new), **FIT_TOL)


def test_fit_takes_tensors_and_other_c():
    x, y = _problem(2)
    beta_t = tlog.fit_logistic(torch.as_tensor(x), torch.as_tensor(y), c=0.1,
                               num_iters=8, device="cpu")
    beta_j = jlog.fit_logistic(x, y, c=0.1, num_iters=8)
    np.testing.assert_allclose(beta_t.numpy(), beta_j, **FIT_TOL)


def test_config_fields_and_defaults_match():
    import dataclasses

    from linkpred_tpu.pipelines.logistic_pipeline import (
        LogisticConfig as JConfig)

    assert dataclasses.asdict(lp.LogisticConfig()) == dataclasses.asdict(
        JConfig())


def test_run_logistic_small(tmp_path):
    """The small config of the JAX package's pipeline test, every output
    under a temporary directory."""
    cfg = lp.LogisticConfig(
        num_walks=10, records_dir=str(tmp_path / "rec"),
        embed=SGNSConfig(dim=32, window=5, negatives=5, epochs=1))
    res = lp.run_logistic(cfg, device="cpu", verbose=False,
                          roc_png=str(tmp_path / "img" / "roc.png"),
                          metrics_file=str(tmp_path / "logs" / "m.jsonl"))
    assert res["auc"] > 0.6
    assert set(res) == {"auc", "fit_seconds", "total_seconds", "fpr", "tpr",
                        "num_pos", "num_neg"}
    rec = (tmp_path / "rec" / "fb-pages-food_auc_record_logistic.txt"
           ).read_text()
    assert rec.startswith("AUC:") and rec.endswith("   \n")
    assert rec.count("\n") == 1
    assert os.path.getsize(tmp_path / "img" / "roc.png") > 0
    line = json.loads((tmp_path / "logs" / "m.jsonl").read_text())
    assert line["family"] == "logistic" and line["auc"] == res["auc"]
    assert line["num_pos"] == res["num_pos"] > 0


def test_plot_without_matplotlib_raises(tmp_path, monkeypatch):
    """A plot that was asked for is not skipped quietly: without matplotlib
    the pipeline raises before it does any work."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError):
        plots.require_matplotlib()
    with pytest.raises(ImportError):
        lp.run_logistic(lp.LogisticConfig(records_dir=str(tmp_path / "rec")),
                        device="cpu", verbose=False,
                        roc_png=str(tmp_path / "roc.png"),
                        metrics_file=str(tmp_path / "m.jsonl"))
    assert not (tmp_path / "rec").exists()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _twowl_params():
    cj = jm.TwoWLConfig(max_degree=9, depth1=2, depth2=2)
    ct = tm.TwoWLConfig(max_degree=9, depth1=2, depth2=2)
    pj = jm.init_params(jax.random.PRNGKey(0), cj)
    pt = tm.init_params(ct, torch.Generator().manual_seed(0), "cpu")
    return pj, pt


def test_checkpoint_round_trip(tmp_path):
    _, pt = _twowl_params()
    path = tck.save_pytree(str(tmp_path / "ck" / "model"), pt, step=7)
    assert path.endswith("model-7.npz") and os.path.exists(path)
    like = tm.tree_map(torch.zeros_like, pt)
    back = tck.restore_pytree(str(tmp_path / "ck" / "model-7"), like)
    assert list(back) == list(pt)  # key order of `like`
    for a, b in zip(tm.tree_leaves(back), tm.tree_leaves(pt)):
        assert a.dtype == b.dtype and torch.equal(a, b.detach())
    tck.save_pytree(str(tmp_path / "ck" / "model"), pt, step=12)
    assert tck.latest_checkpoint(str(tmp_path / "ck"), "model").endswith(
        "model-12.npz")
    assert tck.latest_checkpoint(str(tmp_path / "none"), "model") is None
    with pytest.raises(ValueError, match="leaves"):
        tck.restore_pytree(path, {"emb": pt["emb"]})
    bad = dict(like, pred_b=torch.zeros(2))
    with pytest.raises(ValueError, match="shape"):
        tck.restore_pytree(path, bad)


def test_checkpoint_written_by_jax_restores_in_port(tmp_path):
    pj, pt = _twowl_params()
    jck.save_pytree(str(tmp_path / "jax_model"), pj)
    back = tck.restore_pytree(str(tmp_path / "jax_model"), pt)
    ref = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    assert list(back) == list(pt)  # key order of `like`, leaves by key
    same = tm.tree_map(lambda a, b: a.shape == b.shape
                       and torch.equal(a, b.detach()), back, ref)
    assert all(tm.tree_leaves(same)), same
    assert all(t.requires_grad for t in tm.tree_leaves(back))


def test_checkpoint_written_by_port_restores_in_jax(tmp_path):
    pj, pt = _twowl_params()
    tck.save_pytree(str(tmp_path / "torch_model"), pt)
    back = jck.restore_pytree(str(tmp_path / "torch_model"), pj)
    want = tm.tree_map(lambda t: t.detach().numpy(), pt)
    flat_back = jax.tree_util.tree_leaves(back)
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_back) == len(flat_want)
    for a, b in zip(flat_back, flat_want):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the structure file names the tree as jax prints it
    meta = json.loads((tmp_path / "torch_model.tree.json").read_text())
    jck.save_pytree(str(tmp_path / "jax_model"), pj)
    assert meta == json.loads((tmp_path / "jax_model.tree.json").read_text())
