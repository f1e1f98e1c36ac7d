"""Parity of the port's metrics, record writers and timer with the JAX
package. AUCs agree to atol 1e-6 (f32 rank sums); host numpy functions and
the files written are exactly equal."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from linkpred_tpu.utils import metrics as jm
from linkpred_tpu.utils import records as jr
from linkpred_tpu.utils import timer as jt
from linkpred_tpu_torch.utils import metrics as tm
from linkpred_tpu_torch.utils import records as tr
from linkpred_tpu_torch.utils import timer as tt

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)


def _case(seed, n, ties=False):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.4).astype(np.float32)
    y[:2] = [0.0, 1.0]
    s = (rng.integers(0, 7, n) if ties
         else rng.standard_normal(n)).astype(np.float32)
    return y, s


class TestAuc:
    @pytest.mark.parametrize("seed,n", [(0, 10), (1, 416), (2, 836)])
    def test_roc_auc_matches_jax_and_numpy(self, seed, n):
        y, s = _case(seed, n)
        got = float(tm.roc_auc(torch.from_numpy(y), torch.from_numpy(s)))
        assert got == pytest.approx(
            float(jm.roc_auc_jax(jnp.asarray(y), jnp.asarray(s))), abs=1e-6)
        assert got == pytest.approx(jm.roc_auc_score(y, s), abs=1e-6)

    @pytest.mark.parametrize("seed", [3, 4])
    def test_ties_take_lower_rank(self, seed):
        y, s = _case(seed, 200, ties=True)
        got = float(tm.roc_auc(torch.from_numpy(y), torch.from_numpy(s)))
        assert got == pytest.approx(
            float(jm.roc_auc_jax(jnp.asarray(y), jnp.asarray(s))), abs=1e-6)

    @pytest.mark.parametrize("ties", [False, True])
    def test_numpy_functions_equal(self, ties):
        y, s = _case(5, 300, ties=ties)
        assert tm.roc_auc_score(y, s) == jm.roc_auc_score(y, s)
        for a, b in zip(tm.roc_curve(y, s), jm.roc_curve(y, s)):
            np.testing.assert_array_equal(a, b)

    def test_single_class_is_nan(self):
        assert np.isnan(tm.roc_auc_score(np.ones(4), np.arange(4.0)))


class TestRecords:
    def test_files_byte_equal(self, tmp_path):
        y, s = _case(6, 50)
        fpr, tpr, _ = jm.roc_curve(y, s)
        for mod, name in ((jr, "jax"), (tr, "torch")):
            d = tmp_path / name
            rec = str(d / "records")
            assert mod.record_path("fb-pages-food", "twowl", rec) == os.path.join(
                rec, "fb-pages-food_auc_record_twowl.txt")
            mod.write_record("fb-pages-food", "twowl", 0.912345678, 0.0123456,
                             rec, append=False)
            mod.write_record("fb-pages-food", "twowl", np.float64(0.5), 1.0,
                             rec, append=True)
            mod.write_roc_json(fpr, tpr, str(d))
            mod.MetricsLogger(str(d / "logs" / "m.jsonl")).log(
                trial=0, val=0.7, ts=1.5, act0=True, best_params={"lr": 0.01})
        for rel in ("records/fb-pages-food_auc_record_twowl.txt", "fpr.json",
                    "tpr.json", "logs/m.jsonl"):
            assert (tmp_path / "torch" / rel).read_bytes() == (
                tmp_path / "jax" / rel).read_bytes(), rel


class TestTimer:
    def test_report_format(self):
        a, b = jt.StepTimer(), tt.StepTimer()
        for t in (a, b):
            with t.span("dataset"):
                pass
            t.spans["dataset"] = 1.25
            with t.span("trial 0"):
                pass
            t.spans["trial 0"] = 2.5
        assert b.order == a.order and b.total == a.total == 3.75
        assert b.report() == a.report()
