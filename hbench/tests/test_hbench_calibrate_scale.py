"""`calibrate_scale.py` on the CPU at the 50k cell's small size: one seed of
node2vec readings and one of the f32 parts' controls, written as a file
whose summary names every kind of row."""

import json

from hbench import calibrate_scale

CELL = "twowl-50k.train"


def test_calibrate_scale_runs_small(tmp_path):
    assert calibrate_scale.main(
        ["--workload", CELL, "--small", "--n2v-seeds", "5",
         "--control-seeds", "5", "--out", str(tmp_path)]) == 0
    out = json.loads((tmp_path / f"calibrate_scale-{CELL}.json").read_text())
    kinds = {r["kind"] for r in out["rows"]}
    assert kinds == {"program", "n2v_init", "n2v_epochs_half",
                     "n2v_walks_half", "program_run", "control_bf16/tf32",
                     "control_bf16/bf16"}
    program = next(r for r in out["rows"] if r["kind"] == "program")
    init = next(r for r in out["rows"] if r["kind"] == "n2v_init")
    assert init["n2v_auc"] > program["n2v_auc"]
