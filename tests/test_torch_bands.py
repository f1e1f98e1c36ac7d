"""AUC bands of the JAX package on the CPU, from which `chip_smoke.py` sets
the port's AUC floors (a floor is the band's minimum less 0.01).

Run as a script to measure a band at a family's full config:

    python tests/test_torch_bands.py gcn --seeds 1 2 3 4
    python tests/test_torch_bands.py seal --seeds 0 1 2 3 4 5

`gcn` is `bench.py:gate_collab_e2e`'s config (235,000 nodes, 60 steps, lr
3e-3) on one CPU device; `seal` is `run_seal(SEALConfig(seed=s))`, run in a
temporary working directory so that nothing of the repo is written. Each
seed prints one JSON line; the last line holds the band. The test below runs
the same code at a toy size.
"""

import argparse
import json
import os
import sys
import tempfile
import time

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "raw_data", "fb-pages-food")


def gcn_auc(seed: int, **overrides) -> dict:
    """The JAX `train_collab` at `gate_collab_e2e`'s config on one CPU
    device, `overrides` applied."""
    from linkpred_tpu.parallel import make_mesh
    from linkpred_tpu.pipelines.gcn_scale import ScaleGCNConfig, train_collab

    cfg = ScaleGCNConfig(**{"steps": 60, "learning_rate": 3e-3,
                            "seed": seed, **overrides})
    out = train_collab(cfg, mesh=make_mesh(n_devices=1, shape=(1, 1)),
                       verbose=False)
    return {"test_auc": float(out["test_auc"]),
            "loss_decreased": bool(out["loss_decreased"])}


def seal_auc(seed: int, **overrides) -> dict:
    """The JAX `run_seal(SEALConfig(seed=seed))`, `overrides` applied, in a
    temporary working directory (it writes its record, checkpoint, plot and
    metrics line relative to it)."""
    from linkpred_tpu.pipelines.seal_pipeline import SEALConfig, run_seal

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            cfg = SEALConfig(seed=seed, records_dir=os.path.join(tmp, "rec"),
                             **overrides)
            out = run_seal(cfg, data_dir=DATA_DIR, verbose=False)
        finally:
            os.chdir(cwd)
    return {"test_auc": float(out["auc"]), "accuracy": float(out["accuracy"]),
            "hop": int(out["hop"]), "threshold_k": int(out["threshold_k"])}


FAMILIES = {"gcn": gcn_auc, "seal": seal_auc}


def band(family: str, seeds, **overrides) -> dict:
    """Run `family` at each seed; print a JSON line per seed and return the
    band: the AUCs, their minimum, mean and population std."""
    aucs = []
    for s in seeds:
        t0 = time.perf_counter()
        res = FAMILIES[family](int(s), **overrides)
        res.update(family=family, seed=int(s),
                   seconds=round(time.perf_counter() - t0, 1))
        print(json.dumps(res), flush=True)
        aucs.append(res["test_auc"])
    a = np.asarray(aucs)
    return {"family": family, "seeds": [int(s) for s in seeds],
            "test_auc": aucs, "min": float(a.min()), "mean": float(a.mean()),
            "std": float(a.std()), "floor": float(a.min()) - 0.01}


def test_band_at_toy_size(capsys):
    """Both band runners at a toy size: one JSON line per seed, the band's
    fields, finite AUCs."""
    g = band("gcn", [0, 1], nodes=600, edges=2400, steps=4, batch_edges=64,
             emb_dim=8, hidden=16, max_degree=16)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line)["seed"] for line in lines] == [0, 1]
    assert g["seeds"] == [0, 1] and len(g["test_auc"]) == 2
    assert all(0.0 <= a <= 1.0 for a in g["test_auc"])
    assert g["min"] == min(g["test_auc"])
    assert np.isclose(g["floor"], g["min"] - 0.01)
    s = band("seal", [3], epochs=1, hop=1, max_neighbors=20)
    assert 0.0 <= s["test_auc"][0] <= 1.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("family", choices=sorted(FAMILIES))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(band(args.family, args.seeds)), flush=True)


if __name__ == "__main__":
    main()
