"""AUC bands of the JAX package on the CPU, from which `chip_smoke.py` sets
the port's AUC floors (a floor is the band's minimum less 0.01).

Run as a script to measure a band at a family's full config:

    python tests/test_torch_bands.py gcn --seeds 1 2 3 4
    python tests/test_torch_bands.py seal --seeds 0 1 2 3 4 5
    python tests/test_torch_bands.py twowl --seeds 0 1 2 3 4 5 6 7 8 9

`gcn` is `bench.py:gate_collab_e2e`'s config (235,000 nodes, 60 steps, lr
3e-3) on one CPU device; `seal` is `run_seal(SEALConfig(seed=s))`, run in a
temporary working directory so that nothing of the repo is written; `twowl`
is one trial of the published-best LocalWLNet (`TwoWLConfig()` defaults,
`bench.py`'s headline architecture) through `train_routine_fused` for 1,000
epochs with the early stop at 800, on fb-pages-food split by
`default_rng(s)` and initialised from `PRNGKey(s)`. Each seed prints one
JSON line; the last line holds the band. The test below runs the same code
at a toy size.
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
import pytest  # noqa: E402
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


def twowl_auc(seed: int, epochs: int = 1000, **overrides) -> dict:
    """The JAX `train_routine_fused` on fb-pages-food: the split drawn by
    `default_rng(seed)`, `TwoWLConfig` with `overrides` applied, `epochs`
    epochs with the early stop at 800, in a temporary working directory."""
    from linkpred_tpu.data import io
    from linkpred_tpu.data.twowl import build_twowl_data
    from linkpred_tpu.models.twowl import TwoWLConfig
    from linkpred_tpu.pipelines.twowl_pipeline import (TwoWLRunConfig,
                                                       train_routine_fused)

    _, edges = io.load_fb_pages_food(DATA_DIR)
    data = build_twowl_data(edges, int(edges.max()) + 1,
                            rng=np.random.default_rng(seed))
    cfg = TwoWLConfig(max_degree=data.max_degree, **overrides)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            out = train_routine_fused(
                data, cfg, TwoWLRunConfig(seed=seed, epochs=epochs))
        finally:
            os.chdir(cwd)
    return {"test_auc": float(out["test_auc"]),
            "best_val": float(out["best_val"])}


FAMILIES = {"gcn": gcn_auc, "seal": seal_auc, "twowl": twowl_auc}


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


# each runner at a toy size: (seeds, overrides)
TOY = {"gcn": ([0, 1], dict(nodes=600, edges=2400, steps=4, batch_edges=64,
                            emb_dim=8, hidden=16, max_degree=16)),
       "seal": ([3], dict(epochs=1, hop=1, max_neighbors=20)),
       "twowl": ([2], dict(epochs=3, channels_1wl=8, channels_2wl=8))}


@pytest.mark.parametrize("family", sorted(TOY))
def test_band_at_toy_size(family, capsys):
    """A band runner at a toy size: one JSON line per seed, the band's
    fields, finite AUCs."""
    seeds, overrides = TOY[family]
    b = band(family, seeds, **overrides)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line)["seed"] for line in lines] == seeds
    assert all(json.loads(line)["family"] == family for line in lines)
    assert b["seeds"] == seeds and len(b["test_auc"]) == len(seeds)
    assert all(0.0 <= a <= 1.0 for a in b["test_auc"])
    assert b["min"] == min(b["test_auc"])
    assert np.isclose(b["floor"], b["min"] - 0.01)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("family", choices=sorted(FAMILIES))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(band(args.family, args.seeds)), flush=True)


if __name__ == "__main__":
    main()
