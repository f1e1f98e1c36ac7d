"""Readings of the TwoWL scale cell's controls that `calibrate.py` does not
make, on the card at the cell's own size, in one process:

    python3 hbench/calibrate_scale.py --workload twowl-50k.train \
        --n2v-seeds 1 2 ... --control-seeds 1 2 3 [--out DIR]

For each seed of `--n2v-seeds` the node2vec readings (`n2v_auc`,
`n2v_norm`) of the program's table, made as the run makes it
(`n2v_embeddings` at the run's node2vec seed), and of three tables cut
short: the table at its init (node2vec skipped), SGNS at half its epochs,
and half the walks. For each seed of `--control-seeds` a run's whole
readings, sound, and with the reference in the program's place at the
precisions that the configuration states f32 for, run lower: the parts
outside the 2-WL stack at TF32 (`bf16/tf32`) and at bfloat16
(`bf16/bf16`). Each reading is printed as a JSON line and the lot written
to `<out>/calibrate_scale-<workload>.json`. With `--small` it runs on the
CPU at the cell's small size (`small/<workload>.json`), to try it. The
benchmark's runs never run this.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the precisions below the configuration's for its f32 parts
F32_PART_CONTROLS = ("bf16/tf32", "bf16/bf16")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--n2v-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=str(ROOT / "build" / "calibrate"))
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)

    import torch

    from hbench import harness
    from hbench.drivers import twowl

    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.pipelines import twowl_scale as ts
    from linkpred_tpu_torch.utils.device import cuda_device

    device = torch.device("cpu") if args.small else cuda_device()
    cell = harness.workload(harness.load_spec(), args.workload)
    config = harness.load_data("configs", cell["config"])
    traffic = harness.load_data("traffic", cell["traffic"])
    if args.small:
        small_config, small_traffic = harness.small(args.workload)
        config, traffic = ({**config, **small_config},
                           {**traffic, **small_traffic})
    drv = harness.driver(config)
    built = drv.build(config, traffic, device)
    cfg, data = built["cfg"], built["data"]
    rd = drv.reference_data(built)
    cuts = {"n2v_epochs_half": dataclasses.replace(
                cfg, n2v_epochs=max(1, cfg.n2v_epochs // 2)),
            "n2v_walks_half": dataclasses.replace(
                cfg, n2v_walks_per_node=max(1, cfg.n2v_walks_per_node // 2))}
    rows = []

    def record(kind, seed, readings):
        rows.append({"kind": kind, "seed": seed, **readings})
        print(json.dumps(rows[-1]), flush=True)

    for seed in args.n2v_seeds:
        t0 = time.perf_counter()
        init_seed, n2v_seed, _, ref_seed = twowl._seeds(seed)
        mine = drv.reference_table(built, rd, ref_seed, device)
        t_ref = time.perf_counter() - t0
        tables = {"program": ts.n2v_embeddings(cfg, data, device, n2v_seed)}
        tables["n2v_init"] = m.init_params(
            ts.model_config(cfg, data, config["model"]["agg_1wl"]),
            torch.Generator().manual_seed(init_seed), device)["emb"]
        for kind, c in cuts.items():
            tables[kind] = ts.n2v_embeddings(c, data, device, n2v_seed)
        for kind, table in tables.items():
            r = drv.n2v_readings(rd, mine, table)
            if kind == "program":
                r["reference_s"] = t_ref
            record(kind, seed, r)
    for seed in args.control_seeds:
        run = drv.start(dict(built), config, traffic, seed, device)
        record("program_run", seed, drv.readings(run))
        for precision in F32_PART_CONTROLS:
            record(f"control_{precision}", seed,
                   drv.readings(run, control_precision=precision))

    names = sorted({k for r in rows for k in r}
                   - {"kind", "seed", "reference_s"})
    summary = {}
    for kind in sorted({r["kind"] for r in rows}):
        mine_rows = [r for r in rows if r["kind"] == kind]
        summary[kind] = {k: {"max": max(r[k] for r in mine_rows),
                             "min": min(r[k] for r in mine_rows)}
                         for k in names if k in mine_rows[0]}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"calibrate_scale-{args.workload}.json", "w") as f:
        json.dump({"workload": args.workload,
                   "device": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                   "rows": rows, "summary": summary}, f, indent=1)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
