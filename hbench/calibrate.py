"""Readings behind the limits of a cell's check, on the card at the cell's
own size, in one process:

    python3 hbench/calibrate.py --workload <name> --seeds 1 2 ... \
        --control-seeds 1 2 3 --fault-seeds 1 2 3 [--out DIR]

For each seed of `--seeds` the program's first three steps against the
reference (sound runs: the lower readings); for each of `--control-seeds`
the reference at the precision below the configuration's (its driver's
`CONTROL_PRECISION`, TF32 for f32) put in the program's place; for each of
`--fault-seeds` the program with each fault of `faults.py` that needs a run (`half_batch`; a state left
unchanged reads 1 by the measure). Each reading is printed as a JSON line
and the lot written to `<out>/calibrate-<workload>.json`. No window is run: the readings need
none. The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=str(ROOT / "build" / "calibrate"))
    args = p.parse_args(argv)

    import torch

    from hbench import faults, harness

    from linkpred_tpu_torch.utils.device import cuda_device

    device = cuda_device()
    spec = harness.load_spec()
    cell = harness.workload(spec, args.workload)
    config = harness.load_data("configs", cell["config"])
    traffic = harness.load_data("traffic", cell["traffic"])
    drv = harness.driver(config)
    control = harness.control_precision(config)
    built = drv.build(config, traffic, device)
    rows = []

    def record(kind, seed, run_readings):
        rows.append({"kind": kind, "seed": seed, **run_readings})
        print(json.dumps(rows[-1]), flush=True)

    def started(seed):
        return drv.start(dict(built), config, traffic, seed, device)

    for seed in args.seeds:
        t0 = time.perf_counter()
        run = started(seed)
        r = drv.readings(run)
        r["seconds"] = time.perf_counter() - t0
        record("program", seed, r)
    for seed in args.control_seeds:
        run = started(seed)
        record(f"control_{control}", seed,
               drv.readings(run, control_precision=control))
    for seed in args.fault_seeds:
        with faults.half_batch():
            run = started(seed)
        record("half_batch", seed, drv.readings(run))

    names = [k for k in rows[0] if k not in ("kind", "seed", "seconds")]
    summary = {}
    for kind in sorted({r["kind"] for r in rows}):
        mine = [r for r in rows if r["kind"] == kind]
        summary[kind] = {k: {"max": max(r[k] for r in mine),
                             "min": min(r[k] for r in mine)} for k in names}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"calibrate-{args.workload}.json", "w") as f:
        json.dump({"workload": args.workload,
                   "device": torch.cuda.get_device_name(device),
                   "rows": rows, "summary": summary}, f, indent=1)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
