"""Benchmark of linkpred_tpu_torch on one NVIDIA card: one run of one cell.

    python3 hbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`), `device`, with `--trace 1` `breakdown`, and last `checks`,
each number the correctness check compared beside its limit (also the last
lines of standard error). Exits non-zero, printing no result, without a
CUDA card (or with fewer than the cell asks for), without the port, or if
the JAX stack or the JAX package was loaded.

Caches of compiled code stay inside the checkout, at fixed paths: the
port's kernels in `build/kernels/`, the toolchains' caches in `hbench/cache/`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HB = Path(__file__).resolve().parent
ROOT = HB.parent
CACHE = HB / "cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(message: str, code: int = 2) -> int:
    print(f"hbench: {message}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from hbench import harness

    if not torch.cuda.is_available():
        return fail("no CUDA card is visible; the benchmark measures the "
                    "card and does not fall back to the CPU")
    spec = harness.load_spec()
    cell = harness.workload(spec, args.workload)
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"cell {args.workload} needs {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} visible")
    try:
        import linkpred_tpu_torch  # noqa: F401
    except ImportError as err:
        return fail(f"the port is not in this checkout: {err}")
    from linkpred_tpu_torch.utils.device import cuda_device

    torch.set_num_threads(2)
    device = cuda_device()
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device, T_START, spec)
    loaded = harness.forbidden_modules()
    if loaded:
        return fail(f"modules of the JAX stack or package are loaded: "
                    f"{loaded}", 3)
    checks = result.pop("checks")
    peak = result.pop("memory_peak_bytes")
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell["chips"], "memory_peak_bytes": peak}
    for key in ("busy_s", "window_s"):
        if key in result:
            device_info[key] = result.pop(key)
    line = {"correct": result.pop("correct"),
            "attempted": result.pop("attempted"),
            "failed": result.pop("failed"), "metrics": result.pop("metrics"),
            "device": device_info, **result, "checks": checks}
    print(json.dumps(line), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
