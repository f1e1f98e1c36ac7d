"""Command-line interface of the port — the counterpart of
`linkpred_tpu/cli.py` for the subcommands ported so far.

    python -m linkpred_tpu_torch.cli twowl                # 10-trial sweep
    python -m linkpred_tpu_torch.cli --seed 3 twowl --epochs 200 --trials 1

Runs on the CUDA card and refuses to start without one. Outputs keep the
reference formats (records_auc/, logs.json, fpr.json/tpr.json).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def _cmd_twowl(args):
    from linkpred_tpu_torch.pipelines.twowl_pipeline import (
        TwoWLRunConfig,
        run_twowl,
    )
    from linkpred_tpu_torch.utils.device import cuda_device

    device = cuda_device()
    run = TwoWLRunConfig(seed=args.seed)
    if args.epochs is not None:
        run = dataclasses.replace(run, epochs=args.epochs)
    res = run_twowl(run, n_trials=args.trials, device=device,
                    verbose=not args.quiet)
    print(f"AUC:{res['test_auc']:.4f}   (best of {args.trials} trials)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="linkpred_tpu_torch", description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    sub = p.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("twowl",
                        help="TwoWL 2-WL GNN with hyperparameter sweep")
    pt.add_argument("--epochs", type=int, default=None)
    pt.add_argument("--trials", type=int, default=10)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    {"twowl": _cmd_twowl}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
