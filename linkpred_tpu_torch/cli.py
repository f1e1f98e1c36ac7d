"""Command-line interface of the port — the counterpart of
`linkpred_tpu/cli.py` for the subcommands ported so far.

    python -m linkpred_tpu_torch.cli twowl                # 10-trial sweep
    python -m linkpred_tpu_torch.cli --seed 3 twowl --epochs 200 --trials 1
    python -m linkpred_tpu_torch.cli scale --family gcn   # collab-scale GCN

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


def _cmd_scale(args):
    """Collab-scale GCN training on one card (`pipelines.gcn_scale`,
    BASELINE config 5); prints the result as one JSON line."""
    import json

    if args.family != "gcn":
        raise NotImplementedError(
            f"scale --family {args.family} waits for its slice of the port "
            "(twowl: slice 3, seal: slice 4; ROADMAP.md)")
    from linkpred_tpu_torch.pipelines.gcn_scale import (
        ScaleGCNConfig,
        train_collab,
    )
    from linkpred_tpu_torch.utils.device import cuda_device

    device = cuda_device()

    def overrides(**extra):
        # only user-provided values override the pipeline's own defaults
        out = {k: v for k, v in (("nodes", args.nodes),
                                 ("edges", args.edges),
                                 ("edges_file", args.edges_file))
               if v is not None}
        out.update({k: v for k, v in extra.items() if v is not None})
        out["seed"] = args.seed
        return out

    res = train_collab(
        ScaleGCNConfig(**overrides(steps=args.steps, dtype=args.dtype)),
        device=device, verbose=not args.quiet)
    print(json.dumps(res))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="linkpred_tpu_torch", description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    sub = p.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("twowl",
                        help="TwoWL 2-WL GNN with hyperparameter sweep")
    pt.add_argument("--epochs", type=int, default=None)
    pt.add_argument("--trials", type=int, default=10)
    psc = sub.add_parser(
        "scale", help="end-to-end collab-scale GCN training on one card")
    psc.add_argument("--family", choices=["gcn", "seal", "twowl"],
                     default="gcn")
    psc.add_argument("--nodes", type=int, default=None)
    psc.add_argument("--edges", type=int, default=None)
    psc.add_argument("--edges-file", default=None, metavar="FILE",
                     help="train on a real edge dump (comma/whitespace "
                          "pairs, header + extra columns tolerated, ids "
                          "relabeled) instead of the synthetic generator")
    psc.add_argument("--steps", type=int, default=None)
    psc.add_argument("--dtype", choices=["f32", "bf16"], default="bf16")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    {"twowl": _cmd_twowl, "scale": _cmd_scale}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
