"""Command-line interface of the port — the counterpart of
`linkpred_tpu/cli.py` for the subcommands ported so far.

    python -m linkpred_tpu_torch.cli twowl                # 10-trial sweep
    python -m linkpred_tpu_torch.cli --seed 3 twowl --epochs 200 --trials 1
    python -m linkpred_tpu_torch.cli twowl --refine 32 --refine-mode adaptive
    python -m linkpred_tpu_torch.cli scale --family gcn   # collab-scale GCN
    python -m linkpred_tpu_torch.cli scale --family twowl # TwoWL at 50k nodes
    python -m linkpred_tpu_torch.cli scale --family seal  # SEAL at 235k nodes
    python -m linkpred_tpu_torch.cli seal --epochs 50 --hop auto
    python -m linkpred_tpu_torch.cli logistic             # node2vec + logistic
    python -m linkpred_tpu_torch.cli node2vec --input graph.edgelist \
        --output graph.emb

Runs on the CUDA card and refuses to start without one. Outputs keep the
reference formats (records_auc/, logs.json, fpr.json/tpr.json, .emb). A ROC
plot is written only where `--roc-png PATH` asks for one (it needs
matplotlib).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def _cmd_logistic(args):
    from linkpred_tpu_torch.pipelines.logistic_pipeline import (
        LogisticConfig,
        run_logistic,
    )
    from linkpred_tpu_torch.utils.device import cuda_device

    res = run_logistic(LogisticConfig(seed=args.seed), device=cuda_device(),
                       verbose=not args.quiet, roc_png=args.roc_png)
    print(f"AUC:{res['auc']:.4f}   Time:{res['fit_seconds']:.4f}")


def _cmd_node2vec(args):
    """Standalone node2vec: walks + embeddings saved as a `.emb` file."""
    import numpy as np
    import torch

    from linkpred_tpu_torch.data.io import load_edgelist
    from linkpred_tpu_torch.models.word2vec import SGNSConfig, train_sgns
    from linkpred_tpu_torch.ops.walk import WalkEngine
    from linkpred_tpu_torch.utils.device import cuda_device

    device = cuda_device()
    g = load_edgelist(args.input, directed=args.directed,
                      weighted=args.weighted)
    eng = WalkEngine(g, p=args.p, q=args.q, device=device)
    walks = eng.walks(torch.Generator(device=device).manual_seed(args.seed),
                      args.num_walks, args.walk_length)
    if args.walks_output:
        np.savetxt(args.walks_output, walks.cpu().numpy(), fmt="%d")
        print(f"wrote {len(walks)} walks to {args.walks_output}")
        if args.output == "/dev/null":
            return
    emb = train_sgns(
        torch.Generator(device=device).manual_seed(args.seed + 1), walks,
        g.num_nodes,
        SGNSConfig(dim=args.dimensions, window=args.window_size,
                   epochs=args.iter))
    with open(args.output, "w") as f:
        f.write(f"{g.num_nodes} {args.dimensions}\n")
        for i in range(g.num_nodes):
            vec = " ".join(f"{v:.6f}" for v in emb[i])
            f.write(f"{i + 1} {vec}\n")  # 1-based ids, as the reference
    print(f"wrote {g.num_nodes} x {args.dimensions} embeddings to "
          f"{args.output}")


def _cmd_seal(args):
    from linkpred_tpu_torch.pipelines.seal_pipeline import SEALConfig, run_seal
    from linkpred_tpu_torch.utils.device import cuda_device

    cfg = SEALConfig(seed=args.seed)
    if args.epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    if args.hop is not None:
        cfg = dataclasses.replace(
            cfg, hop=args.hop if args.hop == "auto" else int(args.hop))
    res = run_seal(cfg, device=cuda_device(), verbose=not args.quiet,
                   roc_png=args.roc_png)
    print(f"AUC:{res['auc']:.4f}   Time:{res['train_seconds']:.4f}")


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
                    verbose=not args.quiet, refine_trials=args.refine,
                    refine_mode=args.refine_mode, roc_png=args.roc_png)
    print(f"AUC:{res['test_auc']:.4f}   (best of {args.trials} trials)")


def _cmd_scale(args):
    """End-to-end training at scale on one card: `--family gcn`
    (`pipelines.gcn_scale`, BASELINE config 5), `--family twowl`
    (`pipelines.twowl_scale`, the capacity-bounded LocalWLNet) or `--family
    seal` (`pipelines.seal_scale`, CSR extraction and the batched DGCNN);
    prints the result as one JSON line."""
    import json

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

    if args.family == "twowl":
        from linkpred_tpu_torch.pipelines.twowl_scale import (
            ScaleTwoWLConfig,
            run_twowl_scale,
        )

        res = run_twowl_scale(ScaleTwoWLConfig(**overrides(epochs=args.steps)),
                              device=device, verbose=not args.quiet)
    elif args.family == "seal":
        from linkpred_tpu_torch.pipelines.seal_scale import (
            ScaleSEALConfig,
            run_seal_scale,
        )

        res = run_seal_scale(ScaleSEALConfig(**overrides(hop=args.hop)),
                             device=device, verbose=not args.quiet)
    else:
        from linkpred_tpu_torch.pipelines.gcn_scale import (
            ScaleGCNConfig,
            train_collab,
        )

        res = train_collab(
            ScaleGCNConfig(**overrides(steps=args.steps, dtype=args.dtype)),
            device=device, verbose=not args.quiet)
    print(json.dumps(res))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="linkpred_tpu_torch", description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    sub = p.add_subparsers(dest="cmd", required=True)
    roc_help = ("also write the ROC plot to this PNG (needs matplotlib; "
                "the reference's path is assets/img/<family>_roc.png)")
    pl = sub.add_parser("logistic", help="node2vec + logistic regression")
    pl.add_argument("--roc-png", default=None, metavar="PATH", help=roc_help)
    ps = sub.add_parser("seal", help="SEAL enclosing-subgraph DGCNN")
    ps.add_argument("--epochs", type=int, default=None)
    ps.add_argument(
        "--hop", default=None, metavar="H",
        help="enclosing-subgraph hop count: 'auto' (CN-vs-AA heuristic, "
             "the reference default) or an integer")
    ps.add_argument("--roc-png", default=None, metavar="PATH", help=roc_help)
    pt = sub.add_parser("twowl",
                        help="TwoWL 2-WL GNN with hyperparameter sweep")
    pt.add_argument("--epochs", type=int, default=None)
    pt.add_argument("--trials", type=int, default=10)
    pt.add_argument("--roc-png", default=None, metavar="PATH", help=roc_help)
    pt.add_argument(
        "--refine", type=int, default=0, metavar="N",
        help="after the sweep, refine the winner's architecture with N "
             "(lr x dropout) trials trained at once in the trial-major layout")
    pt.add_argument(
        "--refine-mode", choices=("flat", "halving", "adaptive"),
        default="flat",
        help="flat: all N trials train the full schedule; halving: the top "
             "half by val AUC survive each 250-epoch rung warm (parameters "
             "and Adam moments); adaptive: 4 rounds of N/4 trials, later "
             "rounds sampled around the best configs seen")
    psc = sub.add_parser(
        "scale", help="end-to-end training at scale on one card (GCN and "
                      "SEAL at collab scale, TwoWL at 50k nodes)")
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
    psc.add_argument("--hop", type=int, default=2,
                     help="SEAL family: enclosing-subgraph hop count")

    pn = sub.add_parser("node2vec", help="standalone node2vec embedding CLI")
    pn.add_argument("--input", required=True)
    pn.add_argument("--output", required=True)
    pn.add_argument("--dimensions", type=int, default=128)
    pn.add_argument("--walk-length", type=int, default=80)
    pn.add_argument("--num-walks", type=int, default=10)
    pn.add_argument("--window-size", type=int, default=10)
    pn.add_argument("--iter", type=int, default=1)
    pn.add_argument("--p", type=float, default=1.0)
    pn.add_argument("--q", type=float, default=1.0)
    pn.add_argument("--directed", action="store_true")
    pn.add_argument("--weighted", action="store_true")
    pn.add_argument("--walks-output", default=None,
                    help="also dump the raw walk paths")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    {"twowl": _cmd_twowl, "scale": _cmd_scale, "logistic": _cmd_logistic,
     "seal": _cmd_seal, "node2vec": _cmd_node2vec}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
