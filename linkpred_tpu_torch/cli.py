"""Command-line interface of the port — the counterpart of
`linkpred_tpu/cli.py`, with its eight subcommands and five global flags.

    python -m linkpred_tpu_torch.cli twowl                # 10-trial sweep
    python -m linkpred_tpu_torch.cli --seed 3 twowl --epochs 200 --trials 1
    python -m linkpred_tpu_torch.cli --set twowl.epochs=500 --set twowl_trials=3 twowl
    python -m linkpred_tpu_torch.cli twowl --refine 32 --refine-mode adaptive
    python -m linkpred_tpu_torch.cli --profile-dir logs/prof twowl --trials 1
    python -m linkpred_tpu_torch.cli scale --family gcn   # collab-scale GCN
    torchrun --nproc-per-node N -m linkpred_tpu_torch.cli scale --family gcn
    python -m linkpred_tpu_torch.cli scale --family twowl # TwoWL at 50k nodes
    python -m linkpred_tpu_torch.cli scale --family seal  # SEAL at 235k nodes
    python -m linkpred_tpu_torch.cli seal --epochs 50 --hop auto
    python -m linkpred_tpu_torch.cli logistic             # node2vec + logistic
    python -m linkpred_tpu_torch.cli node2vec --input graph.edgelist \
        --output graph.emb
    python -m linkpred_tpu_torch.cli compare              # best record per family
    python -m linkpred_tpu_torch.cli stats --no-plot      # dataset statistics
    python -m linkpred_tpu_torch.cli report --output report.html

The training subcommands run on the CUDA card and refuse to start without
one; `compare`, `stats` and `report` read files and touch no device. Outputs
keep the reference formats (records_auc/, logs.json, fpr.json/tpr.json,
.emb, the report's HTML). A ROC plot is written only where `--roc-png PATH`
asks for one; `compare`, and `stats` without `--no-plot`, draw their charts
with matplotlib.
"""

from __future__ import annotations

import argparse
import os
import sys


def _load_config(args):
    """The configuration tree of a family subcommand: `--seed` in every
    family's config, then `--epochs`, `--trials` and `seal --hop`, then the
    `--set` overrides in their order."""
    import dataclasses

    from linkpred_tpu_torch.config import Config, apply_overrides

    cfg = Config(seed=args.seed)
    cfg = dataclasses.replace(
        cfg,
        logistic=dataclasses.replace(cfg.logistic, seed=args.seed),
        seal=dataclasses.replace(cfg.seal, seed=args.seed),
        twowl=dataclasses.replace(cfg.twowl, seed=args.seed),
    )
    if getattr(args, "epochs", None) is not None:
        if args.cmd == "seal":
            cfg = dataclasses.replace(
                cfg, seal=dataclasses.replace(cfg.seal, epochs=args.epochs)
            )
        elif args.cmd == "twowl":
            cfg = dataclasses.replace(
                cfg, twowl=dataclasses.replace(cfg.twowl, epochs=args.epochs)
            )
    if getattr(args, "trials", None) is not None:
        cfg = dataclasses.replace(cfg, twowl_trials=args.trials)
    if args.cmd == "seal" and getattr(args, "hop", None) is not None:
        hop = args.hop if args.hop == "auto" else int(args.hop)
        cfg = dataclasses.replace(
            cfg, seal=dataclasses.replace(cfg.seal, hop=hop)
        )
    return apply_overrides(cfg, args.set or [])


def _cmd_logistic(args):
    from linkpred_tpu_torch.pipelines.logistic_pipeline import run_logistic
    from linkpred_tpu_torch.utils.device import cuda_device

    cfg = _load_config(args)
    res = run_logistic(cfg.logistic, data_dir=cfg.paths.data_dir,
                       device=cuda_device(), verbose=not args.quiet,
                       roc_png=args.roc_png)
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
    from linkpred_tpu_torch.pipelines.seal_pipeline import run_seal
    from linkpred_tpu_torch.utils.device import cuda_device

    cfg = _load_config(args)
    res = run_seal(cfg.seal, data_dir=cfg.paths.data_dir, device=cuda_device(),
                   verbose=not args.quiet, roc_png=args.roc_png)
    print(f"AUC:{res['auc']:.4f}   Time:{res['train_seconds']:.4f}")


def _cmd_twowl(args):
    from linkpred_tpu_torch.pipelines.twowl_pipeline import run_twowl
    from linkpred_tpu_torch.utils.device import cuda_device

    cfg = _load_config(args)
    res = run_twowl(cfg.twowl, n_trials=cfg.twowl_trials, device=cuda_device(),
                    data_dir=cfg.paths.data_dir, verbose=not args.quiet,
                    refine_trials=args.refine, refine_mode=args.refine_mode,
                    roc_png=args.roc_png)
    print(f"AUC:{res['test_auc']:.4f}   (best of {cfg.twowl_trials} trials)")


def _cmd_compare(args):
    """The best record of each family as a table, and as a bar chart in
    `assets/img/compare_auc.png` (matplotlib)."""
    from linkpred_tpu_torch.utils import records

    rows = []
    for family in ("logistic", "seal", "twowl"):
        best = records.best_record(args.dataset, family, args.records_dir)
        rows.append((family, best))
    print(f"{'family':<10} {'best AUC':>9} {'time (s)':>9}")
    for family, best in rows:
        if best is None:
            print(f"{family:<10} {'—':>9} {'—':>9}")
        else:
            print(f"{family:<10} {best[0]:>9.4f} {best[1]:>9.4f}")
    from linkpred_tpu_torch.utils import plots

    out = plots.plot_family_comparison(
        [r[0] for r in rows],
        [r[1][0] if r[1] else None for r in rows],
        "assets/img/compare_auc.png",
        times=[r[1][1] if r[1] else None for r in rows],
    )
    print(f"wrote {out}")


def _cmd_stats(args):
    """Statistics of the fb-pages-food graph and, without `--no-plot`, a
    drawing of it in `assets/img/graph_viz.png` (matplotlib)."""
    import numpy as np

    from linkpred_tpu_torch.data import io

    g, edges = io.load_fb_pages_food()
    deg = np.asarray(g.degree)
    print(f"nodes:            {g.num_nodes}")
    print(f"undirected edges: {len(edges)}")
    print(f"degree:           min {deg.min()}  mean {deg.mean():.2f}  "
          f"median {np.median(deg):.0f}  max {deg.max()}")
    # connected components via BFS over adjacency sets
    seen = np.zeros(g.num_nodes, dtype=bool)
    comps = 0
    for s in range(g.num_nodes):
        if seen[s]:
            continue
        comps += 1
        stack = [s]
        seen[s] = True
        while stack:
            u = stack.pop()
            for v in g.nbr[u][g.nbr_mask[u]]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(int(v))
    print(f"components:       {comps}")
    density = len(edges) / (g.num_nodes * (g.num_nodes - 1) / 2)
    print(f"density:          {density:.5f}")

    if not args.no_plot:
        import os

        from linkpred_tpu_torch.utils.plots import _plt

        plt = _plt()
        rng = np.random.default_rng(23)  # the reference's layout seed
        pos = rng.random((g.num_nodes, 2))
        # a few rounds of force-free neighbor averaging for a readable layout
        for _ in range(30):
            nb_mean = np.stack(
                [pos[g.nbr[i][g.nbr_mask[i]]].mean(axis=0) if g.degree[i]
                 else pos[i] for i in range(g.num_nodes)]
            )
            pos = 0.6 * pos + 0.4 * nb_mean + rng.normal(0, 0.002, pos.shape)
        fig, ax = plt.subplots(figsize=(8, 8))
        u, v = edges[:, 0], edges[:, 1]
        ax.plot(
            np.stack([pos[u, 0], pos[v, 0]]), np.stack([pos[u, 1], pos[v, 1]]),
            color="gray", linewidth=0.3, alpha=0.5,
        )
        ax.scatter(pos[:, 0], pos[:, 1], s=8, alpha=0.8)
        ax.set_title("fb-pages-food graph")
        ax.axis("off")
        os.makedirs("assets/img", exist_ok=True)
        fig.savefig("assets/img/graph_viz.png", dpi=120)
        plt.close(fig)
        print("wrote assets/img/graph_viz.png")


def _cmd_report(args):
    """One self-contained static HTML file of all results: the best record
    of each family against the reference's published AUC, every family's
    records, the best TwoWL hyperparameters (`logs.json`) and every PNG of
    `assets/img/` inlined as base64. Reads `records_auc/` (or
    `--records-dir`), `logs.json` and `assets/img/` relative to the working
    directory; `--serve PORT` then serves the file over HTTP on
    127.0.0.1."""
    import base64
    import glob
    import html as html_mod
    import json
    import os

    from linkpred_tpu_torch.utils import records

    ref = {"logistic": 0.8075, "seal": 0.8661, "twowl": 0.8947}
    parts = [
        "<!doctype html><meta charset='utf-8'>",
        "<title>linkpred_tpu report</title>",
        "<style>body{font-family:system-ui,sans-serif;max-width:960px;"
        "margin:2em auto;padding:0 1em;color:#1a1a1a}"
        "table{border-collapse:collapse;margin:1em 0}"
        "td,th{border:1px solid #ccc;padding:.35em .8em;text-align:right}"
        "th{background:#f2f2f2}td:first-child,th:first-child{text-align:left}"
        "img{max-width:100%;border:1px solid #eee;margin:.5em 0}"
        "h2{margin-top:1.6em}</style>",
        "<h1>linkpred_tpu — link-prediction report</h1>",
        f"<p>dataset: <b>{html_mod.escape(args.dataset)}</b></p>",
        "<h2>Best per family (vs reference)</h2>",
        "<table><tr><th>family</th><th>best AUC</th><th>time (s)</th>"
        "<th>reference AUC</th><th>Δ</th></tr>",
    ]
    for family in ("logistic", "seal", "twowl"):
        best = records.best_record(args.dataset, family, args.records_dir)
        if best is None:
            parts.append(
                f"<tr><td>{family}</td><td>—</td><td>—</td>"
                f"<td>{ref[family]:.4f}</td><td>—</td></tr>")
        else:
            parts.append(
                f"<tr><td>{family}</td><td>{best[0]:.4f}</td>"
                f"<td>{best[1]:.4f}</td><td>{ref[family]:.4f}</td>"
                f"<td>{best[0] - ref[family]:+.4f}</td></tr>")
    parts.append("</table>")

    for family in ("logistic", "seal", "twowl"):
        recs = records.read_records(args.dataset, family, args.records_dir)
        if not recs:
            continue
        parts.append(f"<h2>{family} records</h2><table>"
                     "<tr><th>#</th><th>AUC</th><th>time (s)</th></tr>")
        for i, (auc, t) in enumerate(recs):
            parts.append(f"<tr><td>{i}</td><td>{auc:.4f}</td>"
                         f"<td>{t:.4f}</td></tr>")
        parts.append("</table>")

    if os.path.exists("logs.json"):
        with open("logs.json") as f:
            best_hp = json.load(f)
        parts.append("<h2>Best TwoWL hyperparameters</h2><table>")
        for k, v in best_hp.items():
            parts.append(f"<tr><td>{html_mod.escape(str(k))}</td>"
                         f"<td>{html_mod.escape(str(v))}</td></tr>")
        parts.append("</table>")

    imgs = sorted(glob.glob("assets/img/*.png"))
    if imgs:
        parts.append("<h2>Artifacts</h2>")
        for p in imgs:
            with open(p, "rb") as f:
                b64 = base64.b64encode(f.read()).decode()
            name = html_mod.escape(os.path.basename(p))
            parts.append(f"<h3>{name}</h3>"
                         f"<img alt='{name}' "
                         f"src='data:image/png;base64,{b64}'>")
    out = args.output
    with open(out, "w") as f:
        f.write("\n".join(parts))
    print(f"wrote {out} ({os.path.getsize(out)} bytes, "
          f"{len(imgs)} inline images)")

    if args.serve:
        # the report is static, so the standard library's server is the
        # whole dashboard
        import functools
        import http.server

        handler = functools.partial(
            http.server.SimpleHTTPRequestHandler,
            directory=os.path.dirname(os.path.abspath(out)) or ".",
        )
        with http.server.ThreadingHTTPServer(("127.0.0.1", args.serve),
                                             handler) as srv:
            print(f"serving http://localhost:{args.serve}/"
                  f"{os.path.basename(out)} (Ctrl-C to stop)")
            try:
                srv.serve_forever()
            except KeyboardInterrupt:
                pass


def _cmd_scale(args):
    """End-to-end training at scale on one card: `--family gcn`
    (`pipelines.gcn_scale`, BASELINE config 5), `--family twowl`
    (`pipelines.twowl_scale`, the capacity-bounded LocalWLNet) or `--family
    seal` (`pipelines.seal_scale`, CSR extraction and the batched DGCNN);
    prints the result as one JSON line."""
    import json

    from linkpred_tpu_torch.parallel import distributed
    from linkpred_tpu_torch.utils.device import cuda_device

    # under torchrun (--family gcn): join the job first, so this rank runs
    # on card LOCAL_RANK and train_collab splits the graph over the ranks;
    # rank 0 alone prints
    lead = True
    if args.family != "gcn" and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        raise SystemExit(f"scale --family {args.family} runs on one card; "
                         "only --family gcn splits over torchrun's ranks")
    joined = args.family == "gcn" and distributed.initialize()
    if joined:
        import torch.distributed as dist

        lead = dist.get_rank() == 0
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
            device=device, verbose=lead and not args.quiet)
    if lead:
        print(json.dumps(res))
    if joined:
        distributed.finish()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="linkpred_tpu_torch", description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument(
        "--profile", action="store_true",
        help="trace the whole command with torch.profiler into logs/profile "
             "(TensorBoard or Perfetto readable; the card's kernels are "
             "recorded whenever a card is visible)",
    )
    p.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="like --profile but into DIR (a separate flag: an optional "
             "argument on --profile itself would swallow the subcommand, "
             "e.g. `--profile scale`)",
    )
    p.add_argument(
        "--set", action="append", metavar="KEY=VALUE",
        help="dotted-path config override, e.g. --set twowl.epochs=500",
    )
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
    pt.add_argument("--trials", type=int, default=None,
                    help="trials of the search (default: the config's "
                         "twowl_trials, 10)")
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
    pc = sub.add_parser("compare", help="compare best records per family")
    pc.add_argument("--dataset", default="fb-pages-food")
    pc.add_argument("--records-dir", default="records_auc")

    pst = sub.add_parser("stats", help="dataset statistics + graph viz")
    pst.add_argument("--no-plot", action="store_true")

    pr = sub.add_parser(
        "report", help="self-contained static HTML report of all results"
    )
    pr.add_argument("--dataset", default="fb-pages-food")
    pr.add_argument("--records-dir", default="records_auc")
    pr.add_argument("--output", default="report.html")
    pr.add_argument("--serve", type=int, default=0, metavar="PORT",
                    help="after writing, serve the report over HTTP")

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
    cmd = {
        "logistic": _cmd_logistic,
        "seal": _cmd_seal,
        "twowl": _cmd_twowl,
        "compare": _cmd_compare,
        "stats": _cmd_stats,
        "report": _cmd_report,
        "scale": _cmd_scale,
        "node2vec": _cmd_node2vec,
    }[args.cmd]
    profile_dir = args.profile_dir or ("logs/profile" if args.profile else None)
    if profile_dir:
        from linkpred_tpu_torch.utils.profiling import device_trace

        with device_trace(profile_dir):
            cmd(args)
        print(f"wrote device trace to {profile_dir}")
    else:
        cmd(args)


if __name__ == "__main__":
    sys.exit(main())
