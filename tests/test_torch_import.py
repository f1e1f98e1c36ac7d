"""The port runs without JAX, and never falls back to the CPU when it was
asked for the card."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import linkpred_tpu_torch
    from linkpred_tpu_torch.data import io
    from linkpred_tpu_torch.data.twowl import build_twowl_data
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.pipelines import twowl_pipeline as tp

    _, edges = io.load_fb_pages_food()
    data = build_twowl_data(edges, int(edges.max()) + 1,
                            rng=np.random.default_rng(0))
    cfg = m.TwoWLConfig(max_degree=data.max_degree, agg_1wl="ell")
    res = tp.train_routine_fused(data, cfg, tp.TwoWLRunConfig(epochs=2), "cpu")
    assert np.isfinite(res["loss_history"]).all(), res["loss_history"]
    assert 0.0 <= res["test_auc"] <= 1.0
    assert_port_stands_alone()
    print("JAX-FREE OK")
""")


# the GCN slice: its host modules are the port's own copies too
_GCN_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    from linkpred_tpu_torch.pipelines import gcn_scale as gs

    cfg = gs.ScaleGCNConfig(nodes=600, edges=2400, steps=4, batch_edges=64,
                            emb_dim=8, hidden=16, max_degree=16)
    res = gs.train_collab(cfg, device="cpu", verbose=False)
    assert np.isfinite(res["loss_first_quarter"]), res
    assert 0.0 <= res["test_auc"] <= 1.0
    assert "linkpred_tpu_torch.data.synth" in sys.modules
    assert_port_stands_alone()
    print("JAX-FREE OK")
""")


# the logistic family (walks, SGNS, Newton fit) and TwoWL at scale, whose
# seeding runs the same walks and SGNS; checkpoint, plots and progress too
_LOGISTIC_SCRIPT = textwrap.dedent("""
    import os
    import sys
    import tempfile
    import numpy as np
    from linkpred_tpu_torch.models.word2vec import SGNSConfig
    from linkpred_tpu_torch.pipelines import logistic_pipeline as lp
    from linkpred_tpu_torch.utils import checkpoint, plots

    with tempfile.TemporaryDirectory() as tmp:
        cfg = lp.LogisticConfig(
            num_walks=4, walk_length=8, records_dir=os.path.join(tmp, "rec"),
            embed=SGNSConfig(dim=16, window=4, epochs=1))
        res = lp.run_logistic(cfg, device="cpu", verbose=False,
                              metrics_file=os.path.join(tmp, "m.jsonl"))
    assert 0.0 <= res["auc"] <= 1.0
    assert "linkpred_tpu_torch.native" in sys.modules
    assert "matplotlib" not in sys.modules  # no plot was asked for
    assert_port_stands_alone()
    print("JAX-FREE OK")
""")

_TWOWL_SCALE_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    from linkpred_tpu_torch.pipelines import twowl_scale as ts

    res = ts.run_twowl_scale(
        ts.ScaleTwoWLConfig(nodes=600, edges=2400, epochs=4, max_degree=12,
                            ei2_cap_per_node=32, n2v_walks_per_node=2,
                            n2v_epochs=1),
        device="cpu", verbose=True)
    assert np.isfinite(res["loss_last_quarter"]), res
    assert "linkpred_tpu_torch.utils.progress" in sys.modules
    assert_port_stands_alone()
    print("JAX-FREE OK")
""")


# SEAL: the subgraph data (C++ plane and the numpy loop), the DGCNN, both
# pipelines and the rest of the ops
_SEAL_SCRIPT = textwrap.dedent("""
    import os
    import sys
    import tempfile
    import numpy as np
    import torch
    from linkpred_tpu_torch import native
    from linkpred_tpu_torch.data import subgraph as sg
    from linkpred_tpu_torch.ops import segment, spmm
    from linkpred_tpu_torch.pipelines import seal_pipeline as sp
    from linkpred_tpu_torch.pipelines import seal_scale as ss

    with tempfile.TemporaryDirectory() as tmp:
        cfg = sp.SEALConfig(epochs=1, hop=1, max_neighbors=20, dimension=8,
                            records_dir=os.path.join(tmp, "rec"))
        res = sp.run_seal(cfg, device="cpu", verbose=False, roc_png=None,
                          metrics_file=os.path.join(tmp, "m.jsonl"),
                          checkpoint_prefix=os.path.join(tmp, "ck", "model"))
        restored = sp.restore_seal_params(
            res["params"].gw[0].shape[0], res["threshold_k"],
            os.path.join(tmp, "ck", "model-1000.npz"), device="cpu")
    assert 0.0 <= res["auc"] <= 1.0
    out = ss.run_seal_scale(ss.ScaleSEALConfig(
        nodes=1500, edges=6000, target_pairs=64, epochs=1, max_neighbors=20),
        device="cpu", verbose=False)
    assert np.isfinite(out["loss_first_quarter"]), out
    native.available = lambda: False  # the numpy loop and the torch BFS
    b = sg.build_subgraph_batch_csr(np.array([[0, 1], [2, 3]]),
                                    np.array([0, 1, 2, 3, 4]),
                                    np.array([1, 0, 3, 2]), 4, 2, 5,
                                    device="cpu")
    assert b.tags.shape == (2, 5)
    x = torch.ones(4, 3)
    src, dst = torch.tensor([0, 1, 2]), torch.tensor([1, 2, 3])
    assert spmm.gcn_aggregate(src, dst, x, 4).shape == (4, 3)
    assert segment.segment_max(x, dst.repeat(2)[:4], 4).shape == (4, 3)
    assert "linkpred_tpu_torch.models.seal" in sys.modules
    assert_port_stands_alone()
    print("JAX-FREE OK")
""")


# the user surface: the config tree, the entry point and the host-only
# subcommands (run in a copy of the committed results)
# the multi-GPU stack: a 2-rank gloo job of the halo SpMM and of the TwoWL
# step with the ei2 slots split over the ranks (the rank bodies of
# tests/torch_ranks.py); the parent and each rank check their modules
_PARALLEL_SCRIPT = textwrap.dedent("""
    import dataclasses
    import sys
    import tempfile
    import numpy as np
    import torch
    sys.path.insert(0, "tests")
    import torch_ranks
    from linkpred_tpu_torch.data.graph import Graph
    from linkpred_tpu_torch.data.twowl import build_twowl_data
    from linkpred_tpu_torch.models import twowl as m
    from linkpred_tpu_torch.parallel import multihost
    from linkpred_tpu_torch.parallel.halo import HaloLayout

    def job(rank, world, layouts, x, t, twowl_args):
        torch_ranks.halo_ops(rank, world, layouts, x, t)
        torch_ranks.twowl_sgd_step(rank, world, *twowl_args)
        return torch_ranks.jax_modules()

    if __name__ == "__main__":
        rng = np.random.default_rng(0)
        lo, hi = rng.integers(0, 60, 240), rng.integers(0, 60, 240)
        g = Graph.from_undirected_edges(lo[lo != hi], hi[lo != hi],
                                        num_nodes=60)
        g = dataclasses.replace(g, nbr_weight=np.ones_like(g.nbr_mask,
                                                           np.float32))
        x = rng.standard_normal((60, 4)).astype(np.float32)
        pairs = np.stack([rng.integers(0, 20, 60), rng.integers(0, 20, 60)], 1)
        d = build_twowl_data(pairs[pairs[:, 0] != pairs[:, 1]], 20, rng=rng,
                             ei2_bucket=32)
        cfg = m.TwoWLConfig(max_degree=d.max_degree, channels_1wl=8,
                            channels_2wl=8, agg_1wl="ell")
        params = m.tree_map(lambda t: t.detach().numpy(), m.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        twowl_args = (d.train, cfg, params, np.arange(3), np.arange(3),
                      d.num_nodes)
        layouts = {"halo": (HaloLayout.build(g, 2), None)}
        got = multihost.launch(job, 2, tempfile.mkdtemp(),
                               args=(layouts, x, x, twowl_args))
        assert got == [[], []], got
        assert_port_stands_alone()
        print("JAX-FREE OK")
""")


# the distributed node2vec: a 2-rank gloo job of each module, SGNS and the
# walks (the rank bodies of tests/torch_ranks.py)
_N2V_SCRIPTS = {
    "sgns": """
        from linkpred_tpu_torch.models.word2vec import SGNSConfig
        from linkpred_tpu_torch.parallel import sgns

        def job(rank, world, walks):
            cfg = SGNSConfig(dim=8, window=3, epochs=1, batch_size=128,
                             neg_pool=16)
            out = torch_ranks.sgns_mesh_job(rank, world,
                                            {"t": (0, walks, 30, cfg)})
            return out["t"].shape, out["jax_modules"]

        def check(walks):
            cfg = SGNSConfig(dim=8, window=3, epochs=1, batch_size=128,
                             neg_pool=16)
            ref = sgns.train_sgns_mesh_reference(0, walks, 30, cfg, 2,
                                                 device="cpu")
            return ref.shape, []
    """,
    "walks": """
        from linkpred_tpu_torch.data.graph import Graph
        from linkpred_tpu_torch.parallel.walks import TableShardedWalker

        def graph():
            rng = np.random.default_rng(0)
            lo, hi = rng.integers(0, 30, 90), rng.integers(0, 30, 90)
            return Graph.from_undirected_edges(lo[lo != hi], hi[lo != hi],
                                               num_nodes=30)

        def job(rank, world, walks):
            layout = TableShardedWalker.build(graph(), world)
            out = torch_ranks.walks_mesh_job(rank, world, {"t": (
                "routed", (layout, (world,), ("edge",), 0, 2, 5, None))})
            return out["t"][0].shape, out["jax_modules"]

        def check(walks):
            return (60, 5), []
    """,
}

_N2V_PRELUDE = textwrap.dedent("""
    import sys
    import tempfile
    import numpy as np
    sys.path.insert(0, "tests")
    import torch_ranks
    from linkpred_tpu_torch.parallel import multihost
""")

_N2V_MAIN = textwrap.dedent("""
    if __name__ == "__main__":
        walks = np.random.default_rng(1).integers(0, 30, (16, 6),
                                                  dtype=np.int32)
        got = multihost.launch(job, 2, tempfile.mkdtemp(), args=(walks,))
        assert got == [check(walks)] * 2, got
        assert_port_stands_alone()
        print("JAX-FREE OK")
""")


_SURFACE_SCRIPTS = {
    "config": """
        from linkpred_tpu_torch import config
        cfg = config.apply_overrides(config.Config(),
                                     ["twowl.epochs=3", "seal.hop=2"])
        assert (cfg.twowl.epochs, cfg.seal.hop) == (3, 2)
    """,
    "graft_entry": """
        from linkpred_tpu_torch.graft_entry import entry
        fn, args = entry(device="cpu", agg_1wl="ell")
        assert fn(*args).shape == (12,)
    """,
    "compare": """
        run_cli(["compare"])
        assert os.path.getsize("assets/img/compare_auc.png") > 0
    """,
    "stats": """
        assert "components:" in run_cli(["stats", "--no-plot"])
        assert "matplotlib" not in sys.modules
    """,
    "report": """
        run_cli(["report", "--output", "r.html"])
        assert os.path.getsize("r.html") > 0
        assert "matplotlib" not in sys.modules
    """,
}

_SURFACE_PRELUDE = textwrap.dedent("""
    import atexit
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    def run_cli(argv):
        from linkpred_tpu_torch import cli
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        assert out.getvalue().strip(), argv
        return out.getvalue()

    _tmp = tempfile.mkdtemp()
    atexit.register(shutil.rmtree, _tmp)
    for _d in ("records_auc", os.path.join("assets", "img")):
        shutil.copytree(_d, os.path.join(_tmp, _d))
    shutil.copy("logs.json", _tmp)
    os.chdir(_tmp)
""")


# no module of the JAX package, of its entry point, of the earlier
# benchmarks, of jax or of optax may be loaded by a run of the port
_PRELUDE = textwrap.dedent("""
    import sys

    def assert_port_stands_alone():
        foreign = sorted(
            name for name in sys.modules
            if name.split(".")[0] in ("linkpred_tpu", "benchmarks", "jax",
                                      "jaxlib", "optax", "__graft_entry__"))
        assert not foreign, foreign
""")


def _run_without_jax(script):
    script = _PRELUDE + script
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # several worker processes run at once
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX-FREE OK" in proc.stdout


def test_port_runs_without_jax():
    _run_without_jax(_SCRIPT)


def test_gcn_slice_runs_without_jax():
    _run_without_jax(_GCN_SCRIPT)


def test_logistic_runs_without_jax():
    _run_without_jax(_LOGISTIC_SCRIPT)


def test_twowl_scale_runs_without_jax():
    _run_without_jax(_TWOWL_SCALE_SCRIPT)


def test_seal_runs_without_jax():
    _run_without_jax(_SEAL_SCRIPT)


def test_parallel_ranks_run_without_jax(tmp_path):
    """The script runs from a file: spawned ranks import the main module
    by its path to find the function they run."""
    path = tmp_path / "parallel_job.py"
    path.write_text(_PRELUDE + _PARALLEL_SCRIPT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, str(path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX-FREE OK" in proc.stdout


@pytest.mark.parametrize("name", sorted(_N2V_SCRIPTS))
def test_distributed_node2vec_runs_without_jax(name, tmp_path):
    """`parallel.sgns` and `parallel.walks` over 2 gloo ranks, from a file
    (as the parallel job above); the parent and each rank check their
    modules."""
    path = tmp_path / f"{name}_job.py"
    path.write_text(_PRELUDE + _N2V_PRELUDE
                    + textwrap.dedent(_N2V_SCRIPTS[name]) + _N2V_MAIN)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, str(path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX-FREE OK" in proc.stdout


@pytest.mark.parametrize("name", sorted(_SURFACE_SCRIPTS))
def test_surface_runs_without_jax(name):
    _run_without_jax(_SURFACE_PRELUDE
                     + textwrap.dedent(_SURFACE_SCRIPTS[name])
                     + "assert_port_stands_alone()\nprint('JAX-FREE OK')\n")


def test_no_card_raises(monkeypatch, tmp_path):
    """Without CUDA, `cuda_device()` and the CLI raise before any work: no
    silent run on the CPU, no file written."""
    from linkpred_tpu_torch import cli
    from linkpred_tpu_torch.pipelines.gcn_scale import (ScaleGCNConfig,
                                                        train_collab)
    from linkpred_tpu_torch.pipelines.seal_pipeline import SEALConfig, run_seal
    from linkpred_tpu_torch.pipelines.seal_scale import (ScaleSEALConfig,
                                                         run_seal_scale)
    from linkpred_tpu_torch.pipelines.twowl_scale import (ScaleTwoWLConfig,
                                                          run_twowl_scale)
    from linkpred_tpu_torch.utils.device import cuda_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--quiet", "twowl", "--epochs", "1", "--trials", "1"])
    for argv in (["scale", "--family", "gcn", "--steps", "1"],
                 ["scale", "--family", "twowl", "--steps", "1"],
                 ["scale", "--family", "seal"],
                 ["seal", "--epochs", "1"],
                 ["logistic"],
                 ["node2vec", "--input", os.path.join(
                     REPO, "raw_data", "fb-pages-food", "fb-pages-food.edges"),
                  "--output", "x.emb"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--quiet", *argv])
    for fn in (lambda: run_twowl_scale(ScaleTwoWLConfig(nodes=300, edges=900)),
               lambda: train_collab(ScaleGCNConfig(nodes=300, edges=900)),
               lambda: run_seal(SEALConfig(epochs=1), roc_png=None),
               lambda: run_seal_scale(ScaleSEALConfig(nodes=300, edges=900))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert list(tmp_path.iterdir()) == []


def test_kernel_turns_needs_a_card_and_loads_no_jax():
    """`kernel_turns.py` imports nothing of JAX or the JAX package, refuses
    to run without a card before it prints a measurement, and calls
    `compare` without `--other` an argument error."""
    _run_without_jax(textwrap.dedent("""
        import torch
        torch.cuda.is_available = lambda: False
        import kernel_turns
        assert_port_stands_alone()
        for argv, expect in ((["--groups", "check"], "no CUDA device"),
                             (["--groups", "compare"], 2)):
            sys.argv = ["kernel_turns.py", *argv]
            try:
                kernel_turns.main()
            except SystemExit as e:
                assert e.code == expect or expect in str(e.code), e.code
            else:
                raise AssertionError(argv)
        print('JAX-FREE OK')
    """))


def test_distributed_node2vec_defaults_to_the_card(monkeypatch):
    """Without a card, the SGNS replay and a mesh of the default device type
    refuse to run rather than fall back to the CPU."""
    from linkpred_tpu_torch.models.word2vec import SGNSConfig
    from linkpred_tpu_torch.parallel import mesh
    from linkpred_tpu_torch.parallel.sgns import train_sgns_mesh_reference

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_sgns_mesh_reference(0, np.zeros((8, 4), np.int32), 10,
                                  SGNSConfig(dim=8, neg_pool=8), 2)

    class CudaMesh:
        device_type = "cuda"

    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.mesh_device(CudaMesh())


@pytest.mark.parametrize("family,error,match", [
    ("seal", RuntimeError, "no CUDA device"),
    ("twowl", RuntimeError, "no CUDA device")], ids=["seal", "twowl"])
def test_scale_families_of_later_slices_raise(family, error, match, tmp_path,
                                              monkeypatch):
    """`--family seal` and `--family twowl`, the families of later slices,
    are ported and so, here without a card, refuse to start."""
    from linkpred_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error, match=match):
        cli.main(["scale", "--family", family])
    assert list(tmp_path.iterdir()) == []
