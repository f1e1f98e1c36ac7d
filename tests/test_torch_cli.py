"""The port's user surface against the JAX package's: `compare`, `stats
--no-plot` and `report` print the same bytes from the same inputs (and
`report` writes the same HTML), the record readers agree, the global
`--set`, `--profile` and `--profile-dir` flags reach the commands, and
`twowl --trials` falls back to the config's `twowl_trials`. The training
commands run here on the CPU, with the card replaced."""

import json
import os
import shutil

import pytest
import torch

from linkpred_tpu import cli as jcli
from linkpred_tpu.utils import records as jrecords
from linkpred_tpu_torch import cli
from linkpred_tpu_torch.utils import records as trecords
from linkpred_tpu_torch.utils.profiling import device_trace

# the suite runs several worker processes at once: one compute thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("logistic", "seal", "twowl")


def _results_dir(path):
    """A working directory holding copies of the committed results:
    `records_auc/`, `logs.json` and `assets/img/`."""
    path.mkdir()
    shutil.copytree(os.path.join(REPO, "records_auc"), path / "records_auc")
    shutil.copytree(os.path.join(REPO, "assets", "img"),
                    path / "assets" / "img")
    shutil.copy(os.path.join(REPO, "logs.json"), path / "logs.json")
    return path


def _run(main, argv, cwd, monkeypatch, capsys):
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


HOST_COMMANDS = {
    "compare": ["compare"],
    "stats": ["stats", "--no-plot"],
    "report": ["report", "--output", "out.html"],
    "report records-dir": ["report", "--records-dir", "elsewhere",
                           "--output", "out.html"],
    "compare dataset": ["compare", "--dataset", "other"],
}


@pytest.mark.parametrize("argv", HOST_COMMANDS.values(), ids=HOST_COMMANDS)
def test_host_commands_print_the_same_bytes(argv, tmp_path, monkeypatch,
                                            capsys):
    """Each CLI runs in its own copy of the committed results; stdout and
    every file written (the report's HTML) are byte-equal. The chart that
    `compare` draws is held only to exist: matplotlib's bytes are not part
    of the contract."""
    out = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        cwd = _results_dir(tmp_path / name)
        out[name] = _run(main, argv, cwd, monkeypatch, capsys)
    assert out["port"] == out["jax"]
    assert out["port"].strip()
    if argv[0] == "report":
        html = (tmp_path / "port" / "out.html").read_bytes()
        assert html == (tmp_path / "jax" / "out.html").read_bytes()
        assert b"<title>linkpred_tpu report</title>" in html
        if "--records-dir" not in argv:
            assert all(f"<h2>{f} records</h2>".encode() in html
                       for f in FAMILIES)
    if argv[0] == "compare":
        png = tmp_path / "port" / "assets" / "img" / "compare_auc.png"
        assert png.stat().st_size > 0
        assert "wrote assets/img/compare_auc.png" in out["port"]


@pytest.mark.parametrize("where", ["committed", "empty", "missing"])
def test_record_readers_match_jax(where, tmp_path):
    records_dir = {"committed": os.path.join(REPO, "records_auc"),
                   "empty": str(tmp_path),
                   "missing": str(tmp_path / "nowhere")}[where]
    for family in (*FAMILIES, "gcn"):
        got = trecords.read_records("fb-pages-food", family, records_dir)
        assert got == jrecords.read_records("fb-pages-food", family,
                                            records_dir)
        assert trecords.best_record("fb-pages-food", family, records_dir) == \
            jrecords.best_record("fb-pages-food", family, records_dir)
        assert bool(got) == (where == "committed" and family != "gcn")


def test_record_written_is_read_back(tmp_path):
    trecords.write_record("d", "twowl", 0.123456, 7.0, str(tmp_path))
    trecords.write_record("d", "twowl", 0.9, 1.25, str(tmp_path))
    assert trecords.read_records("d", "twowl", str(tmp_path)) == [
        (0.1235, 7.0), (0.9, 1.25)]
    assert trecords.best_record("d", "twowl", str(tmp_path)) == (0.9, 1.25)


def test_parser_matches_jax():
    """Every subcommand and flag of the JAX CLI parses here to the same
    values, `twowl --trials` included (None: the config's twowl_trials)."""
    cases = [
        ["--seed", "3", "--quiet", "--set", "a=1", "--set", "b.c=2", "twowl"],
        ["--profile", "twowl", "--epochs", "7", "--trials", "2"],
        ["--profile-dir", "d", "seal", "--epochs", "5", "--hop", "1"],
        ["logistic"],
        ["compare", "--dataset", "x", "--records-dir", "r"],
        ["stats", "--no-plot"],
        ["report", "--output", "o.html", "--serve", "8000"],
        ["twowl", "--refine", "8", "--refine-mode", "halving"],
    ]
    for argv in cases:
        got = vars(cli.build_parser().parse_args(argv))
        want = vars(jcli.build_parser().parse_args(argv))
        got.pop("roc_png", None)  # the port's plot flag, a known deviation
        assert got == want, argv
    assert cli.build_parser().parse_args(["twowl"]).trials is None


@pytest.fixture
def on_cpu(monkeypatch, tmp_path):
    """The card replaced by the CPU, and a working directory for outputs."""
    from linkpred_tpu_torch.utils import device

    monkeypatch.setattr(device, "cuda_device", lambda: torch.device("cpu"))
    return tmp_path


def _record_lines(cwd):
    path = cwd / "records_auc" / "fb-pages-food_auc_record_twowl.txt"
    return path.read_text().splitlines()


def test_twowl_takes_trials_and_epochs_from_the_config(on_cpu, monkeypatch,
                                                       capsys):
    """`--set twowl_trials=N` and `--set twowl.epochs=E` reach `run_twowl`,
    and so do `--trials` and `--seed`; without `--trials` the config
    decides."""
    from linkpred_tpu_torch.pipelines import twowl_pipeline as tp

    seen = []
    real = tp.run_twowl

    def spy(run, n_trials, **kw):
        seen.append((run.epochs, run.seed, n_trials))
        return real(run, n_trials, **kw)

    monkeypatch.setattr(tp, "run_twowl", spy)
    for name, argv, trials in (
            ("one", ["--set", "twowl.epochs=2", "--set", "twowl_trials=1",
                     "twowl"], 1),
            ("two", ["--seed", "4", "--set", "twowl.epochs=2", "--set",
                     "twowl_trials=2", "twowl"], 2),
            ("flag", ["twowl", "--epochs", "2", "--trials", "1"], 1)):
        cwd = on_cpu / name
        cwd.mkdir()
        out = _run(cli.main, ["--quiet", *argv], cwd, monkeypatch, capsys)
        assert len(_record_lines(cwd)) == trials
        last = out.strip().splitlines()[-1]
        assert last.startswith("AUC:") and last.endswith(
            f"(best of {trials} trials)"), last
    assert seen == [(2, 0, 1), (2, 4, 2), (2, 0, 1)]


LOAD_CONFIG = {
    "defaults": ["twowl"],
    "seed everywhere": ["--seed", "5", "logistic"],
    "twowl epochs and trials": ["twowl", "--epochs", "7", "--trials", "3"],
    "seal epochs and hop": ["seal", "--epochs", "4", "--hop", "2"],
    "seal hop auto": ["seal", "--hop", "auto"],
    "set after flags": ["--set", "twowl_trials=5", "--set", "twowl.epochs=9",
                        "twowl", "--trials", "1", "--epochs", "2"],
    "set seed only top level": ["--set", "seed=8", "seal"],
    "set paths": ["--set", "paths.data_dir=somewhere", "logistic"],
}


@pytest.mark.parametrize("argv", LOAD_CONFIG.values(), ids=LOAD_CONFIG)
def test_load_config_matches_jax(argv):
    """The same tree, field for field, but the unported
    `twowl.chunk_epochs`: the seed first, then `--epochs`, `--trials` and
    `seal --hop`, then the overrides (which win)."""
    import dataclasses

    def flat(node):
        return {f.name: flat(getattr(node, f.name))
                if dataclasses.is_dataclass(getattr(node, f.name))
                else getattr(node, f.name) for f in dataclasses.fields(node)}

    got = flat(cli._load_config(cli.build_parser().parse_args(argv)))
    want = flat(jcli._load_config(jcli.build_parser().parse_args(argv)))
    want["twowl"].pop("chunk_epochs")
    assert got == want


def test_unported_chunk_epochs_is_refused(on_cpu, monkeypatch):
    monkeypatch.chdir(on_cpu)
    with pytest.raises(ValueError, match="unknown config field"):
        cli.main(["--set", "twowl.chunk_epochs=16", "twowl"])
    assert list(on_cpu.iterdir()) == []


def test_family_commands_pass_the_config(on_cpu, monkeypatch, capsys):
    """`logistic` and `seal` build their configs from `_load_config` and
    pass `paths.data_dir` and `--roc-png` through."""
    from linkpred_tpu_torch.pipelines import logistic_pipeline as lp
    from linkpred_tpu_torch.pipelines import seal_pipeline as sp

    calls = {}

    def fake(name, key):
        def run(cfg, data_dir=None, **kw):
            calls[name] = (cfg, data_dir, kw)
            return {key: 0.5, "auc": 0.75}
        return run

    monkeypatch.setattr(lp, "run_logistic", fake("logistic", "fit_seconds"))
    monkeypatch.setattr(sp, "run_seal", fake("seal", "train_seconds"))
    _run(cli.main, ["--seed", "9", "--set", "paths.data_dir=dd", "--set",
                    "logistic.num_walks=3", "logistic", "--roc-png", "l.png"],
         on_cpu, monkeypatch, capsys)
    _run(cli.main, ["--set", "seal.batch_size=8", "seal", "--epochs", "2",
                    "--hop", "1", "--roc-png", "s.png"], on_cpu, monkeypatch,
         capsys)
    cfg, data_dir, kw = calls["logistic"]
    assert (cfg.seed, cfg.num_walks, data_dir, kw["roc_png"]) == (
        9, 3, "dd", "l.png")
    cfg, data_dir, kw = calls["seal"]
    assert (cfg.seed, cfg.epochs, cfg.hop, cfg.batch_size, data_dir,
            kw["roc_png"]) == (0, 2, 1, 8, None, "s.png")
    assert kw["device"] == torch.device("cpu")


def _trace_events(log_dir):
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1, files
    with open(os.path.join(log_dir, files[0])) as f:
        return json.load(f)["traceEvents"]


def test_profile_dir_traces_a_host_command(tmp_path, monkeypatch, capsys):
    cwd = _results_dir(tmp_path / "run")
    monkeypatch.chdir(cwd)
    cli.main(["--profile-dir", "prof", "stats", "--no-plot"])
    captured = capsys.readouterr()
    assert captured.out.strip().splitlines()[-1] == \
        "wrote device trace to prof"
    assert "host activity only" in captured.err  # no card here
    assert _trace_events(cwd / "prof")
    cli.main(["--profile", "compare"])
    assert _trace_events(cwd / "logs" / "profile")


def test_device_trace_host_only(tmp_path, capsys):
    """`cuda=False` records the host alone, without a word on stderr."""
    with device_trace(str(tmp_path / "cpu"), cuda=False):
        torch.ones(64).cumsum(0)
    events = _trace_events(tmp_path / "cpu")
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not any(e.get("cat") == "kernel" for e in events)
    assert capsys.readouterr().err == ""


def test_report_serves_the_file(tmp_path, monkeypatch, capsys):
    """`--serve` starts the standard library's server on 127.0.0.1 over the
    report's directory (stopped here at once by a KeyboardInterrupt)."""
    import http.server

    cwd = _results_dir(tmp_path / "run")
    served = {}

    def serve_forever(self):
        served["address"] = self.server_address
        served["dir"] = self.RequestHandlerClass.keywords["directory"]
        raise KeyboardInterrupt

    monkeypatch.setattr(http.server.ThreadingHTTPServer, "serve_forever",
                        serve_forever)
    out = _run(cli.main, ["report", "--output", "r.html", "--serve", "0"],
               cwd, monkeypatch, capsys)
    assert not served  # port 0: no server
    out = _run(cli.main, ["report", "--output", "r.html", "--serve", "18765"],
               cwd, monkeypatch, capsys)
    assert served == {"address": ("127.0.0.1", 18765), "dir": str(cwd)}
    assert "serving http://localhost:18765/r.html" in out
    assert os.path.getsize(cwd / "r.html") == int(out.split("(")[1].split()[0])
