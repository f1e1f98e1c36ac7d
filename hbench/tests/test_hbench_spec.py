"""`BENCHMARK.json` and the files it names: the contract's shapes, names and
cross references, and a cell added by files alone."""

import json
import re
import shutil

import pytest

from hbench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CHECK_BUDGET_S = 43200


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "hbench/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (harness.ROOT / p).is_dir()
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= CHECK_BUDGET_S


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and line(entry["why"])
    assert line(entry["source"]) and entry["source"].startswith("https://")
    assert entry["file"].startswith("hbench/")
    with open(harness.ROOT / entry["file"]) as f:
        config = json.load(f)
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank")) and key != "hidden"
    harness.driver(config)  # its driver imports


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_workloads_name_their_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and line(cell["why"])
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    for kind, name in (("traffic", cell["traffic"]),
                       ("limits", cell["name"])):
        harness.load_data(kind, name)
    limits = harness.load_data("limits", cell["name"])
    assert limits and all(v >= 0 for v in limits.values())


def test_names_unique_and_characters():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_metrics_shape():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_cell_reports_what_it_must():
    e2e = SPEC["end_to_end"]
    for cell in SPEC["workloads"]:
        name = cell["name"]
        mine = {m["name"] for m in harness.reported(e2e, name)}
        assert "setup_s" in mine and len(mine) >= 2, name
        assert harness.reported(SPEC["per_layer"], name), name
    for m in SPEC["per_layer"]:
        for name in m["workloads"]:
            harness.workload(SPEC, name)
            reported = {x["name"] for x in harness.reported(e2e, name)}
            assert m["moves"] in reported, (m["name"], name)


def test_layers_spelled_alike():
    prefixes = {}
    for m in SPEC["per_layer"]:
        prefixes.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in prefixes.values())


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(harness.reader(metric["name"]).read)


def test_four_chip_cells_within_a_quarter():
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)


def test_a_cell_added_by_files_alone_is_listed_and_runs(tmp_path, monkeypatch,
                                                       cpu):
    """A throwaway cell of two trials trained trial-major (the driver's
    sweep loop): a traffic file, a limits file, a workload entry and its
    rate's entry (no edit to any file of the harness): the harness lists
    it, finds its metrics and runs it."""
    base = tmp_path / "hbench"
    for kind in ("configs", "traffic", "limits", "metrics", "data"):
        shutil.copytree(harness.HB / kind, base / kind)
    (base / "traffic" / "tiny2.json").write_text(json.dumps(
        {"loop": "trials", "trials": 2, "lr_grid": [0.01],
         "dropout_grid": [0.1], "schedule_epochs": 8, "chunk_epochs": 2}))
    (base / "limits" / "twowl-fbpages.tiny2.json").write_text(
        (base / "limits" / "twowl-fbpages.trial1.json").read_text())
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "twowl-fbpages.tiny2",
                              "config": "twowl-fbpages", "traffic": "tiny2",
                              "chips": 1, "why": "a throwaway cell"})
    spec["end_to_end"].append(
        {"name": "trial_epochs_per_s", "unit": "trial-epochs/s",
         "better": "higher", "bound": 0.25, "source": "host_clock",
         "workloads": ["twowl-fbpages.tiny2"]})
    monkeypatch.setattr(harness, "HB", base)
    assert harness.workload(spec, "twowl-fbpages.tiny2")["traffic"] == "tiny2"
    assert {m["name"] for m in harness.reported(
        spec["end_to_end"], "twowl-fbpages.tiny2")} == {
        "setup_s", "trial_epochs_per_s", "peak_mem_gib"}
    out = harness.run_cell("twowl-fbpages.tiny2", 3, 0.2, False, cpu, 0.0,
                           spec)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "trial_epochs_per_s",
                                   "peak_mem_gib"}


def test_a_configuration_added_by_files_alone_is_listed_and_runs(
        tmp_path, monkeypatch, cpu):
    """A second configuration and a cell on it, as new files in a copy of
    `hbench/` (its configuration, traffic, limits and small size) and new
    entries in a copy of the spec (the configuration, the cell, and the
    cell appended to `epochs_per_s`'s and `host_ms.epochs`'s lists): the
    harness lists the cell and its metrics, the check tests find its small
    size and its control, and it runs correct on the CPU."""
    base = tmp_path / "hbench"
    shutil.copytree(harness.HB, base,
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    config = json.loads((base / "configs" / "twowl-fbpages.json").read_text())
    config["name"] = "twowl-copy"
    (base / "configs" / "twowl-copy.json").write_text(json.dumps(config))
    (base / "traffic" / "short.json").write_text(json.dumps(
        {"loop": "single", "schedule_epochs": 40, "chunk_epochs": 4}))
    (base / "limits" / "twowl-copy.short.json").write_text(
        (base / "limits" / "twowl-fbpages.trial1.json").read_text())
    (base / "small" / "twowl-copy.short.json").write_text(json.dumps(
        {"config": {}, "traffic": {"schedule_epochs": 12}}))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(
        {"name": "twowl-copy", "source": "https://arxiv.org/abs/2206.09567",
         "file": "hbench/configs/twowl-copy.json", "reduced": [],
         "why": "a throwaway configuration"})
    spec["workloads"].append({"name": "twowl-copy.short",
                              "config": "twowl-copy", "traffic": "short",
                              "chips": 1, "why": "a throwaway cell"})
    for group, metric in (("end_to_end", "epochs_per_s"),
                          ("per_layer", "host_ms.epochs")):
        entry = next(m for m in spec[group] if m["name"] == metric)
        entry["workloads"].append("twowl-copy.short")
    monkeypatch.setattr(harness, "HB", base)

    assert "twowl-copy.short" in [w["name"] for w in spec["workloads"]]
    assert harness.workload(spec, "twowl-copy.short")["config"] == \
        "twowl-copy"
    assert {m["name"] for m in harness.reported(
        spec["end_to_end"], "twowl-copy.short")} == {
        "setup_s", "epochs_per_s", "peak_mem_gib"}
    assert {m["name"] for m in harness.reported(
        spec["per_layer"], "twowl-copy.short")} == {"host_ms.epochs"}
    small_config, small_traffic = harness.small("twowl-copy.short")
    assert small_traffic == {"schedule_epochs": 12}
    loaded = harness.load_data("configs", "twowl-copy")
    assert loaded["name"] == "twowl-copy"
    assert harness.control_precision(loaded) == "tf32"
    out = harness.run_cell("twowl-copy.short", 3000000011, 0.2, False, cpu,
                           0.0, spec, small_config, small_traffic)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "epochs_per_s",
                                   "peak_mem_gib"}
    assert set(out["checks"]) == set(
        harness.load_data("limits", "twowl-copy.short"))
