"""The check that decides `correct`, on the CPU at sizes a test run holds:
the reference agrees with the port's plain CPU path (every cell's run comes
out correct), each fault a cell can have comes out not correct, and so
does the control (the reference one precision below in the program's
place).

Every cell of `BENCHMARK.json` is tested here without an edit to this
file. A new cell brings `configs/<config>.json` (naming its driver and
precision), `traffic/<traffic>.json`, `limits/<workload>.json`,
`small/<workload>.json` (the top-level keys of its configuration and
traffic replaced to run it small here; `{"config": {}, "traffic": {}}`
runs it at its own size), the readers of its new per-layer metrics under
`metrics/`, and, for a new family, `drivers/<driver>.py` (with
`CONTROL_PRECISION`, the control of each precision it runs) and its
reference under `reference/`. In `BENCHMARK.json` it adds a `configs`
entry, a `workloads` entry, and its name to the `workloads` list of each
metric it reports. Its per-layer span metrics read only in `--trace 1`
runs.

On the CPU the port runs its kernels' plain versions; the limits are the
cells' own, set from the card (`PERF.md`)."""

import pytest

from hbench import check, faults, harness

SPEC = harness.load_spec()
CELLS = sorted(w["name"] for w in SPEC["workloads"])


def sized(name):
    """Cell `name`'s configuration and traffic at its small size."""
    cell = harness.workload(SPEC, name)
    config, traffic = harness.small(name)
    return ({**harness.load_data("configs", cell["config"]), **config},
            {**harness.load_data("traffic", cell["traffic"]), **traffic})


def run(name, cpu, seed=5):
    config, traffic = harness.small(name)
    return harness.run_cell(name, seed, 0.2, False, cpu, 0.0, SPEC,
                            config_overrides=config,
                            traffic_overrides=traffic)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_has_a_small_file(name):
    """`small/<workload>.json` exists and replaces only keys that the
    cell's configuration and traffic have."""
    cell = harness.workload(SPEC, name)
    config, traffic = harness.small(name)
    assert set(config) <= set(harness.load_data("configs", cell["config"]))
    assert set(traffic) <= set(harness.load_data("traffic", cell["traffic"]))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, cpu):
    out = run(name, cpu)
    assert out["correct"], out["checks"]
    assert out["readings"]["build"] == 0
    assert set(out["checks"]) == set(harness.load_data("limits", name))


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault, cpu):
    with faults.FAULTS[fault]():
        out = run(name, cpu)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, cpu):
    config, traffic = sized(name)
    drv = harness.driver(config)
    r = drv.start(drv.build(config, traffic, cpu), config, traffic, 6, cpu)
    readings = drv.readings(
        r, control_precision=harness.control_precision(config))
    judged = check.judge(readings, harness.load_data("limits", name))
    assert any(v > lim for _, v, lim in judged), judged
