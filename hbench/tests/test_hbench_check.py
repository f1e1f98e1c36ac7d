"""The check that decides `correct`, on the CPU at sizes a test run holds:
the reference agrees with the port's plain CPU path (every cell's run comes
out correct), each fault a cell can have comes out not correct, and so
does the control (the reference one precision below in the program's
place).

On the CPU the port runs its kernels' plain versions; the limits are the
cells' own, set from the card (`PERF.md`)."""

import pytest

from hbench import check, faults, harness

SPEC = harness.load_spec()
# small sizes of each cell's configuration and traffic (the TwoWL cell runs
# at its own size: fb-pages-food is small)
SMALL = {"twowl-fbpages.trial1": ({}, {})}
CONTROL = {"f32": "tf32"}


def run(name, cpu, seed=5):
    config, traffic = SMALL[name]
    return harness.run_cell(name, seed, 0.2, False, cpu, 0.0, SPEC,
                            config_overrides=config,
                            traffic_overrides=traffic)


def test_every_cell_is_small_here():
    assert set(SMALL) == {w["name"] for w in SPEC["workloads"]}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name, cpu):
    out = run(name, cpu)
    assert out["correct"], out["checks"]
    assert out["readings"]["build"] == 0
    assert set(out["checks"]) == set(harness.load_data("limits", name))


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_planted_fault_is_not_correct(name, fault, cpu):
    with faults.FAULTS[fault]():
        out = run(name, cpu)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_is_not_correct(name, cpu):
    cell = harness.workload(SPEC, name)
    config, traffic = SMALL[name]
    config = {**harness.load_data("configs", cell["config"]), **config}
    traffic = {**harness.load_data("traffic", cell["traffic"]), **traffic}
    drv = harness.driver(config)
    r = drv.start(drv.build(config, traffic, cpu), config, traffic, 6, cpu)
    readings = drv.readings(
        r, control_precision=CONTROL[config["model"]["dtype"]])
    judged = check.judge(readings, harness.load_data("limits", name))
    assert any(v > lim for _, v, lim in judged), judged
