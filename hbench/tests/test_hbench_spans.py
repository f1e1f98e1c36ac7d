"""`spans.py`'s arithmetic by hand on tiny lists (the tail with its sample
count, self time, idle gaps put down to the innermost span), its readers
with and without spans, and one run of the cell with spans on the CPU."""

from types import SimpleNamespace

import pytest

from hbench import harness, spans
from linkpred_tpu_torch.utils.profiling import Span


def test_tail_by_hand():
    values = [float(v) for v in range(240, 0, -1)]
    # exclusive method: the 95th percentile sits at 0.95 * (240 + 1)
    assert spans.tail(values) == pytest.approx((120.5, 228.95, 240))
    assert spans.tail(values[:spans.MIN_TAIL - 1]) is None


# one epoch (0-100 ns) over forward (10-40), holding an inner span (20-25),
# and backward (50-90); a second epoch (200-260) over forward (210-230)
EPOCHS = [Span("twowl.epoch", 1, None, 0, 100),
          Span("twowl.forward", 2, 1, 10, 40), Span("inner", 3, 2, 20, 25),
          Span("twowl.backward", 4, 1, 50, 90),
          Span("twowl.epoch", 5, None, 200, 260),
          Span("twowl.forward", 6, 5, 210, 230)]


def test_self_time_by_hand():
    # epoch self: 100 - 30 - 40 = 30 and 60 - 20 = 40; forward 30 - 5, 20
    ms = {(name, own): spans.median_ms(EPOCHS, name, own) for name, own in
          (("twowl.epoch", True), ("twowl.epoch", False),
           ("twowl.forward", True))}
    assert ms == pytest.approx({("twowl.epoch", True): 35e-6,
                                ("twowl.epoch", False): 80e-6,
                                ("twowl.forward", True): 22.5e-6})
    assert spans.median_ms(EPOCHS, "twowl.eval", own=True) is None


def test_idle_goes_to_the_innermost_span_over_the_midpoint():
    busy = [[0, 10], [20, 30], [36, 44], [90, 100], [300, 310]]
    ranges = [("twowl.epoch", 0, 200), ("twowl.forward", 5, 50),
              ("kernels.load", 32, 38)]
    # gaps (us): 10-20 mid 15 forward; 30-36 mid 33 load; 44-90 mid 67
    # epoch; 100-300 mid 200 epoch (an end counts); 300 is past every span
    assert spans.idle_by_span(busy, ranges) == pytest.approx(
        {"twowl.epoch": 246e-6, "twowl.forward": 10e-6,
         "kernels.load": 6e-6})
    assert spans.idle_by_span(busy[:2] + [[500, 510]], ranges) == \
        pytest.approx({spans.NO_SPAN: 470e-6, "twowl.forward": 10e-6})


@pytest.mark.parametrize("metric", sorted(spans.METRICS))
def test_readers_read_nothing_without_spans(metric):
    read = harness.reader(metric).read
    assert read(SimpleNamespace(build_s=0.1)) is None
    assert read(SimpleNamespace(spans={"setup": None, "stretch": None,
                                       "idle": None})) is None


def test_readers_by_hand():
    setup = [Span("kernels.load", 7, None, 0, 2_000_000),
             Span("kernels.compile", 8, 7, 10, 1_000_000),
             Span("twowl.epoch", 9, None, 3_000_000, 9_000_000),
             Span("kernels.load", 10, 11, 4_000_000, 5_000_000),
             Span("twowl.epoch", 12, None, 9_500_000, 9_600_000)]
    step_ms = [float(v) for v in range(1, 241)]
    ctx = SimpleNamespace(spans={
        "setup": setup, "idle": None,
        "stretch": {"spans": EPOCHS, "step_ms": step_ms,
                    "epochs_per_s": 1.0}})
    want = {"host_ms.epochs": 80e-6, "forward_ms.epochs": 22.5e-6,
            "backward_ms.epochs": 40e-6, "optimizer_ms.epochs": None,
            "eval_ms.epochs": None, "epoch_ms_p50.epochs": 120.5,
            "epoch_ms_p95.epochs": 228.95, "kernel_load_s.setup": 3e-3,
            "first_epoch_s.setup": 6e-3}
    assert set(want) == set(spans.METRICS)
    for metric, value in want.items():
        got = harness.reader(metric).read(ctx)
        assert got == (value if value is None else pytest.approx(value)), \
            metric


def test_a_run_with_spans_on_the_cpu(cpu):
    """The cell at its own size with spans: the checked epochs ran with
    recording on and are correct; the phases' self times and the epoch's
    own add up to the epoch; the card's numbers are absent."""
    out = spans.measure_cell("twowl-fbpages.trial1", 3000000007, 0.2, cpu,
                             steps=4)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == set(spans.METRICS) - {"epoch_ms_p50.epochs",
                                           "epoch_ms_p95.epochs"}
    assert m["kernel_load_s.setup"] == 0.0  # plain versions on the CPU
    assert 0 < m["first_epoch_s.setup"]
    assert out["phases_self_sum_ms"] == pytest.approx(m["host_ms.epochs"],
                                                      rel=0.5)
    assert out["epoch_samples"] == 0 and out["idle"] is None


def test_a_traced_run_reads_the_spans_before_any_capture(monkeypatch, cpu):
    """`harness.run_cell` with `trace` on the CPU, the card's captures and
    op timings faked: set-up's spans and a stretch of the driver's length
    after the window are taken before the first profiler capture, and the
    span metrics that the cell lists read where the CPU has them (the epoch
    tail is the card's events)."""
    from hbench import trace

    order = []
    stretch = spans.stretch

    def spy_stretch(run, device, steps):
        order.append(("stretch", steps))
        return stretch(run, device, steps)

    def fake_profile(run_steps, steps):
        order.append(("profile", steps))
        return {"steps": steps, "device_ops": 1, "busy_s": 1.0,
                "window_s": 2.0, "captures_busy_s": [1.0], "top_ops": [],
                "idle_gaps": []}

    monkeypatch.setattr(spans, "stretch", spy_stretch)
    monkeypatch.setattr(spans, "STRETCH_STEPS", 4)
    monkeypatch.setattr(trace, "profile_steps", fake_profile)
    monkeypatch.setattr(trace, "time_ops", lambda ops: [])
    out = harness.run_cell("twowl-fbpages.trial1", 3000000013, 0.2, True,
                           cpu, 0.0)
    assert out["correct"], out["checks"]
    assert [kind for kind, _ in order] == ["stretch", "profile"]
    assert order[0][1] == 4
    listed = {m["name"] for m in harness.reported(
        harness.load_spec()["per_layer"], "twowl-fbpages.trial1")
        if m["source"] == "program_span"}
    assert listed == {"host_ms.epochs", "epoch_ms_p50.epochs",
                      "epoch_ms_p95.epochs", "kernel_load_s.setup",
                      "first_epoch_s.setup"}
    read = {k: v["value"] for k, v in out["metrics"].items() if k in listed}
    assert set(read) == listed - {"epoch_ms_p50.epochs",
                                  "epoch_ms_p95.epochs"}
    assert read["host_ms.epochs"] > 0 and read["first_epoch_s.setup"] > 0
    assert read["kernel_load_s.setup"] == 0.0  # plain versions on the CPU
