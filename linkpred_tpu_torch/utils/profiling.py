"""Profiling hooks: `torch.profiler` traces and throughput counters — the
counterpart of `linkpred_tpu/utils/profiling.py`.

`device_trace` is the CLI's `--profile`: a trace of the whole command that
TensorBoard's profiler plugin, Perfetto or `chrome://tracing` can read. A
span of `ThroughputCounter` measures host time: a caller timing work on the
card ends the span's body with `torch.cuda.synchronize()`, since PyTorch
returns before the card finishes."""

from __future__ import annotations

import contextlib
import sys
import time

import torch


@contextlib.contextmanager
def device_trace(log_dir: str = "logs/profile", cuda: bool = True):
    """Trace the block with `torch.profiler` and write it into `log_dir` as
    one `<host>_<pid>.<time>.pt.trace.json` file
    (`tensorboard_trace_handler`).

    The card's activity (kernels, copies) is recorded beside the host's
    whenever a card is visible; without one the trace holds the host alone,
    and stderr says so. `cuda=False` asks for the host alone."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if cuda and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    elif cuda:
        print("device_trace: no CUDA device is visible; the trace holds "
              "host activity only", file=sys.stderr)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class ThroughputCounter:
    """Accumulates (items, seconds) spans; reports items/sec."""

    def __init__(self, unit: str = "edges"):
        self.unit = unit
        self.items = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def span(self, items: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.items += items

    @property
    def rate(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0

    def report(self) -> str:
        return f"{self.rate:,.0f} {self.unit}/s ({self.items} in {self.seconds:.3f}s)"
