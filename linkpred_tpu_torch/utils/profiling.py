"""Throughput counters — the counterpart of `ThroughputCounter` in
`linkpred_tpu/utils/profiling.py`. (Its `device_trace` is the jax profiler;
the port's traces use `torch.profiler` directly.)

A span measures host time: a caller timing work on the card ends the span's
body with `torch.cuda.synchronize()`, since PyTorch returns before the card
finishes."""

from __future__ import annotations

import contextlib
import time


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
