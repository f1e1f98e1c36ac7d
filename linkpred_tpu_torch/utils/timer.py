"""Named wall-clock spans — the counterpart of `linkpred_tpu/utils/timer.py`.

A span measures host time: work queued on the card inside it is counted
only as far as the span's own code waits for it."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List


class StepTimer:
    """Accumulates named wall-clock spans."""

    def __init__(self):
        self.spans: Dict[str, float] = {}
        self.order: List[str] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if name not in self.spans:
                self.order.append(name)
                self.spans[name] = 0.0
            self.spans[name] += dt

    @property
    def total(self) -> float:
        return sum(self.spans.values())

    def report(self) -> str:
        lines = [f"{name:>28s}: {self.spans[name]:8.3f} s"
                 for name in self.order]
        lines.append(f"{'total':>28s}: {self.total:8.3f} s")
        return "\n".join(lines)
