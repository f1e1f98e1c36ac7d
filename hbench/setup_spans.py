"""Seconds of a port span in a traced run's set-up (`spans.py` part (a)),
for the readers of set-up phases: the durations of every span of that name
summed; None where the port opened none (a port without that span)."""

from __future__ import annotations


def seconds(ctx, name: str) -> float | None:
    setup = (getattr(ctx, "spans", None) or {}).get("setup") or []
    found = [s for s in setup if s.name == name]
    if not found:
        return None
    return sum(s.end_ns - s.start_ns for s in found) / 1e9
