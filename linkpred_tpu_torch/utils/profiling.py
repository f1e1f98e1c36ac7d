"""Profiling hooks: `torch.profiler` traces, the port's span recorder and
throughput counters — the counterpart of `linkpred_tpu/utils/profiling.py`.

`device_trace` is the CLI's `--profile`: a trace of the whole command that
TensorBoard's profiler plugin, Perfetto or `chrome://tracing` can read. A
span of `ThroughputCounter` measures host time: a caller timing work on the
card ends the span's body with `torch.cuda.synchronize()`, since PyTorch
returns before the card finishes.

`span(name)` marks a phase of the program (the TwoWL epoch loops, the
kernel loader). Where the single-trial loop replays its epoch as a CUDA
graph (`models/twowl.train_loop`), a replayed epoch's span holds one
`twowl.replay` and no phase span (`twowl.inputs`, `twowl.forward`,
`twowl.backward`, `twowl.optimizer`, `twowl.eval`): the phases open only
while the graph is recorded, inside `twowl.capture`, and in the epochs run
op by op. Outside `recording()` it costs one check of a module-level
flag and returns a shared no-op context: no clock is read. Inside, each
span is kept in memory as a `Span` (name, id, parent id, start and end on
`time.perf_counter_ns`), and while a `torch.profiler` is running it also
opens a `record_function` range of the same name, so the phase sits on the
profiler's clock beside the ops it launched. `mark_step` adds a timed CUDA
event at each epoch's start; `Record.step_ms` reads the epochs' intervals
on the card's clock after a synchronize."""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import sys
import threading
import time
from typing import NamedTuple

import torch


class Span(NamedTuple):
    name: str
    id: int
    parent: int | None  # the enclosing span of the same thread
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class Record:
    """What one `recording()` kept: the spans in the order they closed, and
    the `mark_step` events as (event, True at a step's start, False at a
    loop's end)."""

    spans: list = dataclasses.field(default_factory=list)
    steps: list = dataclasses.field(default_factory=list)

    def step_ms(self) -> list[float]:
        """Card milliseconds from each step's start to the next event of its
        loop (the next step's start or the loop's end). Read after a
        synchronize."""
        return [a.elapsed_time(b) for (a, starts), (b, _) in
                zip(self.steps, self.steps[1:]) if starts]


def self_ns(spans) -> dict[int, int]:
    """Each span's duration less the part its children cover, by span id.
    A thread's children run one after another, so their durations add."""
    own = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


_recording: Record | None = None  # the flag: None while nothing records
_NO_SPAN = contextlib.nullcontext()
_ids = itertools.count(1)
_open = threading.local()  # each thread's stack of open span ids
_clock = time.perf_counter_ns


class _Span:
    __slots__ = ("name", "record", "id", "parent", "start", "range")

    def __init__(self, name: str, record: Record):
        self.name, self.record = name, record

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.range = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        if self.range is not None:
            self.range.__exit__(*exc)
        _open.stack.pop()
        self.record.spans.append(
            Span(self.name, self.id, self.parent, self.start, end))
        return False


def span(name: str):
    """A context that records the phase `name` while `recording()` is on,
    and does nothing otherwise."""
    if _recording is None:
        return _NO_SPAN
    return _Span(name, _recording)


def mark_step(device, end: bool = False) -> None:
    """While recording on a CUDA device: a timed event on its current stream
    at a step's start, or with `end` at its loop's end."""
    if _recording is None or device.type != "cuda":
        return
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    _recording.steps.append((event, not end))


@contextlib.contextmanager
def recording():
    """Record spans and step events in the block; yields the `Record`. An
    inner `recording()` takes over until it ends."""
    global _recording
    outer, record = _recording, Record()
    _recording = record
    try:
        yield record
    finally:
        _recording = outer


@contextlib.contextmanager
def device_trace(log_dir: str = "logs/profile", cuda: bool = True):
    """Trace the block with `torch.profiler` and write it into `log_dir` as
    one `<host>_<pid>.<time>.pt.trace.json` file
    (`tensorboard_trace_handler`).

    The card's activity (kernels, copies) is recorded beside the host's
    whenever a card is visible; without one the trace holds the host alone,
    and stderr says so. `cuda=False` asks for the host alone. Spans are
    recorded, so the program's phases show as named ranges."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if cuda and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    elif cuda:
        print("device_trace: no CUDA device is visible; the trace holds "
              "host activity only", file=sys.stderr)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)), \
            recording():
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
