"""What the traced run reads from the card: profiler captures of the step
loop and CUDA-event times of single ops.

Derived from `chip_smoke.profiled_ms`, `step_profile` and `cuda_ms`, whose
lessons it keeps: a capture loses some of its first events as a process goes
on, so each capture first launches `LEAD` small kernels that may be lost in
their place, idles `PAD_S`, runs the steps, idles again and launches
`TRAIL` more, and keeps the group of events between the two idle gaps; and
a capture now and then comes out rescaled, so captures are taken until two
agree on the device time a step within 5 %.

Everything here runs on the card only; nothing runs at import.
"""

from __future__ import annotations

import time

LEAD, TRAIL = 512, 4
PAD_S = 0.1
AGREE = 0.05
MAX_CAPTURES = 4
TOP = 10


def _device_events(prof) -> tuple[list, list]:
    """(device events, host events) of a capture as (name, start_us,
    end_us), sorted by start. Annotation ranges that the trace also shows on
    the card (a host range's name, e.g. `Optimizer.step#Adam.step`) overlap
    real kernels and are dropped."""
    import torch

    host, dev = [], []
    for e in prof.events():
        start = e.time_range.start
        item = (e.name, start, start + e.time_range.elapsed_us())
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(item)
        elif not getattr(e, "is_user_annotation", False):
            dev.append(item)
    names = {h[0] for h in host}
    dev = [d for d in dev if d[0] not in names]
    return sorted(dev, key=lambda d: d[1]), sorted(host, key=lambda h: h[1])


def _steps_group(dev: list) -> list | None:
    """The events between the two idle gaps of a capture (see the module
    docstring), or None when the capture did not keep the trailing kernels
    apart."""
    groups, last_end = [[]], None
    for ev in dev:
        if last_end is not None and ev[1] - last_end > PAD_S * 1e6 / 2:
            groups.append([])
        groups[-1].append(ev)
        last_end = ev[2] if last_end is None else max(last_end, ev[2])
    if len(groups) < 2 or len(groups[-1]) != TRAIL:
        return None
    return groups[-2]


def _union(events: list) -> list:
    """Merged busy intervals [start_us, end_us] of the events."""
    merged = []
    for _, start, end in sorted(events, key=lambda e: e[1]):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _capture(run_steps, steps: int, with_host: bool):
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if with_host:
        activities.append(ProfilerActivity.CPU)
    lead = torch.zeros(32, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(LEAD):
            lead.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        run_steps(steps)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        for _ in range(TRAIL):
            lead.add_(1.0)
        torch.cuda.synchronize()
    dev, host = _device_events(prof)
    return _steps_group(dev), host


def profile_steps(run_steps, steps: int) -> dict:
    """Device activity of `run_steps(steps)` (the window's own call, `steps`
    steps at once) from captures of the card alone, taken until two agree
    within `AGREE` on busy time, plus one capture with the host's events for
    what the host did in the card's idle gaps.

    Returns steps, device ops per step, busy_s and window_s (the union of
    the steps' device intervals, and the span from their first start to
    their last end), the device ops that took most time, and the longest
    idle gaps summed by the host op that ran through them."""
    seen = []
    for _ in range(MAX_CAPTURES):
        group, _ = _capture(run_steps, steps, with_host=False)
        if group is None:
            continue
        busy = sum(e - s for s, e in _union(group))
        pair = next((g for g in seen
                     if abs(g[1] - busy) <= AGREE * max(g[1], busy)), None)
        seen.append((group, busy))
        if pair is not None:
            break
    else:
        if not seen:
            raise RuntimeError("no profiler capture kept the steps apart")
    group, busy = seen[-1]
    window = max(e for _, _, e in group) - group[0][1]
    by_name = {}
    for name, start, end in group:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    host_group, host = _capture(run_steps, steps, with_host=True)
    gaps = {}
    if host_group:
        busy_iv = _union(host_group)
        for (_, a), (b, _) in zip(busy_iv, busy_iv[1:]):
            mid = (a + b) / 2
            # the innermost host op running through the gap's middle
            covering = [h for h in host if h[1] <= mid <= h[2]]
            name = (max(covering, key=lambda h: h[1])[0] if covering
                    else "(no host op)")
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "steps": steps,
        "device_ops": len(group),
        "busy_s": busy / 1e6,
        "window_s": window / 1e6,
        "captures_busy_s": [b / 1e6 for _, b in seen],
        "top_ops": [[n[:120], s] for n, s in top_ops],
        "idle_gaps": [[n[:120], s] for n, s in top_gaps],
    }


FLUSH_BYTES = 256 << 20  # > the card's 50 MB L2
HOLD_CYCLES = 400_000  # ~0.2 ms of the card's clock


def time_op(fn, calls: int = 100, warmup: int = 5) -> float:
    """Seconds per call of `fn` on the card: CUDA events around each call,
    the L2 cache flushed before each (a write of `FLUSH_BYTES`), so a call
    reads its inputs from memory as the step's first touch of them does.
    A spin kernel of `HOLD_CYCLES` after the flush keeps the card busy
    while the host queues the start event and the call, so the events time
    the call and not the host's issue of it."""
    import torch

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    torch.cuda.synchronize()
    for start, stop in events:
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    total_ms = sum(start.elapsed_time(stop) for start, stop in events)
    del flush
    return total_ms / calls / 1e3


def time_ops(ops: list) -> list:
    """`ops` (dicts with `fn` and the yardstick's kernel, bytes, flops,
    dtype and calls a step) with each `fn` timed by `time_op`; the returned
    entries carry `seconds` a call and no `fn`."""
    import torch

    out = []
    with torch.no_grad():
        for op in ops:
            entry = {k: v for k, v in op.items() if k != "fn"}
            entry["seconds"] = time_op(op["fn"])
            out.append(entry)
    return out
