"""The traced segment: what ``torch.profiler`` saw, kept in memory.

A :class:`Trace` holds the device's operations (CUDA kernels, copies and
fills) and the host's events (PyTorch operators, CUDA runtime calls and
the named ranges of the program and of the benchmark) of one traced
segment, with its wall seconds and steps and what the deck's module
says of the state (``context``).  The per-layer readers in ``metrics/`` read
only this object, so each can be tested on a synthetic one.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

#: the benchmark's own range around the traced segment
SEGMENT_RANGE = "pic_bench.segment"
#: entries of each list of the result's ``breakdown``
BREAKDOWN_ENTRIES = 10


@dataclasses.dataclass
class Trace:
    """``device`` and ``host`` are lists of (name, start_us, end_us);
    ``wall_s`` the segment's seconds on the host clock, the device
    synchronised at both ends; ``steps`` the steps it ran."""

    device: list
    host: list
    wall_s: float
    steps: int
    context: dict = dataclasses.field(default_factory=dict)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union
        of the device intervals."""
        busy, end = 0.0, float("-inf")
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return busy * 1e-6

    def idle_gaps(self) -> list:
        """(start_us, end_us) of each stretch between the first and the
        last device operation in which none ran."""
        gaps, end = [], None
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        return gaps

    def host_label(self, t_us: float, index=None) -> str:
        """The innermost host event open at ``t_us`` (the shortest that
        spans it), or ``python`` where only the segment's own range is
        open."""
        starts, events = index if index is not None else self._host_index()
        best = None
        i = bisect.bisect_right(starts, t_us)
        # nested events start close together: a bounded look back
        for name, a, b in events[max(0, i - 256):i]:
            if a <= t_us <= b and name != SEGMENT_RANGE and (
                    best is None or b - a < best[2] - best[1]):
                best = (name, a, b)
        return best[0] if best else "python"

    def _host_index(self):
        events = sorted(self.host, key=lambda e: e[1])
        return [e[1] for e in events], events

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing, in seconds."""
        by_op: dict = {}
        for name, a, b in self.device:
            by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-6
        index = self._host_index()
        by_host: dict = {}
        for a, b in self.idle_gaps():
            label = self.host_label(0.5 * (a + b), index)
            by_host[label] = by_host.get(label, 0.0) + (b - a) * 1e-6
        top = lambda d: [[k[:160], v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def capture(fn, sync, steps: int, context: dict):
    """Run ``fn()`` under ``torch.profiler`` inside the benchmark's
    segment range; returns (result, Trace).  A named range (the
    program's or the benchmark's) also appears on the device's timeline,
    from its first operation to its last; those spans are left out of
    ``device``, which holds the work alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(SEGMENT_RANGE):
            out = fn()
        sync()
        wall = time.perf_counter() - t0
    events = prof.events()
    ranges = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    device, host = [], []
    for e in events:
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if e.name not in ranges:
                device.append(span)
        elif e.device_type == DeviceType.CPU:
            host.append(span)
    return out, Trace(device=device, host=host, wall_s=wall, steps=steps,
                      context=dict(context))
