"""Console progress formatting: runtime, ETA, SI-prefixed simulation
time (``src/setup.rs:374-438``)."""

from __future__ import annotations

import math
import time


def ettc(start: float, current: int, total: int) -> float:
    """Estimated time to completion in seconds (``setup.rs:374-378``)."""
    rt = time.monotonic() - start
    if current == 0:
        return 0.0
    return rt * (total - current) / current


def pretty_duration(seconds: float) -> str:
    """``[Nd ]HH:MM:SS`` (``setup.rs:400-415``)."""
    t = int(seconds)
    s = t % 60
    t //= 60
    mins = t % 60
    t //= 60
    hr = t % 24
    d = t // 24
    if d > 0:
        return f"{d}d {hr:02}:{mins:02}:{s:02}"
    return f"{hr:02}:{mins:02}:{s:02}"


def simulation_time(t: float) -> str:
    """SI-prefixed time, right-aligned (``setup.rs:420-438``)."""
    if t == 0.0 or not math.isfinite(t):
        power = 0
    else:
        power = 3.0 * math.floor(math.log10(abs(t)) / 3.0)
        power = int(min(0.0, max(-18.0, power)))
    unit, scale = {
        -18: ("as", 1.0e18),
        -15: ("fs", 1.0e15),
        -12: ("ps", 1.0e12),
        -9: ("ns", 1.0e9),
        -6: ("μs", 1.0e6),
        -3: ("ms", 1.0e3),
    }.get(power, (" s", 1.0))
    return f"{scale * t: >8.2f} {unit}"
