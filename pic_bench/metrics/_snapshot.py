"""The program's own record of the traced segment, for the readers of
its spans and counters: ``opal_tpu_torch.trace.snapshot()`` (the spans'
calls, the phases' device milliseconds and the counters of the last
profiled stretch), taken a step at a time over ``trace.steps``.  A
program without that module, or one that recorded nothing, gives None.
"""


def snapshot():
    """The program's snapshot, or None where it has none."""
    try:
        from opal_tpu_torch import trace as program
    except ImportError:
        return None
    snap = program.snapshot()
    return snap if snap.get("spans") else None


def counter_per_step(trace, name: str):
    """The counter ``name`` over the traced segment's steps."""
    snap = snapshot()
    if snap is None or trace.steps <= 0 or name not in snap["counters"]:
        return None
    return snap["counters"][name] / trace.steps


def device_ms_per_step(trace, names):
    """The summed device ms of the phases ``names`` over the steps;
    None where none of them ran."""
    snap = snapshot()
    if snap is None or trace.steps <= 0:
        return None
    ran = [snap["spans"][n]["device_ms"] for n in names
           if "device_ms" in snap["spans"].get(n, {})]
    return sum(ran) / trace.steps if ran else None
