"""``device_idle_pct``: the share of the traced segment's wall time in
which no operation ran on the device, 100 x (1 - busy / wall), busy
being the union of the kernel, copy and fill intervals (the arithmetic
of ``opal_tpu_torch/cli.py``'s ``_profiled``).  On several ranks it is
rank 0's."""


def read(trace):
    if not trace.device or trace.wall_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.wall_s)
