"""``sort_migrate_ms``: the device ms a step of the traced segment
spent in the maintenance sort and the edge exchange, the program's
phases ``opal.sort`` and ``opal.exchange`` (CUDA-event extents, idle
gaps inside them included), over the steps."""

from pic_bench.metrics._snapshot import device_ms_per_step


def read(trace):
    return device_ms_per_step(trace, ("opal.sort", "opal.exchange"))
