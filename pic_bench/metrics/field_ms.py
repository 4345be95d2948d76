"""``field_ms``: the device ms a step of the traced segment spent on
the grid, the program's phases ``opal.halo`` (the halo refresh),
``opal.deposit`` (the tap slab folded out to J and rho, the halo fold)
and ``opal.fields`` (the boundaries and the Yee advance): CUDA-event
extents, idle gaps inside them included, over the steps."""

from pic_bench.metrics._snapshot import device_ms_per_step


def read(trace):
    return device_ms_per_step(trace, ("opal.halo", "opal.deposit",
                                      "opal.fields"))
