"""``misfit_ms``: the device ms a step of the traced segment spent in
the misfit fallback, the program's phase ``opal.misfit`` (the
compaction's scan, its host read, the fallback's push and deposit):
its CUDA-event extent on the stream, its kernels and the idle gaps
between them, over the steps."""

from pic_bench.metrics._snapshot import device_ms_per_step


def read(trace):
    return device_ms_per_step(trace, ("opal.misfit",))
