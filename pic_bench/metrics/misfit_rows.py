"""``misfit_rows``: the rows the misfit fallback pushed a step of the
traced segment, the alive rows that left their block's window: the
program's counter ``misfit_rows`` over the steps.  A count; it repeats
exactly for one seed."""

from pic_bench.metrics._snapshot import counter_per_step


def read(trace):
    return counter_per_step(trace, "misfit_rows")
