"""``collectives_per_step``: the collectives rank 0 issued a step of the
traced segment, the program's counter ``collectives`` (its shifts,
sums and gathers, counted on the host) over the steps.  A count: two
shifts a step, the exchange's shift every 160 steps and at the end, and
the losses' sum once a call.  A program without the counter gives
None."""

from pic_bench.metrics._snapshot import counter_per_step


def read(trace):
    return counter_per_step(trace, "collectives")
