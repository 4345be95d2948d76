"""``host_syncs_per_step``: the times a step of the traced segment
turned a device value into a Python number, each a wait for the
device's queue: the program's counter ``host_reads`` (its
``trace.host_read``) over the steps.  A count: on the periodic decks it
is the misfit count's one read a step."""

from pic_bench.metrics._snapshot import counter_per_step


def read(trace):
    return counter_per_step(trace, "host_reads")
