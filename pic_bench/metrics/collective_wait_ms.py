"""``collective_wait_ms``: the device ms a step of the traced segment
that rank 0's compute stream stalled in the ring's collectives, the
program's spans ``opal.collective.shift`` (the halo of E and B, the
fold of J and rho, the exchange's rows) and ``opal.collective.psum``
(the losses' sum): each a CUDA-event extent around the collective and
its wait, over the steps.  They lie inside the phases, so this is no
part of a sum of phases.  A program that times no collective on the
device gives None."""

from pic_bench.metrics._snapshot import device_ms_per_step


def read(trace):
    return device_ms_per_step(trace, ("opal.collective.shift",
                                      "opal.collective.psum"))
