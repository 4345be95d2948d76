"""``kernels_per_step``: the device operations (kernels, copies and
fills) of the traced segment over its steps.  A count: it repeats
exactly from run to run of one seed, and differs between seeds by how
many steps run the misfit fallback; what cuts launches moves it."""


def read(trace):
    if not trace.device or trace.steps <= 0:
        return None
    return len(trace.device) / trace.steps
