"""points.coarsen_ms: host ms per traced frame inside points.coarsen."""


def read(trace):
    return trace.host_ms_per_frame('points.coarsen')
