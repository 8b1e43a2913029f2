"""rgbd.coarsen_ms: host ms per traced frame inside rgbd.coarsen."""


def read(trace):
    return trace.host_ms_per_frame('rgbd.coarsen')
