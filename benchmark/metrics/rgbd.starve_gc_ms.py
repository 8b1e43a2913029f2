"""rgbd.starve_gc_ms: host ms per traced frame inside rgbd.starve_gc."""


def read(trace):
    return trace.host_ms_per_frame('rgbd.starve_gc')
