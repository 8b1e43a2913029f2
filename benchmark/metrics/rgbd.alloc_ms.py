"""rgbd.alloc_ms: host ms per traced frame inside rgbd.alloc."""


def read(trace):
    return trace.host_ms_per_frame('rgbd.alloc')
