"""rgbd.compact_ms: host ms per traced frame inside rgbd.compact, the
window's compaction before K1."""


def read(trace):
    return trace.host_ms_per_frame("rgbd.compact")
