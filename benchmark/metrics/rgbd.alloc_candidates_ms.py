"""rgbd.alloc_candidates_ms: host ms per traced frame inside
rgbd.alloc.candidates, the DDA walk that lists allocation candidates."""


def read(trace):
    return trace.host_ms_per_frame("rgbd.alloc.candidates")
