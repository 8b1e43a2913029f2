"""points.alloc_ms: host ms per traced frame inside points.alloc_candidates + points.alloc_blocks."""


def read(trace):
    return trace.host_ms_per_frame('points.alloc_candidates', 'points.alloc_blocks')
