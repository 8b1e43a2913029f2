"""points.reach_ms: host ms per traced frame inside points.reach (the
LiDAR window's reach test, its compaction and the join of the carried
coarsening decisions), or None where the program has no such span."""


def read(trace):
    return trace.host_ms_per_frame('points.reach')
