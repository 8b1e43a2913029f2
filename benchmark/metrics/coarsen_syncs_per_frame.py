"""coarsen_syncs_per_frame: the mean over the traced frames of
last_stats' coarsen_syncs, the reads of device values by the host inside
the frame step's coarsening (each a stream synchronization), or None
where the program does not count them."""


def read(trace):
    if not trace.stats or any("coarsen_syncs" not in s for s in trace.stats):
        return None
    return sum(s["coarsen_syncs"] for s in trace.stats) / len(trace.stats)
