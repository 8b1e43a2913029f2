"""host_syncs_per_frame: the mean over the traced frames of last_stats'
host_syncs, the frame step's reads of device values by the host (each a
stream synchronization), or None where the program does not count them."""


def read(trace):
    if not trace.stats or any("host_syncs" not in s for s in trace.stats):
        return None
    return sum(s["host_syncs"] for s in trace.stats) / len(trace.stats)
