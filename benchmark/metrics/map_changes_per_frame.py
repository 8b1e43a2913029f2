"""map_changes_per_frame: the blocks the map gained, coarsened and freed
(last_stats' alloc_new + coarsened + gc_freed) per traced frame: the
map's work as a count, or None where the program does not count it."""

KEYS = ("alloc_new", "coarsened", "gc_freed")


def read(trace):
    if not trace.stats or any(k not in s for s in trace.stats for k in KEYS):
        return None
    return sum(s[k] for s in trace.stats for k in KEYS) / trace.frames
