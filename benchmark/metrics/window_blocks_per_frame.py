"""window_blocks_per_frame: the mean over the traced frames of
last_stats' occupied_blocks, the entries of each frame's window, or None
where the program does not give them."""


def read(trace):
    if not trace.stats or any("occupied_blocks" not in s
                              for s in trace.stats):
        return None
    return sum(s["occupied_blocks"] for s in trace.stats) / len(trace.stats)
