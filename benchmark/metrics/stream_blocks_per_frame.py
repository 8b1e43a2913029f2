"""stream_blocks_per_frame: the mean over the traced frames of the blocks
streamed out and back in (last_stats' streamed_out + streamed_in), or
None where the program does not count them."""

KEYS = ("streamed_out", "streamed_in")


def read(trace):
    if not trace.stats or any(k not in s for s in trace.stats for k in KEYS):
        return None
    return sum(s[k] for s in trace.stats for k in KEYS) / len(trace.stats)
