"""stream.ingest_ms: the stream-out worker's ingest ms (decode and add to
the host chunk grid, which holds the GIL) per event joined in the traced
frames (last_stats' stream_ingest_ms over stream_joined), or None where
no event was joined or the program does not count them."""


def read(trace):
    if any(k not in s for s in trace.stats
           for k in ("stream_joined", "stream_ingest_ms")):
        return None
    joined = sum(s["stream_joined"] for s in trace.stats)
    if not joined:
        return None
    return sum(s["stream_ingest_ms"] for s in trace.stats) / joined
