"""stream.out_ms: host ms inside stream.out (the stream trigger's join of
the previous job, its plan, gather and clear, and the copy's launch)
per time the range opened, so per stream-out event: the number of events
in the traced stretch does not move it.  None where the range never
opened."""


def read(trace):
    spans = trace.ranges.get("stream.out", [])
    if not spans:
        return None
    return sum(b - a for a, b in spans) / 1e3 / len(spans)
