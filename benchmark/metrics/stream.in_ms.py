"""stream.in_ms: host ms per traced frame inside stream.in, the host
chunks brought back to the card ahead of the frames (their pop from the
grid, the upload and the insert), or None where the range never
opened."""


def read(trace):
    return trace.host_ms_per_frame("stream.in")
