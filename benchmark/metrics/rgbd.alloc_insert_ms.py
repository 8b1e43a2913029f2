"""rgbd.alloc_insert_ms: host ms per traced frame inside the alloc.dedup
and alloc.insert ranges that lie inside rgbd.alloc (the salted dedup and
the hash insert of each allocation round), or None where none did."""


def read(trace):
    outer = trace.ranges.get("rgbd.alloc", [])
    spans = [(a, b) for name in ("alloc.dedup", "alloc.insert")
             for a, b in trace.ranges.get(name, [])
             if any(p <= a and b <= q for p, q in outer)]
    if not spans:
        return None
    return sum(b - a for a, b in spans) / 1e3 / trace.frames
