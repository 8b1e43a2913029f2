"""alloc_new_pct: 100 x the blocks allocation inserted over the deduped
keys it submitted to the hash insert (last_stats' alloc_new and
alloc_keys), summed over the traced frames: useful outcomes over attempts.
None where no key was submitted or the program does not count them."""


def read(trace):
    if any("alloc_keys" not in s for s in trace.stats):
        return None
    keys = sum(s["alloc_keys"] for s in trace.stats)
    if not keys:
        return None
    return 100.0 * sum(s["alloc_new"] for s in trace.stats) / keys
