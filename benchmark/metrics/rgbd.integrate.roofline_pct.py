"""rgbd.integrate.roofline_pct: the least time of the window's
compaction and fused update (work.rgbd_integrate) over the device time of
everything launched inside rgbd.integrate, in %."""
import work


def read(trace):
    buckets = trace.conf["map"]["num_buckets"]
    return work.roofline_pct(
        trace, "rgbd.integrate",
        lambda s: work.rgbd_integrate(s, trace.sensor, buckets))
