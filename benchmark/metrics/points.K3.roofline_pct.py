"""points.K3.roofline_pct: the least time of the window's fused LiDAR
update (work.points_k3) over the device time of everything launched
inside points.K3, in %."""
import work


def read(trace):
    return work.roofline_pct(trace, "points.K3",
                             lambda s: work.points_k3(s, trace.sensor))
