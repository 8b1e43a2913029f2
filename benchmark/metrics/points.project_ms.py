"""points.project_ms: host ms per traced frame inside points.raster + points.projection."""


def read(trace):
    return trace.host_ms_per_frame('points.raster', 'points.projection')
