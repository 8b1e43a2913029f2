"""upload_ms: host ms per traced frame inside compute.upload, the upload
of the pose and the frame to the card in GeoWrapper.compute."""


def read(trace):
    return trace.host_ms_per_frame("compute.upload")
