"""Minimal sensor_msgs/PointCloud2 decoder (a copy of
mrhash_tpu/apps/utils/point_cloud2.py, after mrhash/apps/utils/
point_cloud2.py): numpy structured-array view over the message buffer."""
from __future__ import annotations

import numpy as np

_DATATYPES = {
    1: ("i1", 1), 2: ("u1", 1), 3: ("i2", 2), 4: ("u2", 2),
    5: ("i4", 4), 6: ("u4", 4), 7: ("f4", 4), 8: ("f8", 8),
}


def dtype_from_fields(fields, point_step):
    names, formats, offsets = [], [], []
    for f in fields:
        base, size = _DATATYPES[f.datatype]
        count = getattr(f, "count", 1) or 1
        for c in range(count):
            names.append(f.name if count == 1 else f"{f.name}_{c}")
            formats.append(base)
            offsets.append(f.offset + c * size)
    return np.dtype({"names": names, "formats": formats,
                     "offsets": offsets, "itemsize": point_step})


def read_points(cloud, field_names=None, skip_nans=True):
    """Returns a structured array restricted to field_names."""
    dtype = dtype_from_fields(cloud.fields, cloud.point_step)
    n = cloud.width * cloud.height
    arr = np.frombuffer(bytes(cloud.data), dtype=dtype, count=n)
    if field_names is not None:
        arr = arr[list(field_names)]
    if skip_nans:
        ok = np.ones(n, bool)
        for name in arr.dtype.names:
            col = arr[name]
            if np.issubdtype(col.dtype, np.floating):
                ok &= np.isfinite(col)
        arr = arr[ok]
    return arr
