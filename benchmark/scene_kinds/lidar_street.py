"""A LiDAR driving down a straight street into new ground.

The street runs along +x: a ground plane `ground_z` below the sensor, and
on each side a row of buildings, one per lot of `lot_m`, whose front
faces stand `half_width_m` plus a setback from the centre line, `depth_m`
deep, and whose heights and setbacks spread evenly over `height_m` and
`setback_m`; on each side `gaps` lots hold no building (cross streets).
The seed draws the order of the lots along each side, so every seed
drives past the same set of buildings and the work does not depend on it.

The street repeats every `period_m`, and the sensor advances `step_m` a
scan with no rotation: pose(i) is (i * step_m, 0, 0) and never wraps, so
every scan meets new ground.  Since the street repeats, scan i seen from
the sensor equals scan i % n with n = period_m / step_m (an integer), so
set-up makes n scans, each with its own range noise `noise_m`, and the
run cycles them.  The beams are scenes.beam_dirs' (the configuration's
`elevation_deg`, `rows` and `cols`); a beam that meets nothing within the
sensor's range (`min_depth` to `max_depth`, after the noise) has no
return.
"""
from __future__ import annotations

import math

import numpy as np
import torch

import scenes


def lots(traffic, gen, device):
    """Per side (+y, -y), the lots of one period: (setback f64[L], height
    f64[L], built bool[L]), each an evenly spread set in the seed's
    order."""
    n_lots = _whole(traffic["period_m"] / traffic["lot_m"], "period_m / lot_m")
    sides = []
    for _ in range(2):
        order = [torch.randperm(n_lots, generator=gen, device=device).cpu()
                 for _ in range(3)]
        setback = torch.linspace(*traffic["setback_m"], n_lots,
                                 dtype=torch.float64)[order[0]]
        height = torch.linspace(*traffic["height_m"], n_lots,
                                dtype=torch.float64)[order[1]]
        built = order[2] >= traffic["gaps"]
        sides.append((setback, height, built))
    return sides


def _whole(x, what):
    n = int(round(x))
    if n < 1 or abs(x - n) > 1e-9 * max(1.0, x):
        raise ValueError(f"lidar_street: {what} = {x} is not a whole number")
    return n


def boxes(traffic, sides, x0, reach, device):
    """The buildings within `reach` of x0 along the street, as box corners
    lo f64[B,3] and hi f64[B,3]."""
    lot, hw = traffic["lot_m"], traffic["half_width_m"]
    gz, depth = traffic["ground_z"], traffic["depth_m"]
    lo, hi = [], []
    for sign, (setback, height, built) in zip((1.0, -1.0), sides):
        n_lots = setback.shape[0]
        for k in range(math.floor((x0 - reach) / lot) - 1,
                       math.floor((x0 + reach) / lot) + 2):
            j = k % n_lots
            if not built[j]:
                continue
            near = hw + float(setback[j])
            ys = sorted((sign * near, sign * (near + depth)))
            lo.append((k * lot, ys[0], gz))
            hi.append(((k + 1) * lot, ys[1], gz + float(height[j])))
    f64 = dict(dtype=torch.float64, device=device)
    return torch.tensor(lo, **f64), torch.tensor(hi, **f64)


def ranges(d, org, lo, hi, ground_z):
    """Range along each unit beam d f64[...,3] from org to the first of the
    ground plane and the boxes (inf where it meets none)."""
    t = scenes._ground(d, org[2], ground_z)
    flat = d.reshape(-1, 3)
    safe = torch.where(flat.abs() > 1e-12, flat, torch.full_like(flat, 1e-12))
    o = torch.as_tensor(org, dtype=torch.float64, device=d.device)
    t1 = (lo[:, None, :] - o) / safe[None]
    t2 = (hi[:, None, :] - o) / safe[None]
    t_in = torch.minimum(t1, t2).amax(-1)
    t_out = torch.maximum(t1, t2).amin(-1)
    hit = (t_out >= t_in) & (t_in > 0)
    t_box = torch.where(hit, t_in, torch.full_like(t_in, math.inf)).amin(0)
    return torch.minimum(t, t_box.reshape(t.shape))


def make(traffic, sensor, gen, device):
    step = traffic["step_m"]
    n = _whole(traffic["period_m"] / step, "period_m / step_m")
    d = scenes.beam_dirs(sensor, device)
    sides = lots(traffic, gen, device)
    reach = float(sensor["max_depth"])
    scans = []
    for j in range(n):
        org = (j * step, 0.0, 0.0)
        lo, hi = boxes(traffic, sides, org[0], reach, device)
        t = ranges(d, org, lo, hi, traffic["ground_z"])
        t = t + traffic["noise_m"] * torch.randn(
            t.shape, generator=gen, dtype=t.dtype, device=device)
        t = torch.where((t >= sensor["min_depth"]) & (t <= reach), t, 0.0)
        scans.append((d * t[..., None]).reshape(-1, 3).to(torch.float32))
    points = torch.stack(scans).cpu().numpy()

    def pose(i):
        return (np.array([i * step, 0.0, 0.0], np.float32),
                np.array([0.0, 0.0, 0.0, 1.0], np.float32))
    return scenes.Frames("lidar", n, pose, points=list(points),
                         intrinsics=scenes.spherical_intrinsics(points[0],
                                                                sensor))
