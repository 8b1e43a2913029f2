"""A handheld RGB-D camera walking laps of an office floor's corridor ring.

The corridor runs round a square building core: its centre line is a
square of `side_m` a side whose corners are arcs of `corner_r_m`, the
walls stand `width_m` / 2 either side of it, the floor lies `eye_m` below
the camera and the ceiling `height_m` above the floor.  Door recesses
`door_w_m` wide, `door_d_m` deep and `door_h_m` high open every
`door_every_m` along each straight, on alternating walls, and every side
is alike.  The world's y axis points down (the camera's rows), the floor
at y = eye_m.

The camera walks the centre line anticlockwise seen from above, looking
along it, with the orbit's wobble (`wobble_m`, across and up, over
`wobble_frames` frames) and depth noise `noise_m`.  The step is the one
nearest `step_m` that puts a whole number n of wobble periods on a side,
so frame i seen from the camera equals frame i % n of the first side
(the ring's fourfold symmetry): set-up renders those n frames on the
device, each with its own noise, and the run cycles them while pose(i)
goes on round the ring.  Depth beyond the sensor's max_depth is no
observation (0).  Colour is a function of the surface point taken to the
first side's frame, so that it keeps the symmetry.
"""
from __future__ import annotations

import math

import numpy as np
import torch

import scenes


def rot_y(theta):
    """Rotation f32[3,3] about y by theta (scenes.orbit_pose's)."""
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float64)


def side_path(traffic):
    """(the path length of one side in metres, frames a side, the step)."""
    a, r = traffic["side_m"] / 2.0, traffic["corner_r_m"]
    length = 2.0 * (a - r) + 0.5 * math.pi * r
    per = traffic["wobble_frames"]
    n = per * max(1, round(length / (traffic["step_m"] * per)))
    return length, n, length / n


def local_pose(traffic, s, j):
    """Camera position f64[3] and yaw on the first side at path length s,
    wobble phase of frame j: up the straight x = a along +z, then the
    corner's arc turning towards -x."""
    a, r = traffic["side_m"] / 2.0, traffic["corner_r_m"]
    straight = 2.0 * (a - r)
    if s < straight:
        p, yaw = np.array([a, 0.0, -(a - r) + s]), 0.0
    else:
        phi = (s - straight) / r
        p = np.array([a - r + r * math.cos(phi), 0.0,
                      a - r + r * math.sin(phi)])
        yaw = -phi
    ph = 2.0 * math.pi * (j % traffic["wobble_frames"]) / traffic[
        "wobble_frames"]
    wob = np.array([traffic["wobble_m"][0] * math.sin(ph),
                    traffic["wobble_m"][1] * math.cos(ph), 0.0])
    return p + rot_y(yaw) @ wob, yaw


def boxes(traffic):
    """The solids as axis-aligned boxes lo f64[B,3], hi f64[B,3]: the core,
    and on each side the walls' rims between the doors, the lintels above
    the doors and the solid beyond the outer wall."""
    a, half = traffic["side_m"] / 2.0, traffic["width_m"] / 2.0
    d, dw = traffic["door_d_m"], traffic["door_w_m"] / 2.0
    floor = traffic["eye_m"]
    ceil = floor - traffic["height_m"]
    lintel = floor - traffic["door_h_m"]
    xi, xo = a - half, a + half            # the inner and outer faces
    m = max(1, round(2.0 * (a - traffic["corner_r_m"])
                     / traffic["door_every_m"]))
    doors = (np.arange(m) - (m - 1) / 2.0) * traffic["door_every_m"]
    side = []                              # (x0, x1, z0, z1, y0, y1)
    for x0, x1, zlim, gaps in (
            (xi - d, xi, xi, doors[1::2]), (xo, xo + d, xo + d, doors[::2])):
        edges = [-zlim] + [e for c in gaps for e in (c - dw, c + dw)] + [zlim]
        for z0, z1 in zip(edges[::2], edges[1::2]):
            side.append((x0, x1, z0, z1, ceil, floor))
        for c in gaps:
            side.append((x0, x1, c - dw, c + dw, ceil, lintel))
    far = 4.0 * a
    side.append((xo + d, far, -far, far, ceil, floor))
    lo, hi = [(-(xi - d), ceil, -(xi - d))], [(xi - d, floor, xi - d)]
    for k in range(4):
        rot = rot_y(-0.5 * math.pi * k)
        for x0, x1, z0, z1, y0, y1 in side:
            c = np.array([[x, y, z] for x in (x0, x1) for y in (y0, y1)
                          for z in (z0, z1)]) @ rot.T
            lo.append(tuple(c.min(0)))
            hi.append(tuple(c.max(0)))
    return np.array(lo), np.array(hi)


def near_boxes(lo, hi, org, reach):
    """The boxes whose nearest point lies within `reach` of org: a ray
    meets no other before reach."""
    gap = np.maximum(np.maximum(lo - org, org - hi), 0.0)
    return np.linalg.norm(gap, axis=1) <= reach


def render(traffic, sensor, rays, rot, org, solids, noise, gen, device):
    """Depth f32[H,W] (camera z, noisy, 0 beyond max_depth) and colour
    u8[H,W,3] from camera rotation rot f64[3,3] at org f64[3]."""
    f32 = dict(dtype=torch.float32, device=device)
    d_cam = rays
    d_w = d_cam @ torch.as_tensor(rot, **f32).T
    o = torch.as_tensor(org, **f32)
    inv = torch.where(d_w.abs() > 1e-9, 1.0 / d_w,
                      torch.full_like(d_w, math.inf))
    dy = d_w[..., 1]
    floor = traffic["eye_m"]
    ceil = floor - traffic["height_m"]
    t = torch.where(dy > 1e-9, (floor - o[1]) / dy, math.inf)
    t = torch.minimum(t, torch.where(dy < -1e-9, (ceil - o[1]) / dy,
                                     math.inf))
    lo, hi = solids
    for b in range(lo.shape[0]):
        t1 = (torch.as_tensor(lo[b], **f32) - o) * inv
        t2 = (torch.as_tensor(hi[b], **f32) - o) * inv
        t_in = torch.minimum(t1, t2).amax(-1)
        t_out = torch.maximum(t1, t2).amin(-1)
        hit = (t_out >= t_in) & (t_in > 0)
        t = torch.where(hit, torch.minimum(t, t_in), t)
    p = o + t[..., None] * d_w
    # colour from the point taken to the first side's frame
    k = torch.remainder(torch.round(torch.atan2(p[..., 2], p[..., 0])
                                    / (0.5 * math.pi)), 4.0)
    ang = 0.5 * math.pi * k
    c, s = torch.cos(ang), torch.sin(ang)
    local = torch.stack([c * p[..., 0] + s * p[..., 2], p[..., 1],
                         -s * p[..., 0] + c * p[..., 2]], -1)
    rgb = scenes.texture_rgb(torch.nan_to_num(local, posinf=0.0,
                                              neginf=0.0))
    depth = t * d_cam[..., 2] + noise * torch.randn(
        t.shape, generator=gen, **f32)
    ok = torch.isfinite(depth) & (depth >= sensor["min_depth"]) & (
        depth <= sensor["max_depth"])
    return torch.where(ok, depth, 0.0), rgb


def make(traffic, sensor, gen, device):
    _, n, step = side_path(traffic)
    rows, cols = sensor["rows"], sensor["cols"]
    f32 = dict(dtype=torch.float32, device=device)
    r = torch.arange(rows, **f32)[:, None].expand(rows, cols)
    c = torch.arange(cols, **f32)[None, :].expand(rows, cols)
    ray = torch.stack([(c - sensor["cx"] - 0.5) / sensor["fx"],
                       (r - sensor["cy"] - 0.5) / sensor["fy"],
                       torch.ones((rows, cols), **f32)], -1)
    rays = ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)
    # a ray farther than this from the camera is deeper than max_depth
    corner = float(torch.linalg.vector_norm(ray, dim=-1).max())
    reach = sensor["max_depth"] * corner + 1.0
    lo, hi = boxes(traffic)
    depth, rgb, local = [], [], []
    for j in range(n):
        org, yaw = local_pose(traffic, j * step, j)
        local.append((org, yaw))
        near = near_boxes(lo, hi, org, reach)
        dj, cj = render(traffic, sensor, rays, rot_y(yaw), org,
                        (lo[near], hi[near]), traffic["noise_m"], gen, device)
        depth.append(dj.cpu().numpy())
        rgb.append(cj.cpu().numpy())

    def pose(i):
        k, j = (i // n) % 4, i % n
        org, yaw = local[j]
        theta = yaw - 0.5 * math.pi * k
        trans = rot_y(-0.5 * math.pi * k) @ org
        return (trans.astype(np.float32),
                np.array([0.0, math.sin(theta / 2), 0.0, math.cos(theta / 2)],
                         np.float32))
    return scenes.Frames("rgbd", n, pose, depth=depth, rgb=rgb)
