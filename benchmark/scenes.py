"""The one traffic generator: a traffic mix (traffic/<mix>.json) names a
scene kind and its parameters; `make` turns it, the configuration's
sensor and a seed into the frames and poses a run hands to the program,
as host arrays (a camera's frames arrive in host memory).

The scenes are chip_smoke.py's, in plain torch so that set-up makes them
on the card in a few large calls:

- `box_orbit`: the box room seen from inside (chip_smoke.py::room_depth),
  on a `orbit`-pose orbit about the vertical axis with a small wobble
  (::orbit_pose); depth noise per frame, colour from the world position
  (::texture_rgb).  `laps` laps of fresh noise make the distinct frames,
  cycled by the run.
- `lidar_loop`: chip_smoke.py::lidar_cloud's beams, over the sensor's
  vertical field of view, meeting a ground plane and a cylinder wall of
  radius `wall_r`; the sensor circles `circle_r` about the axis at
  `step_m` per scan, one lap of scans, cycled.

A kind not in SCENES is a file of its own, `scene_kinds/<kind>.py` beside
this module, whose `make(traffic, sensor, gen, device)` returns Frames: a
later scene is added as a new file, as a per-layer metric is.

Every draw comes from one torch.Generator seeded with --seed, so the same
seed gives the same inputs; the sizes and poses do not depend on it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math
import os
import re

import numpy as np
import torch


@dataclasses.dataclass
class Frames:
    """A run's inputs.  Frame i is (translation f32[3], quaternion x,y,z,w
    f32[4]) from `pose(i)` and, for RGB-D, depth[i % n] f32[H,W] with
    rgb[i % n] u8[H,W,3], or for LiDAR points[i % n] f32[N,3] in the sensor
    frame (a zero point is no return)."""
    kind: str                       # "rgbd" or "lidar"
    n: int                          # distinct frames, cycled
    pose: object                    # i -> (trans, quat)
    depth: list = None
    rgb: list = None
    points: list = None
    intrinsics: tuple = None        # LiDAR: (fx, fy, cx, cy) fit to scan 0

    def inputs(self, i):
        if self.kind == "rgbd":
            return self.depth[i % self.n], self.rgb[i % self.n]
        return self.points[i % self.n]


HERE = os.path.dirname(os.path.abspath(__file__))
KIND_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def kind_module(kind: str, base: str = HERE):
    """The module `<base>/scene_kinds/<kind>.py` of a scene kind that
    SCENES does not hold."""
    path = os.path.join(base, "scene_kinds", f"{kind}.py")
    if not KIND_NAME.fullmatch(kind) or not os.path.isfile(path):
        raise ValueError(f"unknown scene {kind!r}: not one of "
                         f"{sorted(SCENES)} and no file {path}")
    spec = importlib.util.spec_from_file_location(f"scene_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make(traffic: dict, sensor: dict, seed: int, device="cuda",
         base: str = HERE) -> Frames:
    kind = traffic["scene"]
    gen_frames = (SCENES[kind] if kind in SCENES
                  else kind_module(kind, base).make)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen_frames(traffic, sensor, gen, torch.device(device))


# ---------------------------------------------------------------------------
# RGB-D
# ---------------------------------------------------------------------------

def orbit_pose(i, orbit, wobble):
    """Rotation about y by 2 pi (i % orbit) / orbit, the translation's small
    wobble; returns (rot f32[3,3], trans f32[3], quat f32[4])."""
    th = 2.0 * np.pi * (i % orbit) / orbit
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)]], np.float32)
    trans = np.array([wobble[0] * np.sin(th), wobble[1] * np.cos(th), 0.0],
                     np.float32)
    quat = np.array([0.0, np.sin(th / 2), 0.0, np.cos(th / 2)], np.float32)
    return rot, trans, quat


def texture_rgb(pw):
    """A multi-view-consistent colour u8[...,3] of the world point."""
    x, y, z = pw[..., 0], pw[..., 1], pw[..., 2]
    r = 0.5 + 0.45 * torch.sin(2.1 * x) * torch.cos(1.3 * y)
    g = 0.5 + 0.45 * torch.sin(1.7 * y + 0.8) * torch.cos(2.3 * z)
    b = 0.5 + 0.45 * torch.sin(1.1 * z + 1.9) * torch.cos(1.9 * x)
    return (torch.stack([r, g, b], -1) * 255.0).to(torch.uint8)


def room_frame(rot, trans, half, noise, sensor, gen, device):
    """Depth f32[H,W] (camera z, noisy) and colour u8[H,W,3] of the box
    room [-half, half]^3 seen from inside at (rot, trans)."""
    rows, cols = sensor["rows"], sensor["cols"]
    f32 = dict(dtype=torch.float32, device=device)
    r = torch.arange(rows, **f32)[:, None].expand(rows, cols)
    c = torch.arange(cols, **f32)[None, :].expand(rows, cols)
    ray = torch.stack([(c - sensor["cx"] - 0.5) / sensor["fx"],
                       (r - sensor["cy"] - 0.5) / sensor["fy"],
                       torch.ones((rows, cols), **f32)], -1)
    d_cam = ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)
    d_w = d_cam @ torch.as_tensor(rot, **f32).T
    t = torch.as_tensor(trans, **f32)
    inv = torch.where(d_w.abs() > 1e-6, 1.0 / d_w,
                      torch.full_like(d_w, math.inf))
    t_far = torch.minimum(torch.maximum((-half - t) * inv, (half - t) * inv),
                          torch.full_like(d_w, math.inf)).amin(-1)
    rgb = texture_rgb(t + t_far[..., None] * d_w)
    depth = t_far * d_cam[..., 2] + noise * torch.randn(
        (rows, cols), generator=gen, **f32)
    return depth.clamp(0.0, sensor["max_depth"] - 1.0), rgb


def box_orbit(traffic, sensor, gen, device):
    orbit, wobble = traffic["orbit"], traffic["wobble_m"]
    n = orbit * traffic["laps"]
    depth, rgb = [], []
    for j in range(n):
        rot, trans, _ = orbit_pose(j, orbit, wobble)
        d, c = room_frame(rot, trans, traffic["half_m"], traffic["noise_m"],
                          sensor, gen, device)
        depth.append(d)
        rgb.append(c)
    depth = torch.stack(depth).cpu().numpy()
    rgb = torch.stack(rgb).cpu().numpy()

    def pose(i):
        _, trans, quat = orbit_pose(i, orbit, wobble)
        return trans, quat
    return Frames("rgbd", n, pose, depth=list(depth), rgb=list(rgb))


# ---------------------------------------------------------------------------
# LiDAR
# ---------------------------------------------------------------------------

def beam_dirs(sensor, device):
    """Unit beam directions f64[rows, cols, 3]: elevations evenly over the
    sensor's `elevation_deg`, `cols` azimuths over the full turn (z up)."""
    f64 = dict(dtype=torch.float64, device=device)
    lo, hi = (math.radians(a) for a in sensor["elevation_deg"])
    el = torch.linspace(lo, hi, sensor["rows"], **f64)[:, None]
    az = torch.arange(sensor["cols"], **f64)[None, :] * (
        2 * math.pi / sensor["cols"]) - math.pi
    return torch.stack([torch.cos(el) * torch.cos(az),
                        torch.cos(el) * torch.sin(az),
                        torch.sin(el).expand(-1, sensor["cols"])], -1)


def _scan(d, t, noise, gen):
    """The beams' points f32[rows*cols, 3] at ranges t (inf: no return),
    with range noise."""
    hit = torch.isfinite(t)
    t = torch.where(hit, t, torch.zeros_like(t))
    t = t + noise * torch.randn(t.shape, generator=gen, dtype=t.dtype,
                                device=t.device) * hit
    return (d * t[..., None]).reshape(-1, 3).to(torch.float32)


def _ground(d, org_z, ground_z):
    dz = d[..., 2]
    return torch.where(dz < -1e-4, (ground_z - org_z) / dz,
                       torch.full_like(dz, math.inf))


def lidar_loop(traffic, sensor, gen, device):
    d = beam_dirs(sensor, device)
    n = int(round(2 * math.pi * traffic["circle_r"] / traffic["step_m"]))
    orgs = [(traffic["circle_r"] * math.cos(2 * math.pi * i / n),
             traffic["circle_r"] * math.sin(2 * math.pi * i / n))
            for i in range(n)]
    wall2 = traffic["wall_r"] ** 2
    scans = []
    for ox, oy in orgs:
        dx, dy = d[..., 0], d[..., 1]
        a = dx * dx + dy * dy
        b = 2 * (ox * dx + oy * dy)
        disc = torch.clamp(b * b - 4 * a * (ox * ox + oy * oy - wall2), min=0)
        tc = torch.where(a > 1e-9, (-b + torch.sqrt(disc)) / (2 * a.clamp(
            min=1e-9)), torch.full_like(a, math.inf))
        t = torch.minimum(_ground(d, 0.0, traffic["ground_z"]), tc)
        scans.append(_scan(d, t, traffic["noise_m"], gen))
    points = torch.stack(scans).cpu().numpy()

    def pose(i):
        ox, oy = orgs[i % n]
        return (np.array([ox, oy, 0.0], np.float32),
                np.array([0.0, 0.0, 0.0, 1.0], np.float32))
    return Frames("lidar", n, pose, points=list(points),
                  intrinsics=spherical_intrinsics(points[0], sensor))


def spherical_intrinsics(points, sensor):
    """(fx, fy, cx, cy) fit to a scan's angular span, as the LiDAR
    runners do (mrhash/apps/utils/camera.py:32-57)."""
    p = points[(points != 0).any(axis=1)]
    az = np.arctan2(p[:, 1], p[:, 0])
    el = np.arctan2(p[:, 2], np.linalg.norm(p[:, :2], axis=1))
    fx = -float(sensor["cols"] - 1) / float(np.max(az) - np.min(az))
    fy = -float(sensor["rows"] - 1) / float(np.max(el) - np.min(el))
    return (np.float32(fx), np.float32(fy), np.float32(sensor["cols"] / 2),
            np.float32(sensor["rows"] / 2))


SCENES = {"box_orbit": box_orbit, "lidar_loop": lidar_loop}
