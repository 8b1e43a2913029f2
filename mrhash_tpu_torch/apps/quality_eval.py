"""End-to-end reconstruction quality through the port: a frame loop ->
extractMesh -> eval_reconstruction's metrics against the analytic scene.

The port's counterpart of tools/quality_eval.py (same presets, scenes,
orbit, ground-truth samplers and recall-miss diagnosis), with its own numpy
copies of bench.synthetic_room_depth and the cluttered room's depth (rays
from the port's camera), and the port's GeoWrapper on `device` ("cuda" by
default).  At the Replica preset (1200x680, 1 cm voxels, 7 cm truncation,
2^19 blocks, then setHashNumBuckets(2^15)) a full 40-frame orbit of the 6 m
box room ("box"), or of the room with oblique boxes, spheres and a ramp
("clutter", optionally with variance coarsening), is fused, meshed and
scored against 2M ground-truth surface samples culled to what the orbit
observed.  It prints the metric rows; --json PATH writes them, with the
device's name, to PATH (never to QUALITY.json, which holds the JAX
package's rows).

    python -m mrhash_tpu_torch.apps.quality_eval --res replica \\
        [--scene clutter --multires] [--json rows.json] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from mrhash_tpu_torch import params as P

P_BLOCK = P.SDF_BLOCK_SIZE  # virtual voxels per block side

PRESETS = dict(
    # rows, cols, fx, voxel, truncation, num_blocks
    replica=(680, 1200, 600.0, 0.01, 0.07, 1 << 19),
    small=(120, 160, 80.0, 0.05, 0.15, 1 << 14),
)


def gt_box_points(half=3.0, n=2_000_000, seed=0):
    """Uniform samples of the box surface [-half, half]^3 (6 faces)."""
    rng = np.random.default_rng(seed)
    face = rng.integers(0, 6, n)
    u = rng.uniform(-half, half, n)
    v = rng.uniform(-half, half, n)
    s = np.where(face % 2 == 0, -half, half)
    pts = np.empty((n, 3), np.float64)
    ax = face // 2
    for a in range(3):
        m = ax == a
        o1, o2 = (a + 1) % 3, (a + 2) % 3
        pts[m, a] = s[m]
        pts[m, o1] = u[m]
        pts[m, o2] = v[m]
    return pts


def _check_shape(cam, rows, cols):
    if (cam.rows, cam.cols) != (rows, cols):
        raise ValueError(f"a {cam.rows}x{cam.cols} camera for a {rows}x{cols}"
                         " image")


def _unit_rays(cam):
    """f32[rows, cols, 3] unit camera-frame rays of every pixel of a CPU
    camera of the port (camera.cuh:84-103), as bench.py builds them from
    the JAX package's."""
    from mrhash_tpu_torch.ops import camera as C
    r = torch.arange(cam.rows, dtype=torch.float32)[:, None]
    c = torch.arange(cam.cols, dtype=torch.float32)[None, :]
    shape = (cam.rows, cam.cols)
    rays = C.inverse_projection(cam, r.expand(shape), c.expand(shape),
                                torch.ones(shape))
    return (rays / torch.linalg.norm(rays, dim=-1, keepdim=True)).numpy()


def synthetic_room_depth(rows, cols, cam, rng, half=3.0):
    """bench.py's box-room depth in numpy f32: world-space ray-box
    intersection consistent with the camera's pose, camera z stored, 3 mm
    noise drawn from `rng` as bench.py draws it."""
    _check_shape(cam, rows, cols)
    d_cam = _unit_rays(cam)
    rot = cam.rot.cpu().numpy()
    d_w = (d_cam[..., 0:1] * rot[:, 0] + d_cam[..., 1:2] * rot[:, 1]
           + d_cam[..., 2:3] * rot[:, 2])
    org = cam.trans.cpu().numpy()
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(d_w) > 1e-6, np.float32(1.0) / d_w,
                       np.float32(np.inf))
    t1 = (-half - org) * inv
    t2 = (half - org) * inv
    t_far = np.min(np.maximum(t1, t2), axis=-1)
    depth = t_far * d_cam[..., 2]
    noise = rng.normal(0, 0.003, (rows, cols)).astype(np.float32)
    return np.clip(depth + noise, 0.0, 29.0).astype(np.float32)


# --------------------------------------------------------------------------
# the cluttered room: the 6 m room plus oblique boxes, spheres and a ramp;
# depth images and ground truth come from the same closed-form geometry
# --------------------------------------------------------------------------

def _rot_xyz(ax, ay, az):
    cx_, sx = np.cos(ax), np.sin(ax)
    cy_, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx_, -sx], [0, sx, cx_]])
    Ry = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Ry @ Rx @ Rz).astype(np.float64)


# (kind, center, param, rotation): param = half-extents for "obb",
# radius for "sphere".  Placed strictly inside the room, pairwise disjoint.
CLUTTER_OBJECTS = (
    ("obb", np.array([1.5, -1.8, 0.8]), np.array([0.6, 0.8, 0.45]),
     _rot_xyz(np.deg2rad(20), np.deg2rad(30), 0.0)),           # oblique crate
    ("obb", np.array([-1.4, -2.0, -0.9]), np.array([1.1, 0.35, 0.8]),
     _rot_xyz(0.0, 0.0, np.deg2rad(15))),                      # tilted ramp
    ("sphere", np.array([0.6, -1.2, -2.0]), 0.9, None),
    ("sphere", np.array([-2.0, 0.6, 1.6]), 0.6, None),
)


def _ray_hits(org, d_w):
    """Nearest positive hit distance against the clutter objects for rays
    org + t*d_w (org [3], d_w [...,3] unit).  Returns t (inf = miss)."""
    t_best = np.full(d_w.shape[:-1], np.inf)
    for kind, c, p, R in CLUTTER_OBJECTS:
        if kind == "sphere":
            oc = org - c
            b = 2.0 * (d_w @ oc)
            cq = float(oc @ oc) - p * p
            disc = b * b - 4.0 * cq
            ok = disc > 0
            sq = np.sqrt(np.maximum(disc, 0.0))
            t0 = (-b - sq) / 2.0
            t = np.where(ok & (t0 > 0), t0, np.inf)
        else:
            o = (org - c) @ R            # into box frame (R world<-box cols)
            d = d_w @ R
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = np.where(np.abs(d) > 1e-9, 1.0 / d, np.inf)
            t1 = (-p - o) * inv
            t2 = (p - o) * inv
            tn = np.max(np.minimum(t1, t2), axis=-1)
            tf = np.min(np.maximum(t1, t2), axis=-1)
            t = np.where((tn <= tf) & (tn > 0), tn, np.inf)
        t_best = np.minimum(t_best, t)
    return t_best


def _clutter_z(cam):
    """The cluttered room's camera z for every pixel, f64, before noise
    and clipping."""
    d_cam = _unit_rays(cam).astype(np.float64)
    rot = cam.rot.cpu().numpy().astype(np.float64)
    d_w = d_cam @ rot.T
    org = cam.trans.cpu().numpy().astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(np.abs(d_w) > 1e-9, 1.0 / d_w, np.inf)
    t1 = (-3.0 - org) * inv
    t2 = (3.0 - org) * inv
    t_room = np.min(np.maximum(t1, t2), axis=-1)
    t = np.minimum(t_room, _ray_hits(org, d_w))
    return t * d_cam[..., 2]


def _clutter_finish(depth, rng=None):
    if rng is not None:
        depth = depth + rng.normal(0, 0.003, depth.shape) * (depth > 0)
    return np.clip(depth, 0.0, 29.0).astype(np.float32)


def clutter_scene_depth(rows, cols, cam, rng=None):
    """Analytic depth of the cluttered room for the camera pose (the ray
    construction of synthetic_room_depth; objects occlude walls), with
    3 mm noise on the hits when `rng` is given."""
    _check_shape(cam, rows, cols)
    return _clutter_finish(_clutter_z(cam), rng)


def _inside_any_object(pts, margin=0.0):
    inside = np.zeros(pts.shape[0], bool)
    for kind, c, p, R in CLUTTER_OBJECTS:
        if kind == "sphere":
            inside |= np.linalg.norm(pts - c, axis=1) < p + margin
        else:
            local = np.abs((pts - c) @ R)
            inside |= np.all(local < p + margin, axis=1)
    return inside


def gt_clutter_points(n=2_000_000, seed=0):
    """Uniform GT samples over the cluttered scene's surfaces: room walls
    (minus points inside objects) + object surfaces, area-weighted."""
    rng = np.random.default_rng(seed)
    areas = [6 * 6.0 ** 2]   # room walls
    for kind, c, p, R in CLUTTER_OBJECTS:
        if kind == "sphere":
            areas.append(4 * np.pi * p * p)
        else:
            areas.append(8 * (p[0] * p[1] + p[1] * p[2] + p[0] * p[2]))
    counts = (np.asarray(areas) / sum(areas) * n).astype(int)

    parts = [gt_box_points(3.0, counts[0], seed)]
    for (kind, c, p, R), m in zip(CLUTTER_OBJECTS, counts[1:]):
        if kind == "sphere":
            v = rng.normal(size=(m, 3))
            v /= np.linalg.norm(v, axis=1, keepdims=True)
            parts.append(c + p * v)
        else:
            face = rng.integers(0, 6, m)
            u = rng.uniform(-1, 1, m)
            w = rng.uniform(-1, 1, m)
            s = np.where(face % 2 == 0, -1.0, 1.0)
            loc = np.empty((m, 3))
            ax = face // 2
            for a in range(3):
                msk = ax == a
                o1, o2 = (a + 1) % 3, (a + 2) % 3
                loc[msk, a] = s[msk]
                loc[msk, o1] = u[msk]
                loc[msk, o2] = w[msk]
            parts.append(c + (loc * p) @ R.T)
    pts = np.concatenate(parts)
    # the objects are disjoint and inside the room; the strict-interior
    # filter (a negative margin keeps each object's own surface) guards
    # against placement edits
    return pts[~_inside_any_object(pts, margin=-1e-4)]


def cull_to_visible(gt, poses, cam0, rows, cols, tol=0.03, depths=None):
    """Occlusion-aware GT culling for the cluttered scene: a point counts
    as observed only if some frame sees it (its projected depth matches
    the analytic depth image at its pixel within tol).  `depths`, the
    noiseless depth image of each pose, saves recomputing them."""
    from mrhash_tpu_torch.ops import camera as C
    fx = float(cam0.fx)
    cx = float(cam0.cx)
    cy = float(cam0.cy)
    seen = np.zeros(gt.shape[0], bool)
    for i, (rot, t) in enumerate(poses):
        if depths is not None:
            dimg = depths[i]
        else:
            dimg = clutter_scene_depth(rows, cols,
                                       C.with_pose(cam0, rot, t))
        pc = (gt - t) @ rot
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            col = np.round(fx * pc[:, 0] / z + cx).astype(np.int64)
            row = np.round(fx * pc[:, 1] / z + cy).astype(np.int64)
        inb = (z > 0.01) & (row >= 0) & (col >= 0) & (row < rows) & (
            col < cols)
        rs = np.where(inb, row, 0)
        cs = np.where(inb, col, 0)
        seen |= inb & (np.abs(dimg[rs, cs] - z) < tol)
    return gt[seen]


def cull_to_observed(gt, poses, fx, cx, cy, rows, cols, max_depth):
    """Keep GT points that land inside at least one frame's frustum: the
    orbit never looks at the floor or the ceiling, and completeness
    against unobserved surface is a protocol artifact."""
    seen = np.zeros(gt.shape[0], bool)
    for rot, t in poses:
        pc = (gt - t) @ rot  # world -> cam (rot is cam-to-world)
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            col = fx * pc[:, 0] / z + cx
            row = fx * pc[:, 1] / z + cy
        seen |= ((z > 0.01) & (z < max_depth) & (row >= 0) & (col >= 0)
                 & (row < rows) & (col < cols))
    return gt[seen]


def orbit_pose(i, n):
    """The orbit: a turn about y by 2*pi*i/n with a small wobble; returns
    (rot f32[3,3] cam-to-world, trans f32[3])."""
    th = 2.0 * np.pi * i / n
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)]], np.float32)
    t = np.array([0.05 * np.sin(th), 0.02 * np.cos(th), 0.0], np.float32)
    return rot, t


def _map_blocks(gw):
    """Every block of the map, device-resident and in the host grid:
    (pos i32[n,3], res i32[n])."""
    table = gw.state.table
    occ = table.ptr != P.FREE_ENTRY
    pos = [table.pos[occ].cpu().numpy()]
    res = [table.res[occ].cpu().numpy()]
    gw.streamer.join()
    for g in gw.streamer.grid.chunks.values():
        pos.append(g["pos"])
        res.append(g["res"])
    return np.concatenate(pos), np.concatenate(res)


def recall_miss_diagnosis(gw, gt, est, vvs):
    """Bucket the GT points with no mesh within 5 cm by the resolution of
    the block that owns them in the final map (res 0, of those the ones
    with a res-1 face neighbour, res 1, or never allocated), separating a
    coarse region meshed poorly from a region never allocated.  The map is
    the device's blocks and the host grid's (PORT_NOTES.md P61)."""
    from mrhash_tpu_torch.apps import eval_utils
    d_gt = eval_utils.nn_distances(gt, est)
    missed = gt[d_gt > 0.05]
    pos_all, res_all = _map_blocks(gw)
    res_of = {tuple(p): int(r) for p, r in zip(pos_all, res_all)}
    bs = P_BLOCK * vvs
    keys = np.floor(missed / bs).astype(np.int64)
    buckets = {0: 0, 1: 0, -1: 0}
    boundary0 = 0
    nbrs = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
            (0, 0, -1)]
    for k in keys:
        r = res_of.get(tuple(k), -1)
        buckets[r] += 1
        if r == 0 and any(res_of.get((k[0] + dx, k[1] + dy, k[2] + dz), 0)
                          == 1 for dx, dy, dz in nbrs):
            boundary0 += 1
    diag = dict(missed_gt_points=int(missed.shape[0]),
                owner_res0=int(buckets[0]),
                owner_res0_res1_adjacent=int(boundary0),
                owner_res1=int(buckets[1]), unallocated=int(buckets[-1]),
                res1_blocks=int((res_all == 1).sum()),
                total_blocks=int(res_all.shape[0]))
    print(f"# recall-miss diagnosis: {diag['missed_gt_points']} GT points "
          f">5cm from mesh; owner res0={diag['owner_res0']} (of which "
          f"res1-adjacent {boundary0}) res1={diag['owner_res1']} "
          f"unallocated={diag['unallocated']}; map has "
          f"{diag['res1_blocks']}/{diag['total_blocks']} res-1 blocks",
          file=sys.stderr)
    return diag


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_quality(frames=40, res="replica", n_eval_points=2_000_000,
                mesh_path=None, json_path=None, scene="box", multires=False,
                extract_mode="sweep", var_threshold=1.0, min_weight=2,
                device="cuda", stats=None):
    """Integrate a full orbit of the scene ("box" = the empty 6 m room,
    "clutter" = the room with boxes, spheres and a ramp), extract the mesh
    (extract_mode "sweep": extractMesh, whose default is the host sweep;
    "resident": GeoWrapper._extract_resident over the device map), and
    evaluate it against the analytic GT.  multires=True turns variance
    coarsening on.  Returns the metric rows; `stats`, a dict, gains the
    seconds of the frames, the mesh, the PLY read and the eval, the vertex
    count, the last frame's occupancy and, with multires, the recall-miss
    diagnosis."""
    from mrhash_tpu_torch.apps import eval_utils
    from mrhash_tpu_torch.apps.eval_reconstruction import read_mesh_ply
    from mrhash_tpu_torch.geowrapper import GeoWrapper
    from mrhash_tpu_torch.ops import camera as C

    rows, cols, fx, vvs, trunc, num_blocks = PRESETS[res]
    stats = {} if stats is None else stats
    tmp = None
    if mesh_path is None:
        tmp = tempfile.TemporaryDirectory()
        mesh_path = os.path.join(tmp.name, "quality_mesh.ply")

    gw = GeoWrapper(sdf_truncation=trunc, sdf_truncation_scale=0.0,
                    integration_weight_sample=1, virtual_voxel_size=vvs,
                    n_frames_invalidate_voxels=0, voxel_extents_scale=1,
                    gs_optimization_param_path="", num_blocks=num_blocks,
                    sdf_var_threshold=var_threshold if multires else 0.0,
                    min_weight_threshold=min_weight, profiling=False,
                    device=device)
    if res == "replica":
        # the bench's bucket sizing (occupancy stays under ~60k blocks)
        gw.setHashNumBuckets(1 << 15)
    gw.setCamera(fx, fx, cols / 2 - 0.5, rows / 2 - 0.5, rows, cols,
                 0.01, 30.0)
    cam0 = C.make_camera(fx, fx, cols / 2 - 0.5, rows / 2 - 0.5, rows, cols,
                         0.01, 30.0)

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (rows, cols, 3)).astype(np.uint8)
    n = frames
    poses, clean = [], []
    scene_s = frames_s = 0.0
    for i in range(n):
        t0 = time.perf_counter()
        rot, t = orbit_pose(i, n)
        poses.append((rot, t))
        cam = C.with_pose(cam0, rot, t)
        if scene == "clutter":
            z = _clutter_z(cam)
            clean.append(_clutter_finish(z))
            depth = _clutter_finish(z, rng)
        else:
            depth = synthetic_room_depth(rows, cols, cam, rng)
        t1 = time.perf_counter()
        gw.setCurrPose(t, _rot_to_quat(rot))
        gw.setDepthImage(depth)
        gw.setRGBImage(rgb)
        gw.compute()
        _sync(device)
        t2 = time.perf_counter()
        scene_s += t1 - t0
        frames_s += t2 - t1
    occupied = gw.last_stats["occupied_blocks"]
    print(f"# integrated {n} frames in {frames_s:.1f}s (scene {scene_s:.1f}s)"
          f", occupied {occupied}", file=sys.stderr)

    t0 = time.perf_counter()
    if extract_mode == "resident":
        # the whole map is device-resident in this protocol (nothing
        # streamed): sweep it directly
        from mrhash_tpu_torch.core import mesh_post
        from mrhash_tpu_torch.utils import plyio
        tri_pos, tri_col = gw._extract_resident()
        m = mesh_post.MeshAccumulator()
        if tri_pos.shape[0]:
            m.add_triangles(tri_pos, tri_col)
        plyio.write_mesh_ply(mesh_path, m.vertices, m.faces, m.colors)
    else:
        gw.extractMesh(mesh_path)
    mesh_s = time.perf_counter() - t0
    print(f"# extract[{extract_mode}] took {mesh_s:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    verts, faces = read_mesh_ply(mesh_path)
    read_s = time.perf_counter() - t0
    if tmp is not None:
        tmp.cleanup()
    t0 = time.perf_counter()
    est = eval_utils.sample_mesh_points(verts, faces, n_eval_points)
    if scene == "clutter":
        gt = gt_clutter_points(n_eval_points)
        gt = cull_to_visible(gt, poses, cam0, rows, cols, depths=clean)
    else:
        gt = gt_box_points(3.0, n_eval_points)
        gt = cull_to_observed(gt, poses, fx, cols / 2 - 0.5, rows / 2 - 0.5,
                              rows, cols, 30.0)
    print(f"# observed GT points: {gt.shape[0]}/{n_eval_points}",
          file=sys.stderr)
    rows_m = eval_utils.evaluate_reconstruction(est, gt)
    eval_s = time.perf_counter() - t0
    for r in rows_m:
        print(json.dumps(r))
    stats.update(frames_s=frames_s, scene_s=scene_s, mesh_s=mesh_s,
                 read_s=read_s, eval_s=eval_s, occupied=int(occupied),
                 vertices=int(verts.shape[0]), faces=int(faces.shape[0]),
                 gt_points=int(gt.shape[0]))
    if multires:
        stats["recall_miss_diag"] = recall_miss_diagnosis(gw, gt, est, vvs)
    gw.close()

    if json_path:
        dev = torch.device(device)
        name = ("box_room_6m" if scene == "box" else "clutter_room_6m")
        entry = dict(scene=name, multires=bool(multires),
                     resolution=f"{cols}x{rows}", voxel=vvs, frames=n,
                     extract_mode=extract_mode,
                     device=(torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"),
                     metrics=rows_m, **stats)
        with open(json_path, "w") as f:
            json.dump(entry, f, indent=1)
    return rows_m


def _rot_to_quat(R):
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    if w > 1e-6:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        x, y, z = 1.0, 0.0, 0.0
    return np.array([x, y, z, w], np.float64)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--res", default="replica", choices=list(PRESETS))
    ap.add_argument("--n-eval-points", type=int, default=2_000_000)
    ap.add_argument("--scene", default="box", choices=("box", "clutter"))
    ap.add_argument("--multires", action="store_true")
    ap.add_argument("--var-threshold", type=float, default=1.0)
    ap.add_argument("--min-weight", type=int, default=2)
    ap.add_argument("--json", default="",
                    help="write the rows and figures to this path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run_quality(args.frames, args.res, args.n_eval_points,
                json_path=args.json or None, scene=args.scene,
                multires=args.multires, var_threshold=args.var_threshold, min_weight=args.min_weight,
                device=args.device)


if __name__ == "__main__":
    main()
