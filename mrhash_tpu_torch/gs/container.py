"""GaussianContainer: the glue between the TSDF map and the 3DGS model
(port of mrhash_tpu/gs/container.py).

Re-derivation of mrhash/src/sdf/gaussian_data_structures.{cuh,cpp,cu}: per
frame, quad-tree leaves over the RGB image seed new Gaussians at the
back-projected leaf centres whose TSDF voxel was observed exactly once
(weight == 1), with a scale from the leaf's footprint x depth / fx
(gaussian_data_structures.cu:4-83); then kf_iters (keyframe) or
non_kf_iters Adam steps of L1 loss on the current frame, plus a random
keyframe replay on non-keyframes (gaussian_data_structures.cpp:70-136).
optimize_final runs global passes of L1 + lambda * (1 - SSIM) over the
keyframes (:158-183).

Each frame reads the seed count once, inserts every seed, then runs the
frame's steps in a plain loop, as the CUDA original does (PORT_NOTES.md
P19, P20).
"""
from __future__ import annotations

import numpy as np
import torch

from mrhash_tpu_torch.gs import losses
from mrhash_tpu_torch.gs.model import GaussianModel, OptimizationParams
from mrhash_tpu_torch.gs.quadtree import build_qtree
from mrhash_tpu_torch.gs.rasterizer import render
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import meshing as M
from mrhash_tpu_torch.utils.profiler import stage

LOW_MEMORY_BYTES = 100 * 1024 * 1024


def _cam_dict(cam: C.Camera):
    """GS camera from the mapping camera (setupGSCamera,
    gaussian_data_structures.cpp:27-45): world-to-camera rotation and
    translation -(R^T t), summed in index order, and the pinhole."""
    R, t = cam.rot, cam.trans
    t_w2c = torch.stack([-(R[0, i] * t[0] + R[1, i] * t[1] + R[2, i] * t[2])
                         for i in range(3)])
    return dict(rot_w2c=R.T.contiguous(), t_w2c=t_w2c, fx=cam.fx, fy=cam.fy,
                cx=cam.cx, cy=cam.cy, W=cam.cols, H=cam.rows)


def check_nodes(cfg, table, pool, cam: C.Camera, leaves, leaf_valid,
                depth_img, rgb_img):
    """processNodesKernel (gaussian_data_structures.cu:4-83): keep the
    leaves whose back-projected centre lands in a voxel observed exactly
    once.  Returns (centers f32[L,3], colors u8[L,3], scales f32[L],
    ok bool[L])."""
    x, y, w, h = leaves.unbind(1)
    px = torch.trunc(x + 0.5 * w + 0.5).to(torch.int32)
    py = torch.trunc(y + 0.5 * h + 0.5).to(torch.int32)
    inside = (leaf_valid & (px >= 0) & (py >= 0) & (px < cam.cols)
              & (py < cam.rows))
    pxs = torch.where(inside, px, 0).to(torch.int64)
    pys = torch.where(inside, py, 0).to(torch.int64)
    depth = depth_img[pys, pxs]
    ok = inside & (depth >= cam.min_depth)

    center = C.cam_to_world(cam, C.inverse_projection(cam, pys, pxs, depth))
    _, weight, _, _, _ = M.get_voxel(cfg, table, pool, center)
    ok = ok & (weight == 1)

    scale = depth * torch.sqrt((0.5 * w) ** 2 + (0.5 * h) ** 2) / cam.fx
    ok = ok & (scale > 0.0)
    color = rgb_img[pys, pxs]
    return center, color, scale, ok


def seed_candidates(cfg, threshold, min_pixel_size, max_leaves, table, pool,
                    cam: C.Camera, depth_img, rgb_img):
    """Quad-tree + processNodes.  Returns (centers, colors, scales, ok,
    n_valid) with n_valid a Python int."""
    leaves, leaf_valid, _, _ = build_qtree(rgb_img, threshold,
                                           min_pixel_size, max_leaves)
    centers, colors, scales, ok = check_nodes(cfg, table, pool, cam, leaves,
                                              leaf_valid, depth_img, rgb_img)
    return centers, colors, scales, ok, int(ok.sum())


def _gt(gt_u8):
    return gt_u8.to(torch.float32).permute(2, 0, 1) / 255.0


class GaussianContainer:
    def __init__(self, optimization_param_path: str, capacity: int = 1 << 19,
                 qtree_capacity: int = 1 << 15, device="cpu"):
        self.device = torch.device(device)
        self.p = OptimizationParams(optimization_param_path or None)
        self.model = GaussianModel(self.p, capacity, self.device)
        self.qtree_capacity = qtree_capacity
        # keyframe ring of (cam_dict, gt u8[H,W,3]), bounded at
        # p.max_keyframes, the oldest overwritten
        self.keyframes: list[tuple] = []
        self._kf_next = 0
        self._rng = np.random.default_rng(0)

    # ------------------------------------------------------------------ steps
    def _step(self, cam_d, gt_u8, max_per_tile, final=False):
        """One Adam step on one view: render, loss, backward, update.  The
        loss is L1, or L1 + lambda * (1 - SSIM) when `final`."""
        m = self.model
        with stage("gs.render"):
            img, _, _ = render(m.params(), cam_d, m.background,
                               self.p.sh_degree, max_per_tile=max_per_tile)
            gt = _gt(gt_u8)
            loss = losses.l1_loss(img, gt)
            if final:
                lam = self.p.lambda_dssim
                loss = (1.0 - lam) * loss + lam * (1.0 - losses.ssim(img, gt))
        with stage("gs.backward"):
            m.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with stage("gs.adam"):
            m.optimizer.step()

    def train_steps(self, views):
        """One L1 Adam step per (cam_dict, gt u8[H,W,3]) view, in order,
        at the online training blend cap (train_max_per_tile)."""
        cap = int(self.p.train_max_per_tile)
        for cam_d, gt_u8 in views:
            self._step(cam_d, gt_u8, cap)

    # ------------------------------------------------------------------ frame
    def run_gs(self, cfg, cam: C.Camera, state, rgb_img, depth_img):
        """runGS (gaussian_data_structures.cpp:138-156), with the
        low-memory skip guard (:144-151: under 100 MB free, skip the
        frame).  rgb_img u8[H,W,3] and depth_img f32[H,W] on the device."""
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            if free < LOW_MEMORY_BYTES:
                print("GaussianContainer::runGS | low device memory, "
                      "skipping GS frame")
                return
        rgb = torch.as_tensor(rgb_img, dtype=torch.uint8, device=self.device)
        depth = torch.as_tensor(depth_img, dtype=torch.float32,
                                device=self.device)
        cam_d = _cam_dict(cam)

        with stage("gs.seed"):
            centers, colors, scales, ok, n_valid = seed_candidates(
                cfg, self.p.qtree_thresh, self.p.qtree_min_pixel_size,
                self.qtree_capacity, state.table, state.pool, cam, depth, rgb)
        m = self.model
        with stage("gs.insert"):
            m.add_gaussians_device(centers, colors, scales, ok, n_valid)
        if m.count == 0:
            return

        is_keyframe = n_valid > self.p.kf_thresh
        if is_keyframe or self.p.keep_all_frames:
            if len(self.keyframes) < int(self.p.max_keyframes):
                self.keyframes.append((cam_d, rgb))
            else:
                self.keyframes[self._kf_next] = (cam_d, rgb)
                self._kf_next = (self._kf_next + 1) % len(self.keyframes)

        iters = self.p.kf_iters if is_keyframe else self.p.non_kf_iters
        views = [(cam_d, rgb)] * iters
        if not is_keyframe and self.keyframes:
            k = min(self.p.random_kf_num, len(self.keyframes))
            views += [self.keyframes[i]
                      for i in self._rng.permutation(len(self.keyframes))[:k]]
        with stage("gs.steps"):
            self.train_steps(views)

    # ------------------------------------------------------------------ final
    def optimize_final(self):
        """optimizeGSFinal (gaussian_data_structures.cpp:158-183): global
        passes of L1 + lambda * (1 - SSIM) over all keyframes, at the full
        blend cap."""
        if not self.keyframes or self.model.count == 0:
            return
        for _ in range(self.p.global_iters):
            for cam_d, gt_u8 in self.keyframes:
                self._step(cam_d, gt_u8, 128, final=True)

    @torch.no_grad()
    def render_view(self, cam: C.Camera):
        m = self.model
        img, _, _ = render(m.params(), _cam_dict(cam), m.background,
                           self.p.sh_degree)
        return img

    def save_ply(self, folder, iteration=0, blocking=False):
        return self.model.save_ply(folder, iteration, blocking=blocking)
