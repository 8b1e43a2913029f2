"""GaussianModel: the Gaussian parameter store and its per-group Adam (port
of mrhash_tpu/gs/model.py).

Re-derivation of mrhash/src/gs/gaussian.{cuh,cu}: parameters xyz,
scaling (log), rotation (quaternion, w first), opacity (inverse sigmoid),
f_dc and f_rest (SH), per-group Adam learning rates (gaussian.cu:213-238,
eps 1e-15), insertion of new Gaussians (cat_tensors_to_optimizer,
:284-306) and PLY export (:260-282).

`capacity` rows are allocated once and the first `count` are live
(PORT_NOTES.md P18): render takes `params(count)`, so the rows past
`count` get zero gradients and keep zero Adam moments, and a Gaussian
inserted into such a row joins its group at the group's current step with
zero moments, as a row appended by the reference's concatenation does.
"""
from __future__ import annotations

import json
import math
import os
import threading

import numpy as np
import torch
from torch import nn

from mrhash_tpu_torch.gs.rasterizer import rgb2sh

NAMES = ("xyz", "scaling", "rotation", "opacity", "f_dc", "f_rest")


class OptimizationParams:
    """configurations/params.json schema (gaussian.cu:21-59)."""

    DEFAULTS = dict(sh_degree=3, position_lr=0.00016, feature_lr=0.0025,
                    opacity_lr=0.05, scaling_lr=0.001, rotation_lr=0.001,
                    lambda_dssim=0.2, qtree_thresh=0.1,
                    qtree_min_pixel_size=1, kf_thresh=50, kf_iters=5,
                    non_kf_iters=3, random_kf_num=2, global_iters=10,
                    keep_all_frames=False,
                    # keyframe store bound: a ring, the oldest overwritten
                    # (the reference appends without limit)
                    max_keyframes=256,
                    # per-tile blend cap of the online training renders;
                    # optimize_final and render_view keep 128
                    train_max_per_tile=64)

    def __init__(self, path=None):
        vals = dict(self.DEFAULTS)
        if path:
            with open(path) as f:
                vals.update(json.load(f))
        for k, v in vals.items():
            setattr(self, k, v)


def inverse_sigmoid(x):
    return math.log(x / (1.0 - x))


class GaussianModel(nn.Module):
    """Six nn.Parameters of `capacity` rows, `count` of them live, and a
    torch.optim.Adam with one parameter group per tensor."""

    def __init__(self, optim_params: OptimizationParams,
                 capacity: int = 1 << 20, device="cpu"):
        super().__init__()
        self.p = optim_params
        self.capacity = int(capacity)
        n = self.capacity
        self.n_rest = (self.p.sh_degree + 1) ** 2 - 1
        z = dict(dtype=torch.float32, device=device)
        rotation = torch.zeros((n, 4), **z)
        rotation[:, 0] = 1.0
        self.xyz = nn.Parameter(torch.zeros((n, 3), **z))
        self.scaling = nn.Parameter(torch.zeros((n, 3), **z))
        self.rotation = nn.Parameter(rotation)
        self.opacity = nn.Parameter(torch.zeros((n, 1), **z))
        self.f_dc = nn.Parameter(torch.zeros((n, 1, 3), **z))
        self.f_rest = nn.Parameter(torch.zeros((n, self.n_rest, 3), **z))
        self.count = 0
        self.background = torch.zeros(3, **z)
        lrs = dict(xyz=self.p.position_lr, f_dc=self.p.feature_lr,
                   f_rest=self.p.feature_lr / 20.0,
                   scaling=self.p.scaling_lr, rotation=self.p.rotation_lr,
                   opacity=self.p.opacity_lr)
        self.optimizer = torch.optim.Adam(
            [{"params": [getattr(self, k)], "lr": lrs[k], "name": k}
             for k in NAMES], eps=1e-15)
        self._ply_thread = None

    def params(self, n=None):
        """The first n rows (default: the live ones) of every parameter."""
        n = self.count if n is None else n
        return {k: getattr(self, k)[:n] for k in NAMES}

    # ------------------------------------------------------------------ insert
    @torch.no_grad()
    def _write_rows(self, pos, col, sc):
        """Initialise rows count..count+n (model.py:136-156 of the JAX
        package): isotropic log-scale, identity quaternion, opacity
        inverse_sigmoid(0.5), DC SH from the colour, zero SH rest."""
        a, n = self.count, pos.shape[0]
        b = a + n
        self.xyz[a:b] = pos
        self.scaling[a:b] = torch.log(sc)[:, None].expand(n, 3)
        self.rotation[a:b] = torch.tensor([1.0, 0.0, 0.0, 0.0],
                                          device=pos.device)
        self.opacity[a:b] = inverse_sigmoid(0.5)
        self.f_dc[a:b] = rgb2sh(col / 255.0)[:, None, :]
        self.f_rest[a:b] = 0.0
        self.count = b

    def _room(self, n):
        if self.count + n > self.capacity:
            n = self.capacity - self.count
            if n <= 0:
                print("GaussianModel | capacity exceeded, dropping gaussians")
        return max(n, 0)

    def add_gaussians(self, positions, colors_u8, scales):
        """Add_gaussians (gaussian.cu:147-211) from host arrays."""
        n = self._room(positions.shape[0])
        if n == 0:
            return
        dev = self.xyz.device
        self._write_rows(
            torch.as_tensor(np.asarray(positions[:n], np.float32), device=dev),
            torch.as_tensor(np.asarray(colors_u8[:n], np.float32), device=dev),
            torch.as_tensor(np.asarray(scales[:n], np.float32), device=dev))

    def add_gaussians_device(self, centers, colors, scales, ok, n_valid):
        """Add the ok candidates of the seeding (device tensors; colours
        u8) in candidate order; scales clamp at 1e-12 as in the reference's
        device insert."""
        n = self._room(int(n_valid))
        if n == 0:
            return
        sel = torch.nonzero(ok).flatten()[:n]
        self._write_rows(centers[sel], colors[sel].to(torch.float32),
                         torch.clamp(scales[sel], min=1e-12))

    # ------------------------------------------------------------------ state
    @torch.no_grad()
    def load_reference(self, params_np, count, opt_state_np=None):
        """Continue from the JAX model: params_np maps each name to its
        numpy array (at least `count` rows); opt_state_np optionally maps
        each name to optax's Adam state of its group, a dict with mu, nu
        (same shapes as the parameter) and count.  The first `count` rows
        and their moments are copied; the other rows keep their initial
        values and zero moments."""
        if count > self.capacity:
            raise ValueError(f"count {count} > capacity {self.capacity}")
        dev = self.xyz.device
        for k in NAMES:
            getattr(self, k)[:count] = torch.tensor(
                np.asarray(params_np[k][:count], np.float32), device=dev)
        self.count = int(count)
        self.optimizer.state.clear()
        if opt_state_np is None:
            return
        for k in NAMES:
            p = getattr(self, k)
            st = opt_state_np[k]
            mu = torch.zeros_like(p)
            nu = torch.zeros_like(p)
            mu[:count] = torch.tensor(np.asarray(st["mu"][:count],
                                                 np.float32), device=dev)
            nu[:count] = torch.tensor(np.asarray(st["nu"][:count],
                                                 np.float32), device=dev)
            self.optimizer.state[p] = {
                "step": torch.tensor(float(st["count"]), dtype=torch.float32),
                "exp_avg": mu, "exp_avg_sq": nu}

    # ------------------------------------------------------------------ PLY
    def save_ply(self, path, iteration=0, blocking=False):
        """Save_ply (gaussian.cu:260-282): binary PLY with the Inria
        attribute layout.  The live rows are copied to the host here; the
        file is written by a background thread, as the reference's detached
        writer is (gaussian.cu:274-281).  blocking=True, or wait_ply(),
        joins it."""
        n = self.count
        # a copy: on the CPU, .cpu() would share the live parameters' memory
        p = {k: v.detach().cpu().numpy().copy()
             for k, v in self.params(n).items()}
        os.makedirs(path, exist_ok=True)
        fname = os.path.join(path, f"point_cloud_{iteration}.ply")
        self.wait_ply()
        t = threading.Thread(target=_write_ply, args=(fname, n, p))
        t.start()
        self._ply_thread = t
        if blocking:
            self.wait_ply()
        return fname

    def wait_ply(self):
        """Join an in-flight background PLY write (no-op if none)."""
        if self._ply_thread is not None:
            self._ply_thread.join()
            self._ply_thread = None


def _write_ply(fname, n, p):
    n_rest = p["f_rest"].shape[1]
    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(3 * n_rest)]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    cols = np.concatenate([
        p["xyz"], np.zeros((n, 3), np.float32),
        p["f_dc"].transpose(0, 2, 1).reshape(n, -1),
        p["f_rest"].transpose(0, 2, 1).reshape(n, -1),
        p["opacity"], p["scaling"], p["rotation"]], axis=1)
    rec = np.rec.fromarrays(
        [cols[:, i].astype("<f4") for i in range(cols.shape[1])],
        names=",".join(names))
    with open(fname, "wb") as fh:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}"]
        header += [f"property float {nm}" for nm in names]
        header += ["end_header", ""]
        fh.write("\n".join(header).encode())
        rec.tofile(fh)
