"""Differentiable tile-based Gaussian rasterizer (port of
mrhash_tpu/gs/rasterizer.py).

preprocess (SH -> RGB, cov3D, EWA cov2D, conic, 3-sigma radius;
forward.cu:21-241), the (Gaussian, tile) pair expansion (dense 8x8 slots or
the exact-count compact form; rasterizer_impl.cu:65-96), one stable sort by
(tile, depth), the per-tile ranges, the gather of each tile's front-most
`max_per_tile` Gaussians, and the tile blend through kernels K4/K5
(gs/blend.py).

Every 3x3 and 2x3 product is written out elementwise, summed in index
order, instead of einsum/matmul: that keeps TF32 off the path on the card
and fixes the order of summation on every device.

`render` takes the live rows only: the caller passes the first `count`
rows of its preallocated store (PORT_NOTES.md P18), so there is no
`active` mask.  It returns the tile-pair overflow count as a tensor
(compact pairs drop ranks past `pair_cap`; the dense form never drops).
"""
from __future__ import annotations

import torch

from mrhash_tpu_torch.gs import blend as B

BLOCK = B.BLOCK
MAX_TILES_SIDE = 8              # per-Gaussian tile rect cap (8x8 tiles)
# above this pair count, pairs="auto" switches from the dense 64-slot form
# to the exact-count compact one (the reference's switch point)
PAIRS_AUTO_DENSE_MAX = 8 << 20

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def rgb2sh(rgb):
    return (rgb - 0.5) / SH_C0


def eval_sh(deg, sh, dirs):
    """computeColorFromSH (forward.cu:21-59).  sh f32[G,(deg+1)^2,3], dirs
    f32[G,3] unit.  Returns clamped-positive RGB f32[G,3]."""
    result = SH_C0 * sh[:, 0]
    if deg > 0:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        result = (result - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2]
                  - SH_C1 * x * sh[:, 3])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result + SH_C2[0] * xy * sh[:, 4]
                      + SH_C2[1] * yz * sh[:, 5]
                      + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
                      + SH_C2[3] * xz * sh[:, 7]
                      + SH_C2[4] * (xx - yy) * sh[:, 8])
            if deg > 2:
                result = (result
                          + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
                          + SH_C3[1] * xy * z * sh[:, 10]
                          + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
                          + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy)
                          * sh[:, 12]
                          + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
                          + SH_C3[5] * z * (xx - yy) * sh[:, 14]
                          + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp(result + 0.5, min=0.0)


def quat_to_rot(q):
    """build_rotation with the reference's (w, x, y, z) layout and no
    normalization (forward.cu:106-121).  Returns f32[...,3,3]."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                     2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def compute_cov3d(scale, quat, modifier=1.0):
    """computeCov3D (forward.cu:97-135): Sigma = M^T M with M = S R (rows
    of R scaled).  Returns f32[G,3,3]."""
    M = scale[..., :, None] * quat_to_rot(quat) * modifier

    def entry(j, k):
        return (M[:, 0, j] * M[:, 0, k] + M[:, 1, j] * M[:, 1, k]
                + M[:, 2, j] * M[:, 2, k])
    return torch.stack([torch.stack([entry(j, k) for k in range(3)], -1)
                        for j in range(3)], -2)


def compute_cov2d(p_view, fx, fy, tan_fovx, tan_fovy, cov3d, rot_w2c):
    """computeCov2D, EWA + 0.3 low-pass (forward.cu:62-92).  p_view
    f32[G,3] camera-frame points; rot_w2c f32[3,3].  Returns the (a, b, c)
    of the symmetric 2x2, each f32[G]."""
    tz = p_view[:, 2]
    tzs = torch.where(tz == 0, 1e-6, tz)
    txtz = torch.clamp(p_view[:, 0] / tzs, -1.3 * tan_fovx, 1.3 * tan_fovx)
    tytz = torch.clamp(p_view[:, 1] / tzs, -1.3 * tan_fovy, 1.3 * tan_fovy)
    tx = txtz * tz
    ty = tytz * tz
    z2 = tzs * tzs
    zero = torch.zeros_like(tz)
    J = ((fx / tzs, zero, -(fx * tx) / z2), (zero, fy / tzs, -(fy * ty) / z2))
    W = rot_w2c
    # T = J W  [2,3]
    T = [[J[i][0] * W[0, j] + J[i][1] * W[1, j] + J[i][2] * W[2, j]
          for j in range(3)] for i in range(2)]
    # U = T Sigma  [2,3]; cov = U T^T  [2,2]
    U = [[T[i][0] * cov3d[:, 0, k] + T[i][1] * cov3d[:, 1, k]
          + T[i][2] * cov3d[:, 2, k] for k in range(3)] for i in range(2)]

    def cov(i, m):
        return U[i][0] * T[m][0] + U[i][1] * T[m][1] + U[i][2] * T[m][2]
    return cov(0, 0) + 0.3, cov(0, 1), cov(1, 1) + 0.3


def preprocess(params, cam, sh_degree):
    """preprocessCUDA (forward.cu:139-241) over the live rows.  cam: dict
    (rot_w2c f32[3,3], t_w2c f32[3], fx, fy, cx, cy as floats or 0-d
    tensors, W, H).  Returns per-Gaussian attributes and validity."""
    xyz = params["xyz"]
    R, t = cam["rot_w2c"], cam["t_w2c"]
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    p_view = torch.stack([x * R[i, 0] + y * R[i, 1] + z * R[i, 2] + t[i]
                          for i in range(3)], -1)
    depth = p_view[:, 2]
    in_front = depth > 0.2

    zs = torch.where(depth == 0, 1e-6, depth)
    px = cam["fx"] * p_view[:, 0] / zs + cam["cx"] - 0.5
    py = cam["fy"] * p_view[:, 1] / zs + cam["cy"] - 0.5
    point_image = torch.stack([px, py], -1)

    scale = torch.exp(params["scaling"])
    cov3d = compute_cov3d(scale, params["rotation"])
    tan_fovx = cam["W"] / (2.0 * cam["fx"])
    tan_fovy = cam["H"] / (2.0 * cam["fy"])
    a, b, c = compute_cov2d(p_view, cam["fx"], cam["fy"], tan_fovx, tan_fovy,
                            cov3d, R)
    det = a * c - b * b
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, 1.0)
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], -1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lam, mid - torch.sqrt(
        torch.clamp(mid * mid - det, min=0.1)))))

    # camera centre -(t_w2c @ rot_w2c)
    center = [-(t[0] * R[0, j] + t[1] * R[1, j] + t[2] * R[2, j])
              for j in range(3)]
    dirs = torch.stack([xyz[:, j] - center[j] for j in range(3)], -1)
    n2 = (dirs[:, 0] * dirs[:, 0] + dirs[:, 1] * dirs[:, 1]
          + dirs[:, 2] * dirs[:, 2])[:, None]
    dirs = dirs * torch.rsqrt(torch.where(n2 > 0, n2, 1.0))
    sh = torch.cat([params["f_dc"], params["f_rest"]], dim=1)
    rgb = eval_sh(sh_degree, sh, dirs)

    opacity = torch.sigmoid(params["opacity"][:, 0])
    valid = in_front & det_ok & (radius > 0)
    return dict(xy=point_image, conic=conic, opacity=opacity, rgb=rgb,
                depth=depth, radius=radius, valid=valid)


def _tile_rect(attrs, grid_x, grid_y):
    xy = attrs["xy"].detach()
    r = attrs["radius"].detach()

    def clip(v, hi):
        return torch.clamp(v.to(torch.int32), 0, hi)
    return (clip((xy[:, 0] - r) / BLOCK, grid_x),
            clip((xy[:, 1] - r) / BLOCK, grid_y),
            clip((xy[:, 0] + r + BLOCK - 1) / BLOCK, grid_x),
            clip((xy[:, 1] + r + BLOCK - 1) / BLOCK, grid_y))


def _tile_pairs(attrs, grid_x, grid_y):
    """duplicateWithKeys (rasterizer_impl.cu:65-96) with a static cap of
    MAX_TILES_SIDE^2 tiles per Gaussian: slot (dy, dx) of Gaussian g is
    pair g*64 + dy*8 + dx.  Returns (tile, depth, gidx, ok), each
    [G*64]."""
    min_x, min_y, max_x, max_y = _tile_rect(attrs, grid_x, grid_y)
    dev = min_x.device
    s = MAX_TILES_SIDE
    d = torch.arange(s, dtype=torch.int32, device=dev)
    tx = min_x[:, None, None] + d[None, None, :]
    ty = min_y[:, None, None] + d[None, :, None]
    ok = (attrs["valid"][:, None, None] & (tx < max_x[:, None, None])
          & (ty < max_y[:, None, None]))
    tile = ty * grid_x + tx
    G = min_x.shape[0]
    gidx = torch.arange(G, dtype=torch.int32, device=dev)[:, None, None]
    depth = attrs["depth"].detach()[:, None, None]
    return (tile.reshape(-1), depth.expand(tile.shape).reshape(-1),
            gidx.expand(tile.shape).reshape(-1), ok.reshape(-1))


def _tile_pairs_compact(attrs, grid_x, grid_y, pair_cap):
    """duplicateWithKeys with the exact count of pairs (the CUB
    InclusiveSum of tiles_touched, rasterizer_impl.cu:65-96): pair p
    belongs to the Gaussian whose inclusive tile count first exceeds p
    (a binary search), and covers its rect in row-major order, the same
    order as the dense form.  Ranks at or past `pair_cap` drop; returns
    (tile, depth, gidx, ok), each [pair_cap], and the number dropped as an
    int64 tensor."""
    min_x, min_y, max_x, max_y = _tile_rect(attrs, grid_x, grid_y)
    s = MAX_TILES_SIDE
    w = torch.clamp(max_x - min_x, 0, s)
    h = torch.clamp(max_y - min_y, 0, s)
    touched = torch.where(attrs["valid"], w * h, 0).to(torch.int64)
    cs = torch.cumsum(touched, 0)
    G = touched.shape[0]
    dev = touched.device
    total = cs[-1] if G else torch.zeros((), dtype=torch.int64, device=dev)
    p = torch.arange(pair_cap, dtype=torch.int64, device=dev)
    ok = p < total
    g = torch.clamp(torch.searchsorted(cs, p, right=True), max=max(G - 1, 0))
    local = p - (cs - touched)[g] if G else p
    w_g = torch.clamp(w[g], min=1) if G else torch.ones_like(p)
    tile = ((min_y[g] + local // w_g) * grid_x + min_x[g] + local % w_g
            if G else p)
    depth = attrs["depth"].detach()[g] if G else torch.zeros(
        pair_cap, device=dev)
    overflow = torch.clamp(total - pair_cap, min=0)
    return tile, depth, g.to(torch.int32), ok, overflow


def _depth_key(tile, depth, ok, n_tiles):
    """One int64 sort key per pair: tile in the high word, the depth's f32
    bits in the low word.  Valid pairs have depth > 0.2, so their bit
    patterns order like the floats; invalid pairs take tile n_tiles and
    sort last, in any order."""
    hi = torch.where(ok, tile.to(torch.int64), n_tiles)
    lo = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (hi << 32) | lo


def bin_and_gather(params, cam, sh_degree, max_per_tile=128, pairs="auto"):
    """Everything of `render` before the blend: preprocess, pair
    expansion, the (tile, depth) sort, the per-tile ranges, and the gather
    of each tile's front-most `max_per_tile` Gaussians.  Returns a dict:
    attr f32[T,K,9] (differentiable w.r.t. params), valid bool[T,K],
    grid_x, grid_y, radii f32[G], overflow (int64 tensor)."""
    H, W = int(cam["H"]), int(cam["W"])
    grid_x = (W + BLOCK - 1) // BLOCK
    grid_y = (H + BLOCK - 1) // BLOCK
    n_tiles = grid_x * grid_y

    attrs = preprocess(params, cam, sh_degree)
    G = attrs["xy"].shape[0]
    dev = attrs["xy"].device
    if pairs == "auto":
        pairs = ("dense" if G * MAX_TILES_SIDE ** 2 <= PAIRS_AUTO_DENSE_MAX
                 else "compact")
    if pairs == "compact":
        tile, depth, gidx, ok, overflow = _tile_pairs_compact(
            attrs, grid_x, grid_y, pair_cap=16 * G)
    elif pairs == "dense":
        tile, depth, gidx, ok = _tile_pairs(attrs, grid_x, grid_y)
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        raise ValueError(f"pairs: {pairs!r}")

    key = _depth_key(tile, depth, ok, n_tiles)
    key_s, order = torch.sort(key, stable=True)
    gidx_s = gidx[order]
    tile_s = key_s >> 32
    bounds = torch.searchsorted(
        tile_s, torch.arange(n_tiles + 1, dtype=torch.int64, device=dev))
    starts = bounds[:n_tiles]
    counts = bounds[1:] - bounds[:-1]

    k = torch.arange(max_per_tile, dtype=torch.int64, device=dev)
    valid = k[None, :] < torch.clamp(counts[:, None], max=max_per_tile)
    lidx = torch.where(valid, starts[:, None] + k[None, :], 0)
    gl = gidx_s[lidx].to(torch.int64)                     # [T,K]

    attr9 = torch.cat([attrs["xy"], attrs["conic"], attrs["opacity"][:, None],
                       attrs["rgb"]], dim=1)
    # index_select, whose backward is one index_add_ (atomic on the card);
    # advanced indexing's backward sorts the indices first
    attr = attr9.index_select(0, gl.reshape(-1)).reshape(n_tiles,
                                                          max_per_tile, 9)
    radii = torch.where(attrs["valid"], attrs["radius"], 0.0)
    return dict(attr=attr, valid=valid, grid_x=grid_x, grid_y=grid_y,
                radii=radii, overflow=overflow)


def untile(Tfin, Cfin, bg_color, grid_x, grid_y, H, W):
    """Per-tile T, C -> the channel-first image f32[3,H,W] over bg."""
    out = Cfin + Tfin[..., None] * bg_color[None, None, :]
    img = out.reshape(grid_y, grid_x, BLOCK, BLOCK, 3)
    img = img.permute(0, 2, 1, 3, 4).reshape(grid_y * BLOCK, grid_x * BLOCK,
                                             3)[:H, :W]
    return img.permute(2, 0, 1)


def render(params, cam, bg_color, sh_degree, max_per_tile=128,
           pairs="auto"):
    """Forward render of the live Gaussians -> (image f32[3,H,W], radii
    f32[G], overflow int64 tensor).  Differentiable w.r.t. params.

    pairs: "auto" takes the dense 64-slot form up to PAIRS_AUTO_DENSE_MAX
    pairs (it never drops a pair inside the 8x8 rect cap) and the compact
    exact-count form (16 pairs per Gaussian on average) beyond; either can
    be named."""
    b = bin_and_gather(params, cam, sh_degree, max_per_tile, pairs)
    Tfin, Cfin = B.blend_tiles(b["attr"], b["valid"], b["grid_x"])
    img = untile(Tfin, Cfin, bg_color, b["grid_x"], b["grid_y"],
                 int(cam["H"]), int(cam["W"]))
    return img, b["radii"], b["overflow"]
