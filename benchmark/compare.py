"""The comparison that decides `correct`: the program's map against the
reference's, by content and not by layout (hash slots and window order
differ by design).

A map's content is its set of blocks, each a key (block position) at a
resolution, with the voxels of its window: 512 at res 0, 64 at res 1, each
with sdf, sumsq, weight and packed colour.  Blocks are matched by (key,
res); the numbers compared are:

- blocks_apart: blocks in one map and not in the other (or at another
  resolution), and each extra copy of a key the program holds more than
  once (on the card and in its host grid, or twice in the grid), as a
  share of the reference's blocks: allocation, GC, the coarsening
  decision, and streaming, which must lose and duplicate nothing;
- weight_apart: voxels of matched blocks whose weight differs, as a share
  of the matched blocks' weighted voxels: which voxels each frame updated,
  and starvation;
- sdf_gap: the largest |sdf| gap over voxels weighted on both sides,
  metres: the fused update and the coarse blocks' re-integrated content;
- rgb_apart: weighted voxels on both sides whose colour differs, as a
  share of them.
"""
from __future__ import annotations

import numpy as np
import torch

LANES, LOW_LANES = 512, 64
FREE_ENTRY = -2
OFF = 1 << 20


def key_codes(pos):
    """i64 code of each i32[...,3] block position (|coordinate| < 2^20)."""
    p = pos.astype(np.int64) + OFF
    return (p[..., 0] << 42) | (p[..., 1] << 21) | p[..., 2]


def map_content(pos, ptr, res, sdf, sumsq, weight, rgbp):
    """Host arrays of a map held as a hash table (pos i32[C,3], ptr i32[C],
    res i32[C]) over a pool of [N,512] fields where a block's voxel v lies
    at flat index ptr + v: {0: (codes, fields), 1: (codes, fields)} per
    resolution, codes sorted, fields a dict of [n, 512] or [n, 64]
    arrays."""
    occ = ptr != FREE_ENTRY
    out = {}
    for r, lanes in ((0, LANES), (1, LOW_LANES)):
        sel = torch.nonzero(occ & (res == r)).flatten()
        codes = key_codes(pos[sel].cpu().numpy())
        order = np.argsort(codes, kind="stable")
        sel = sel[torch.from_numpy(order).to(sel.device)]
        idx = (ptr[sel].to(torch.int64)[:, None]
               + torch.arange(lanes, device=ptr.device)[None, :])
        out[r] = (codes[order], {
            name: f.reshape(-1)[idx].cpu().numpy()
            for name, f in (("sdf", sdf), ("sumsq", sumsq),
                            ("weight", weight), ("rgbp", rgbp))})
    return out


def host_content(pos, res, sdf, ssq, w, rgb):
    """map_content's form of blocks held in the host layout (numpy pos
    i32[n,3], res i32[n] and [n,512] fields, a res-1 block's 64 voxels at
    lanes [0, 64)), as the program's host chunk grid holds them."""
    codes = key_codes(pos)
    out = {}
    for r, lanes in ((0, LANES), (1, LOW_LANES)):
        sel = np.nonzero(res == r)[0]
        sel = sel[np.argsort(codes[sel], kind="stable")]
        out[r] = (codes[sel], {name: f[sel, :lanes] for name, f in (
            ("sdf", sdf), ("sumsq", ssq), ("weight", w), ("rgbp", rgb))})
    return out


def union(*maps):
    """One map_content result holding the blocks of `maps`, one copy of
    each key (at either resolution) kept, and "dups": the count of the
    further copies."""
    codes = [np.concatenate([m[r][0] for m in maps]) for r in (0, 1)]
    both = np.concatenate(codes)
    keep = np.zeros(both.size, dtype=bool)
    keep[np.unique(both, return_index=True)[1]] = True
    out = {"dups": int(both.size - keep.sum())}
    for r, k in ((0, keep[:codes[0].size]), (1, keep[codes[0].size:])):
        order = np.argsort(codes[r][k], kind="stable")
        out[r] = (codes[r][k][order], {
            name: np.concatenate([m[r][1][name] for m in maps])[k][order]
            for name in maps[0][r][1]})
    return out


def compare(prog, ref):
    """The numbers compared (module docstring) between two map_content
    results, as plain floats."""
    apart, matched, ref_blocks = prog.get("dups", 0), 0, 0
    w_apart = weighted = rgb_apart = both = 0
    gap = 0.0
    for r in (0, 1):
        pc, pf = prog[r]
        rc, rf = ref[r]
        ref_blocks += rc.size
        common, pi, ri = np.intersect1d(pc, rc, assume_unique=True,
                                        return_indices=True)
        apart += pc.size + rc.size - 2 * common.size
        matched += common.size
        if not common.size:
            continue
        pw, rw = pf["weight"][pi], rf["weight"][ri]
        w_apart += int(((pw != rw) & ((pw > 0) | (rw > 0))).sum())
        weighted += int(((pw > 0) | (rw > 0)).sum())
        on = (pw > 0) & (rw > 0)
        both += int(on.sum())
        if on.any():
            gap = max(gap, float(np.abs(pf["sdf"][pi][on].astype(np.float64)
                                        - rf["sdf"][ri][on]).max()))
            rgb_apart += int((pf["rgbp"][pi][on] != rf["rgbp"][ri][on]).sum())
    return dict(blocks_apart=apart / max(ref_blocks, 1),
                weight_apart=w_apart / max(weighted, 1),
                sdf_gap=gap,
                rgb_apart=rgb_apart / max(both, 1),
                ref_blocks=ref_blocks, matched_blocks=matched,
                weighted_voxels=weighted)


def judge(numbers, limits):
    """(correct, checks): every number in `limits` at or under its limit;
    an empty reference map is never correct."""
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items()}
    ok = numbers["ref_blocks"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
