"""Allocation on the card: kernels K7-K9 (ops/alloc_blocks.py,
csrc/alloc_blocks.cu) against their plain PyTorch twins.

The CPU cases hold the choice: on CPU tensors AB.alloc_candidates_*,
AB.dedup and AB.insert (through I.alloc_blocks) take the twins (no
kernel launch is counted) and give the same keys, i32 scratch, table and
(submitted, inserted) as the plain allocation of the twins
(dedup_scatter and dedup_compact, then H.insert).

The `gpu` cases (`python -m pytest --noconftest -m gpu
tests/test_torch_alloc_blocks.py` on a machine with a card) run the
kernels and the twins on the card on the same inputs and hold them equal
bit for bit: the candidate keys (where valid) and valid masks, the
dedup scratch's winners, the served keys in cell order and their count,
and after the insert the table (pos, ptr, res, fp, both heaps and their
counts) and the per-key slot, ptr, res, was_new and present.  Frames at
the benchmark cells' sizes: 1200x680 depth rays at stride 2 with 7 steps
(a fresh map first, so the insert claims max_alloc_per_frame keys, then
frames that find most keys), and 64x1024 LiDAR points with 4 steps along
the camera rays and along the normals (the second scan of a pose finds
every key); then a small table with full probe windows, a dry heap,
res-1 keys, a fingerprint collision and padded batches; the scatter
alone (a walk without the scratch) and the 4 x 4 tile path
(GeoWrapper's) through alloc_blocks, with tiles past the image's edge;
and the launches and the one host read an allocation.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from mrhash_tpu_torch.core.state import MapConfig
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.ops import integrate as I
from mrhash_tpu_torch.utils.profiler import COUNTS, SYNCS

KERNELS = ("alloc_walk", "alloc_scatter", "alloc_compact", "alloc_lookup",
           "alloc_insert")
# the benchmark cells' allocation settings (benchmark/configs/); the
# orbit's GeoWrapper also sets alloc_tile = 4 (the tile case below)
ORBIT = MapConfig(virtual_voxel_size=0.01, sdf_truncation=0.07,
                  max_integration_distance=30.0, num_blocks=1 << 19,
                  num_buckets=1 << 15, max_alloc_per_frame=1 << 13)
LOOP = MapConfig(virtual_voxel_size=0.2, sdf_truncation=0.4,
                 max_integration_distance=100.0, num_blocks=1 << 18,
                 num_buckets=1 << 16, max_alloc_per_frame=1 << 13)


def _rot(yaw, pitch):
    cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), \
        math.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return (ry @ rx).astype(np.float32)


def _depth_frame(i, rows, cols, device):
    """A pinhole camera (600 px focal) turning and moving in a room, and
    a depth image of a wavy wall 1.5-3.5 m away with a hole of no
    returns."""
    cam = C.make_camera(600.0 * cols / 1200, 600.0 * cols / 1200,
                        cols / 2 - 0.5, rows / 2 - 0.5, rows, cols, 0.01, 30.0,
                        device=device)
    cam = C.with_pose(cam, _rot(0.05 * i, 0.02 * i),
                      [0.03 * i, -0.02 * i, 0.01 * i])
    g = torch.Generator().manual_seed(100 + i)
    r = torch.arange(rows, dtype=torch.float32)[:, None]
    c = torch.arange(cols, dtype=torch.float32)[None, :]
    d = (2.5 + 0.6 * torch.sin(c / (37.0 * cols / 1200) + 0.3 * i)
         + 0.3 * torch.cos(r / (23.0 * rows / 680))
         + 0.003 * torch.randn((rows, cols), generator=g))
    d[rows // 5:rows // 4, cols // 3:cols // 2] = 0.0
    pc_depth = C.get_depth(cam, C.compute_cloud(cam, d.to(device)))
    return cam, pc_depth


def _scan(i, rows, cols, device, normals=False):
    """A 360-degree scan of a ground plane 1.5 m down and a wall of 25 m
    radius (points in the sensor frame, 1 cm noise, every 13th point no
    return), its pose, and its unit normals (some zero)."""
    g = torch.Generator().manual_seed(200 + i)
    el = torch.linspace(-0.29, 0.29, rows)[:, None]
    az = torch.linspace(-math.pi, math.pi, cols + 1)[:-1][None, :]
    d = torch.stack([torch.cos(el) * torch.cos(az),
                     torch.cos(el) * torch.sin(az),
                     torch.sin(el).expand(rows, cols)], -1).reshape(-1, 3)
    rng = torch.where(d[:, 2] < -0.06, -1.5 / d[:, 2].clamp(max=-1e-3),
                      torch.full_like(d[:, 2], 25.0))
    rng = rng.clamp(max=60.0) + 0.01 * torch.randn(rng.shape, generator=g)
    pts = d * rng[:, None]
    pts[::13] = 0.0
    cam = C.make_camera(cols / (2 * math.pi), rows / 0.58, cols / 2.0,
                        rows / 2.0, rows, cols, 0.2, 100.0,
                        model=C.SPHERICAL, device=device)
    cam = C.with_pose(cam, _rot(0.1 * i, 0.0), [0.125 * i, 0.05 * i, 0.0])
    nrm = None
    if normals:
        nrm = torch.where((d[:, 2] < -0.06)[:, None],
                          torch.tensor([0.0, 0.0, 1.0]), -d)
        nrm[::7] = 0.0
        nrm = nrm.to(device)
    return cam, pts.to(device), nrm


def _twin_scratch(cfg, frame, device, keys, valid):
    s = AB.dedup_scratch(cfg, frame, device)
    AB.dedup_scatter(keys, valid, s)
    return s


def _alloc_twin(cfg, table, keys, valid, frame):
    """The plain allocation: dedup_scatter and dedup_compact, then
    H.insert, the twins on any device.  Returns (submitted, inserted)."""
    free0 = table.high_count + table.low_count
    u, stats = AB.dedup_compact(keys, _twin_scratch(cfg, frame, keys.device,
                                                    keys, valid),
                                cfg.max_alloc_per_frame)
    assert int(stats[0]) == u.shape[0]
    H.insert(table, u, torch.zeros(u.shape[0], dtype=torch.int32,
                                   device=u.device))
    return u.shape[0], free0 - table.high_count - table.low_count


def _clone(table):
    return H.HashTable(**{k: v.clone() if torch.is_tensor(v) else v
                          for k, v in vars(table).items()})


def _same_table(a, b):
    for f in ("pos", "ptr", "res", "fp", "heap_high", "heap_low"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.high_count, a.low_count) == (b.high_count, b.low_count)


def _same_info(info, ref, n):
    for k in ("slot", "ptr", "res", "was_new", "present"):
        assert torch.equal(info[k][:n], ref[k]), k


# ---------------------------------------------------------------------------
# CPU: the entries take the twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["depth", "points"])
def test_alloc_blocks_on_cpu_takes_the_twins(path):
    if path == "depth":
        cfg = dataclasses.replace(ORBIT, num_blocks=1 << 12,
                                  num_buckets=1 << 9,
                                  max_alloc_per_frame=1 << 9)
    else:
        cfg = dataclasses.replace(LOOP, num_blocks=1 << 11,
                                  num_buckets=1 << 9,
                                  max_alloc_per_frame=1 << 8)
    table = H.make_table(cfg.num_blocks, cfg.num_buckets)
    twin = _clone(table)
    before = {k: COUNTS[k] for k in KERNELS}
    for f in range(3):
        if path == "depth":
            cam, pc = _depth_frame(f, 68, 120, "cpu")
            steps = cfg.dda_steps(30.0)
            scratch = AB.dedup_scratch(cfg, f, "cpu")
            keys, valid = AB.alloc_candidates_depth(cfg, cam, pc, steps,
                                                    frame=f, scratch=scratch)
            rk, rv = AB.alloc_candidates_depth_ref(cfg, cam, pc, steps,
                                                   frame=f)
        else:
            cam, pts, _ = _scan(f, 16, 128, "cpu")
            steps = cfg.dda_steps(100.0)
            scratch = AB.dedup_scratch(cfg, f, "cpu")
            keys, valid = AB.alloc_candidates_points(cfg, cam, pts, steps,
                                                     None, scratch)
            rk, rv = AB.alloc_candidates_points_ref(cfg, cam, pts, steps)
        assert torch.equal(keys, rk) and torch.equal(valid, rv)
        assert scratch.cells.dtype == torch.int32
        got = I.alloc_blocks(cfg, table, keys, valid, f, scratch)
        assert got == _alloc_twin(cfg, twin, rk, rv, f)
        assert got[0] > 0
        _same_table(table, twin)
    assert all(COUNTS[k] == before[k] for k in KERNELS)
    assert table.high_count < cfg.num_blocks


def test_insert_on_cpu_is_the_twin():
    """AB.insert on CPU tensors: the twin H.insert's info and table, one
    int res for every key or a tensor, and the key count, also where a
    stats tensor holds it and padded rows follow."""
    rng = np.random.default_rng(3)
    table = H.make_table(256, 16)
    twin = _clone(table)
    H.split_high_blocks(table, 4)
    H.split_high_blocks(twin, 4)
    for res in (0, 1, None):
        keys = torch.from_numpy(np.unique(rng.integers(-9, 9, (90, 3)),
                                          axis=0).astype(np.int32))
        r = (torch.from_numpy((rng.random(keys.shape[0]) < 0.5)
                              .astype(np.int32)) if res is None else res)
        n = keys.shape[0]
        if res is None:     # a padded batch, its count in stats[0]
            pad = torch.full((5, 3), 99, dtype=torch.int32)
            stats = torch.tensor([n, 0, 0, 0], dtype=torch.int32)
            info = AB.insert(table, torch.cat([keys, pad]),
                             torch.cat([r, torch.zeros(5, dtype=torch.int32)]),
                             stats)
        else:
            info = AB.insert(table, keys, r)
        ref = H.insert(twin, keys, r if res is None else torch.full(
            (n,), res, dtype=torch.int32))
        assert info["count"] == n
        _same_info(info, ref, n)
        _same_table(table, twin)
    assert table.low_count < 32 and table.high_count < 252


# ---------------------------------------------------------------------------
# the card: kernels against twins, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _round_on_card(cfg, tk, tr, keys, valid, rk, rv, scratch, frame):
    """One frame's allocation, kernels (tk) against twins (tr), step by
    step.  `scratch` is the frame's, filled by the kernel walk.  Returns
    the keys submitted."""
    dev = keys.device
    assert torch.equal(valid, rv)
    assert torch.equal(keys[valid], rk[rv])
    ref = _twin_scratch(cfg, frame, dev, rk, rv)
    assert scratch.cells.dtype == ref.cells.dtype == torch.int32
    assert torch.equal(scratch.cells, ref.cells)
    uk, stats = AB.compact(keys, scratch, cfg.max_alloc_per_frame)
    ur, rstats = AB.dedup_compact(rk, ref, cfg.max_alloc_per_frame)
    n = int(stats[0])
    assert n == ur.shape[0] == int(rstats[0])
    assert torch.equal(uk[:n], ur)
    info = AB.insert(tk, uk, 0, stats)
    iref = H.insert(tr, ur, torch.zeros(n, dtype=torch.int32, device=dev))
    assert info["count"] == n
    _same_info(info, iref, n)
    _same_table(tk, tr)
    return n


@pytest.mark.gpu
def test_depth_frames_match_twins_on_card(cuda):
    cfg = ORBIT
    tk = H.make_table(cfg.num_blocks, cfg.num_buckets, cuda)
    tr = _clone(tk)
    steps = cfg.dda_steps(30.0)
    assert steps == 7
    news = []
    for f in range(6):
        cam, pc = _depth_frame(f, 680, 1200, cuda)
        scratch = AB.dedup_scratch(cfg, f, cuda)
        keys, valid = AB.alloc_candidates_depth(cfg, cam, pc, steps, frame=f,
                                               scratch=scratch)
        rk, rv = AB.alloc_candidates_depth_ref(cfg, cam, pc, steps, frame=f)
        assert keys.shape[0] == 7 * 340 * 600
        free = tk.high_count
        sub = _round_on_card(cfg, tk, tr, keys, valid, rk, rv, scratch, f)
        news.append(free - tk.high_count)
        if f == 0:     # a fresh map: every served key pending
            assert sub == news[0] == cfg.max_alloc_per_frame
    assert min(news[1:]) < cfg.max_alloc_per_frame   # keys found present


@pytest.mark.gpu
@pytest.mark.parametrize("projective", [True, False])
def test_points_frames_match_twins_on_card(cuda, projective):
    cfg = dataclasses.replace(LOOP, projective_sdf=projective)
    tk = H.make_table(cfg.num_blocks, cfg.num_buckets, cuda)
    tr = _clone(tk)
    steps = cfg.dda_steps(100.0)
    assert steps == 4
    for f in (0, 1, 2, 3, 4, 4):     # the pose of scan 4 twice
        cam, pts, nrm = _scan(f, 64, 1024, cuda, normals=not projective)
        scratch = AB.dedup_scratch(cfg, f, cuda)
        keys, valid = AB.alloc_candidates_points(cfg, cam, pts, steps, nrm,
                                                scratch)
        rk, rv = AB.alloc_candidates_points_ref(cfg, cam, pts, steps, nrm)
        free = tk.high_count
        sub = _round_on_card(cfg, tk, tr, keys, valid, rk, rv, scratch, f)
        assert sub > 0
    assert free == tk.high_count       # the repeated scan found every key


@pytest.mark.gpu
def test_insert_edge_cases_on_card(cuda):
    """Full probe windows and a dry heap (keys dropped as the twin drops
    them), res-1 keys after a low-heap split (the coarsen insert), a
    fingerprint collision, frees and reinserts, padded batches with the
    count on the card, an empty batch, and an all-found batch."""
    rng = np.random.default_rng(7)
    tk = H.make_table(300, 24, cuda)      # 240 slots: windows overflow
    tr = _clone(tk)

    def both(keys, res, padded=False):
        keys = torch.from_numpy(keys.astype(np.int32)).to(cuda)
        n = keys.shape[0]
        rt = (torch.full((n,), res, dtype=torch.int32, device=cuda)
              if isinstance(res, int) else res.to(cuda))
        iref = H.insert(tr, keys, rt)
        if padded:
            pad = torch.randint(-5, 5, (9, 3), dtype=torch.int32,
                                device=cuda)
            stats = torch.tensor([n, 0, 0, 0], dtype=torch.int32,
                                 device=cuda)
            rp = torch.cat([rt, torch.zeros(9, dtype=torch.int32,
                                             device=cuda)])
            info = AB.insert(tk, torch.cat([keys, pad]), rp, stats)
        else:
            info = AB.insert(tk, keys, res if isinstance(res, int) else rt)
        assert info["count"] == n
        _same_info(info, iref, n)
        _same_table(tk, tr)
        return iref

    for it in range(5):
        keys = np.unique(rng.integers(-20, 20, (130, 3)), axis=0)
        keys = keys[rng.permutation(len(keys))]
        res = (torch.from_numpy((rng.random(len(keys)) < 0.4)
                                .astype(np.int32)) if it % 2 else 0)
        if it == 1:
            H.split_high_blocks(tk, 6)
            H.split_high_blocks(tr, 6)
        both(keys, res, padded=it == 3)
    assert int((tk.ptr != -2).sum()) > 200
    present = tk.pos[tk.ptr != -2].cpu().numpy()
    assert not both(present[:50], 0)["was_new"].any()      # all found
    kill = torch.nonzero(tk.ptr != -2).flatten()[::3]
    H.free_slots(tk, kill)
    H.free_slots(tr, kill)
    both(np.unique(rng.integers(-20, 20, (160, 3)), axis=0), 0)
    both(np.zeros((0, 3)), 0)
    # a fingerprint collision: a slot of a new key's window holds another
    # key with the new key's fingerprint
    key = np.array([[77, -3, 5]])
    kt = torch.from_numpy(key.astype(np.int32)).to(cuda)
    s = int(H.probe_slots(H.calculate_hash(kt, tk.num_buckets),
                          tk.capacity)[0, 0])
    for t in (tk, tr):
        t.fp[s] = H.fingerprint(kt)[0]
        t.ptr[s] = 0
        t.pos[s] = torch.tensor([1, 1, 1], dtype=torch.int32)
    both(np.concatenate([key, np.array([[1, 1, 1]])]), 0)
    # a dry heap
    tk2 = H.make_table(40, 64, cuda)
    tr2 = _clone(tk2)
    keys = torch.from_numpy(np.unique(rng.integers(-9, 9, (400, 3)), axis=0)
                            .astype(np.int32)).to(cuda)
    info = AB.insert(tk2, keys, 0)
    iref = H.insert(tr2, keys, torch.zeros(keys.shape[0],
                                               dtype=torch.int32,
                                               device=cuda))
    _same_info(info, iref, keys.shape[0])
    _same_table(tk2, tr2)
    assert tk2.high_count == 0 and int(info["was_new"].sum()) == 40


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["scatter", "tile"])
def test_alloc_blocks_variants_on_card(cuda, case):
    """alloc_blocks through its kernels against the plain allocation of
    the twins: the scatter alone (K7's scatter entry, where the walk left
    the scratch empty) and the tile path that GeoWrapper takes
    (alloc_tile = 4: K7's tile entry, near and far bands, the tile's
    pixel rotating)."""
    kw = dict(alloc_tile=4) if case == "tile" else {}
    cfg = dataclasses.replace(ORBIT, max_alloc_per_frame=1 << 11, **kw)
    tk = H.make_table(cfg.num_blocks, cfg.num_buckets, cuda)
    tr = _clone(tk)
    steps = cfg.dda_steps(30.0)
    for f in range(4):
        cam, pc = _depth_frame(f, 680, 1200, cuda)
        scratch = AB.dedup_scratch(cfg, f, cuda) if case == "tile" else None
        keys, valid = AB.alloc_candidates_depth(cfg, cam, pc, steps, frame=f,
                                                scratch=scratch)
        rk, rv = AB.alloc_candidates_depth_ref(cfg, cam, pc, steps, frame=f)
        assert torch.equal(valid, rv) and torch.equal(keys[valid], rk[rv])
        got = I.alloc_blocks(cfg, tk, keys, valid, f, scratch)
        assert got == _alloc_twin(cfg, tr, rk, rv, f)
        _same_table(tk, tr)
        if case == "tile":     # tiles past the image's edge, row offset
            sub = pc[1:678, 2:1199]
            keys, valid = AB.alloc_candidates_depth(cfg, cam, sub, steps,
                                                    row0=1, frame=f)
            rk, rv = AB.alloc_candidates_depth_ref(cfg, cam, sub, steps,
                                                   row0=1, frame=f)
            assert torch.equal(valid, rv)
            assert torch.equal(keys[valid], rk[rv])


@pytest.mark.gpu
def test_one_host_read_a_round_on_card(cuda):
    """On a card an allocation launches K7, K8 and K9 (their COUNTS rise)
    and reads the host once, whether the walk filled the scratch (K7's
    walk) or not (K7's scatter); alloc_blocks takes no twin."""
    cfg = ORBIT
    tk = H.make_table(cfg.num_blocks, cfg.num_buckets, cuda)
    for f in range(3):
        cam, pc = _depth_frame(f, 680, 1200, cuda)
        fused = f != 1
        before = {k: COUNTS[k] for k in (*KERNELS, SYNCS)}
        scratch = AB.dedup_scratch(cfg, f, cuda) if fused else None
        keys, valid = AB.alloc_candidates_depth(cfg, cam, pc, 7, frame=f,
                                                scratch=scratch)
        I.alloc_blocks(cfg, tk, keys, valid, f, scratch)
        got = {k: COUNTS[k] - before[k] for k in before}
        assert got == {"alloc_walk": 1, "alloc_scatter": int(not fused),
                       "alloc_compact": 1, "alloc_lookup": 1,
                       "alloc_insert": 1, SYNCS: 1}, got
