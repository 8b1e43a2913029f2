"""The LiDAR scan's raster and window projection: kernels K13 and K14
(ops/scan_raster.py, csrc/scan_raster.cu) against their plain PyTorch
twins.

The CPU cases hold the twins, and the entries on CPU tensors, equal to
the torch ops as the port ran them before the kernels, whose frozen copy
is the benchmark's reference (benchmark/reference/integrate.py, plain
torch): on the loop's scan shape (64 x 1024) with a window of res-0 and
res-1 entries under a general rotation, and on an empty scan and window.

The `gpu` cases (`python -m pytest --noconftest -m gpu
tests/test_torch_scan_raster.py` on a machine with a card) hold the
kernels equal to the twins run on the same card tensors, bit for bit:
the image, the mapping (el_lo, s_el), pix and r_vox, on a scan with
returns under min_depth, beyond max_depth, at range 0 and at +-pi
azimuth; on a drive-sized window (~5,000 mixed entries) under a general
rotation; and on a scan of no points and a window of no entries.  Then K3
on the kernels' operands leaves the pool and the flags that it leaves on
the twins' (ops/integrate.py::fused_integrate_points), with three
launches of K13 and one of K14 a scan.
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

from mrhash_tpu_torch.core.state import MapConfig, make_pool
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import fused_integrate_points as FIP
from mrhash_tpu_torch.ops import integrate as I
from mrhash_tpu_torch.ops import scan_raster as SR
from mrhash_tpu_torch.utils.profiler import COUNTS

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import integrate as RI  # noqa: E402

ROWS, COLS = 64, 1024                 # the loop's Ouster OS1-64
MIN_D, MAX_D = 0.2, 60.0
CFG = MapConfig(virtual_voxel_size=0.20, sdf_truncation=0.40,
                sdf_truncation_scale=0.0, max_integration_distance=MAX_D,
                num_blocks=1 << 13)
SIDE = 8 * CFG.virtual_voxel_size     # a block's side (m)


def _rotation(seed):
    """A general rotation (cam -> world) from a random unit quaternion."""
    q = np.random.default_rng(seed).normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]],
        np.float32)


def _cam(device, seed=0):
    cam = C.make_camera(COLS / (2 * math.pi), ROWS / 0.58, COLS / 2.0,
                        ROWS / 2.0, ROWS, COLS, MIN_D, MAX_D,
                        model=C.SPHERICAL, device=device)
    trans = np.random.default_rng(seed + 1).uniform(-30, 30, 3)
    return C.with_pose(cam, _rotation(seed), trans.astype(np.float32))


def _scan(seed, edges=True):
    """A 64 x 1024 scan in the sensor frame: ground 1.7 m below, a
    cylinder wall of radius 25 m, 2 cm range noise, the beams over +-16.6
    degrees; with `edges`, first the returns the gates must treat alike:
    at range 0, under 1e-6 m, under min_depth, beyond max_depth, and on
    the -x axis at +0 and -0 in y (azimuth +pi and -pi)."""
    g = np.random.default_rng(seed)
    el = np.radians(np.linspace(-16.6, 16.6, ROWS))[:, None]
    az = np.linspace(-np.pi, np.pi, COLS, endpoint=False)[None, :] + 1e-3
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el) + 0 * az], -1)
    t_ground = np.where(d[..., 2] < -1e-3,
                        -1.7 / np.minimum(d[..., 2], -1e-3), np.inf)
    t_wall = 25.0 / np.maximum(np.hypot(d[..., 0], d[..., 1]), 1e-9)
    t = np.minimum(t_ground, t_wall) + g.normal(0, 0.02, t_wall.shape)
    pts = (d * t[..., None]).reshape(-1, 3)
    if edges:
        pts = np.concatenate([np.array([
            [0, 0, 0], [3e-7, 0, 0], [0.1, 0.05, 0], [80.0, 5.0, 1.0],
            [-7.0, 0.0, 0.3], [-7.0, -0.0, 0.3], [-50.0, 0.0, -1.0],
            [-50.0, -0.0, -1.0]]), pts])
    return torch.from_numpy(pts.astype(np.float32))


def _window(cam, points, seed, n=None, low=0.5):
    """The blocks of the scan's returns in the world and their neighbours
    (a 3^3 dilation), shuffled, the first n of them; a share `low` at res
    1.  Returns (bpos i32[A,3], bres i32[A])."""
    rot, trans = cam.rot.cpu().double(), cam.trans.cpu().double()
    pw = points.double() @ rot.T + trans
    blk = torch.floor(pw / SIDE).to(torch.int32)
    near = torch.stack(torch.meshgrid(*[torch.arange(-1, 2)] * 3,
                                      indexing="ij"), -1).reshape(-1, 3)
    blk = torch.unique((blk[:, None, :] + near.to(torch.int32)).reshape(
        -1, 3), dim=0)
    g = torch.Generator().manual_seed(seed)
    blk = blk[torch.randperm(blk.shape[0], generator=g)][:n].contiguous()
    bres = (torch.rand(blk.shape[0], generator=g) < low).to(torch.int32)
    return blk, bres


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same_bits(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert torch.equal(_bits(a), _bits(b)), (
        what, int((_bits(a) != _bits(b)).sum()))


def _frozen(cam, points, bpos, bres):
    """The torch ops as the port ran them before K13 and K14."""
    el_lo, s_el = RI.scan_raster_mapping(cam, points)
    img = RI.rasterize_scan(cam, points, el_lo, s_el)
    pix, r_vox = RI.project_window_sph(CFG, cam, bpos, bres, el_lo, s_el)
    return img, torch.stack([el_lo, s_el]), pix, r_vox


# ---------------------------------------------------------------------------
# on the CPU: the twins and the entries as the torch ops stood
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["scan", "empty"])
def test_twins_and_entries_match_the_ops_as_they_stood(case):
    cam = _cam("cpu", seed=3)
    points = _scan(3)
    bpos, bres = _window(cam, points, 4, n=600)
    if case == "empty":
        points, bpos, bres = points[:0], bpos[:0], bres[:0]
    img, mapping, pix, r_vox = _frozen(cam, points, bpos, bres)
    before = dict(COUNTS)
    for raster, project in ((SR.raster_scan_ref, SR.project_window_ref),
                            (SR.raster_scan, SR.project_window)):
        got_img, got_map = raster(cam, points)
        got_pix, got_r = project(CFG, cam, bpos, bres, got_map)
        _same_bits(got_img, img, "img")
        _same_bits(got_map, mapping, "mapping")
        assert torch.equal(got_pix, pix)
        _same_bits(got_r, r_vox, "r_vox")
    assert dict(COUNTS) == before      # no kernel launched
    if case == "scan":
        # the scene is seen: most pixels hold a return, a lane in six is
        # on the image, and the res-1 entries' lanes past 64 are off it
        assert int((img > 0).sum()) > 0.9 * ROWS * COLS
        assert int((pix >= 0).sum()) > bpos.shape[0] * 512 // 6
        assert bool((pix[bres == 1][:, 64:] == -1).all())
    else:
        assert mapping.tolist() == [-1.0, (ROWS - 1) / 2.0]
        assert not bool(img.any()) and pix.shape == (0, 512)


def test_points_window_takes_the_entries():
    cam = _cam("cpu", seed=5)
    points = _scan(5)
    bpos, bres = _window(cam, points, 6, n=300)
    bptr = torch.arange(bpos.shape[0], dtype=torch.int32) * 512
    img, pix, r_vox, ptr, res, consts = I.points_window(CFG, cam, points,
                                                        bpos, bptr, bres)
    want = _frozen(cam, points, bpos, bres)
    _same_bits(img, want[0], "img")
    assert torch.equal(pix, want[2])
    _same_bits(r_vox, want[3], "r_vox")
    assert torch.equal(ptr, bptr) and torch.equal(res, bres)
    assert consts == (0.40, 0.0, MAX_D, 1, CFG.integration_weight_max, 0.20)


def test_entries_reject_bad_operands():
    cam = _cam("cpu")
    points = _scan(7, edges=False)
    with pytest.raises(ValueError, match="points"):
        SR.raster_scan(cam, points[:, :2].contiguous())
    with pytest.raises(ValueError, match="points"):
        SR.raster_scan(cam, points.double())
    bpos, bres = _window(cam, points, 8, n=10)
    mapping = SR.raster_scan(cam, points)[1]
    with pytest.raises(ValueError, match="bres"):
        SR.project_window(CFG, cam, bpos, bres[:5], mapping)
    with pytest.raises(ValueError, match="mapping"):
        SR.project_window(CFG, cam, bpos, bres, mapping[:1])


# ---------------------------------------------------------------------------
# on the card: kernels against the twins
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _on_card_pair(cam, points, bpos, bres):
    """(kernels, twins) of one scan and window on the card; K13's three
    launches and K14's one counted."""
    n13, n14 = COUNTS["raster_scan"], COUNTS["project_window"]
    img, mapping = SR.raster_scan(cam, points)
    pix, r_vox = SR.project_window(CFG, cam, bpos, bres, mapping)
    assert (COUNTS["raster_scan"] - n13, COUNTS["project_window"] - n14) == (
        3, int(bpos.shape[0] > 0))
    t_img, t_map = SR.raster_scan_ref(cam, points)
    t_pix, t_r = SR.project_window_ref(CFG, cam, bpos, bres, t_map)
    torch.cuda.synchronize()
    return (img, mapping, pix, r_vox), (t_img, t_map, t_pix, t_r)


def _assert_same(got, want):
    for name, g, w in zip(("img", "mapping", "pix", "r_vox"), got, want):
        _same_bits(g, w, name)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["edges", "drive", "empty"])
def test_kernels_match_the_twins_on_card(cuda, case):
    cam = _cam(cuda, seed=11)
    points = _scan(11)
    n = dict(edges=800, drive=5000, empty=0)[case]
    bpos, bres = _window(_cam("cpu", seed=11), points, 12, n=n)
    if case == "empty":
        points = points[:0]
    points, bpos, bres = (t.to(cuda) for t in (points, bpos, bres))
    got, want = _on_card_pair(cam, points, bpos, bres)
    _assert_same(got, want)
    img, mapping, pix, _ = got
    if case == "empty":
        assert mapping.tolist() == [-1.0, (ROWS - 1) / 2.0]
        assert not bool(img.any()) and pix.shape == (0, 512)
        return
    assert bpos.shape[0] == n and 0.4 < float(bres.float().mean()) < 0.6
    assert int((img > 0).sum()) > 0.9 * ROWS * COLS
    assert int((pix >= 0).sum()) > n * 512 // 6
    if case == "edges":
        # the returns under min_depth, at range 0 and under 1e-6 m, and
        # beyond max_depth left no pixel; the +-pi azimuths took the first
        # and the last column
        assert float(img.max()) <= MAX_D and float(img[img > 0].min()) >= MIN_D
        r = points[4:6].norm(dim=1)
        row = ((torch.asin(points[4:6, 2] / r) - mapping[0]) * mapping[1]
               + 0.5).floor().long()
        assert abs(float(img[row[0], COLS - 1] - r[0])) < 1e-4
        assert abs(float(img[row[1], 0] - r[1])) < 1e-4


@pytest.mark.gpu
def test_k3_on_the_kernels_operands_matches_the_twins(cuda):
    cam = _cam(cuda, seed=21)
    points = _scan(21, edges=False).to(cuda)
    bpos, bres = _window(_cam("cpu", seed=21), points.cpu(), 22, n=3000)
    A = bpos.shape[0]
    bpos, bres = bpos.to(cuda), bres.to(cuda)
    bptr = torch.arange(A, dtype=torch.int32, device=cuda) * 512
    g = torch.Generator(device=cuda).manual_seed(23)
    pools = [make_pool(A, cuda) for _ in range(2)]
    w = torch.randint(0, 4, (A, 512), generator=g, device=cuda,
                      dtype=torch.int32)
    sdf = (torch.rand((A, 512), generator=g, device=cuda) - 0.5) * 0.8
    for pool in pools:
        pool.weight.copy_(w)
        pool.sdf.copy_(sdf)
        pool.sumsq.copy_(sdf.abs())
    n13, n14 = COUNTS["raster_scan"], COUNTS["project_window"]
    aux = I.fused_integrate_points(CFG, pools[0], cam, points, bpos, bptr,
                                   bres)
    assert (COUNTS["raster_scan"] - n13, COUNTS["project_window"] - n14) == (
        3, 1)
    t_img, t_map = SR.raster_scan_ref(cam, points)
    t_pix, t_r = SR.project_window_ref(CFG, cam, bpos, bres, t_map)
    consts = (CFG.sdf_truncation, CFG.sdf_truncation_scale,
              CFG.max_integration_distance, CFG.integration_weight_sample,
              CFG.integration_weight_max, CFG.virtual_voxel_size)
    flags = FIP.fused_integrate_points_rows(pools[1], t_img, t_pix, t_r,
                                            bptr, bres, consts)
    torch.cuda.synchronize()
    for f in ("sdf", "sumsq", "weight"):
        _same_bits(getattr(pools[0], f), getattr(pools[1], f), f)
    assert int((pools[0].weight != w).sum()) > 10000
    _same_bits(aux["gc_min_s"], flags[:, 0], "flags")
    _same_bits(aux["gc_max_w"], flags[:, 1], "flags")
