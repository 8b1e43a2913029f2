"""The port's one device policy (ops/cuda_lib.py::on_card), held at every
kernel entry K1-K14.

Each case calls one entry on small CPU operands and holds that it takes
the plain twin: its result equals the twin's on the same operands, and
no kernel launch is added to utils/profiler.COUNTS.  Then it calls the
entry with its tensors on the `meta` device and holds that the policy's
ValueError is raised before any validation that reads values: no host
read is counted and nothing is launched (a read of a meta tensor would
raise another error).
"""
import math

import pytest
import torch

from mrhash_tpu_torch.core.state import MapConfig, make_pool, make_state
from mrhash_tpu_torch.gs import blend as B
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import coarsen_blocks as CB
from mrhash_tpu_torch.ops import fused_integrate as FI
from mrhash_tpu_torch.ops import fused_integrate_points as FIP
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.ops import sample_image as SI
from mrhash_tpu_torch.ops import scan_raster as SR
from mrhash_tpu_torch.utils.profiler import COUNTS, SYNCS

CFG = MapConfig(virtual_voxel_size=0.05, sdf_truncation=0.1,
                max_integration_distance=5.0, num_blocks=64,
                max_alloc_per_frame=64, max_coarsen_per_frame=8,
                sdf_var_threshold=1.0, low_split_chunk=8)
ROWS, COLS = 8, 12


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _cam():
    return C.make_camera(10.0, 10.0, COLS / 2, ROWS / 2, ROWS, COLS, 0.1,
                         5.0)


def _depth():
    return 1.0 + 0.5 * torch.rand((ROWS, COLS), generator=_gen(1))


def _window(n):
    """n res-0 entries owning pool rows 0..n-1."""
    bpos = torch.stack([torch.arange(n, dtype=torch.int32),
                        torch.zeros(n, dtype=torch.int32),
                        torch.full((n,), 2, dtype=torch.int32)], 1)
    ptr = torch.arange(n, dtype=torch.int32) * 512
    return bpos, ptr, torch.zeros(n, dtype=torch.int32)


def _k1():
    bpos, ptr, res = _window(2)
    cam_vec = FI.make_cam_vec(_cam(), 0.05, 0.1, 0.0, 5.0, 1, 255)
    rgb = torch.randint(0, 1 << 24, (ROWS, COLS), dtype=torch.int32,
                        generator=_gen(2))
    args = (_depth(), rgb, cam_vec, bpos, ptr, res)
    return (lambda *a: FI.fused_integrate_rows(make_pool(2, "cpu"), *a),
            lambda *a: FI.fused_integrate_rows_ref(make_pool(2, "cpu"), *a),
            args)


def _k2():
    img = torch.rand((2, ROWS, COLS), generator=_gen(3))
    row = torch.randint(0, ROWS, (2, 512), dtype=torch.int32,
                        generator=_gen(4))
    col = torch.randint(0, COLS, (2, 512), dtype=torch.int32,
                        generator=_gen(5))
    ok = torch.rand((2, 512), generator=_gen(6)) < 0.5
    return SI.sample_image, SI.sample_image_ref, (img, row, col, ok)


def _k3():
    _, ptr, res = _window(2)
    pix = torch.randint(-1, ROWS * COLS, (2, 512), dtype=torch.int32,
                        generator=_gen(7))
    r_vox = 1.0 + torch.rand((2, 512), generator=_gen(8))
    consts = (0.1, 0.0, 5.0, 1, 255, 0.05)
    return (lambda *a: FIP.fused_integrate_points_rows(make_pool(2, "cpu"),
                                                       *a),
            lambda *a: FIP.fused_integrate_points_rows_ref(
                make_pool(2, "cpu"), *a),
            (_depth(), pix, r_vox, ptr, res, consts))


def _attr(n_tiles=2, k=4):
    a = torch.rand((n_tiles, k, B.N_ATTR), generator=_gen(9))
    a[..., 0:2] *= 16.0                   # means inside the tile
    a[..., 2:5] = torch.tensor([0.05, 0.0, 0.05])   # conic
    return a, torch.rand((n_tiles, k), generator=_gen(10)) < 0.8


def _k4():
    attr, valid = _attr()
    return B.blend_forward, B.blend_forward_ref, (attr, valid, 2)


def _k5():
    attr, valid = _attr()
    tfin, _, mask = B.blend_forward_ref(attr, valid, 2)
    gt = torch.rand(tfin.shape, generator=_gen(11))
    gc = torch.rand((*tfin.shape, 3), generator=_gen(12))
    return (B.blend_backward,
            lambda a, v, g, t, m, x, y: B.blend_backward_ref(a, g, t, m, x,
                                                             y),
            (attr, valid, 2, tfin, mask, gt, gc))


def _k6():
    img5 = torch.rand((SI.N_CH5, 40, 300), generator=_gen(13)).bfloat16()
    r0 = torch.randint(0, 20, (8,), dtype=torch.int32, generator=_gen(14))
    c0 = torch.randint(0, 60, (8,), dtype=torch.int32, generator=_gen(15))
    lr = torch.randint(-2, 34, (8, 512), dtype=torch.int32,
                       generator=_gen(16))
    lc = torch.randint(-2, 258, (8, 512), dtype=torch.int32,
                       generator=_gen(17))
    return SI.sample_image5, SI.sample_image5_ref, (img5, r0, c0, lr, lc)


def _k7_depth():
    pc_depth = C.get_depth(_cam(), C.compute_cloud(_cam(), _depth()))
    return (lambda d: AB.alloc_candidates_depth(CFG, _cam(), d, 4, frame=1),
            lambda d: AB.alloc_candidates_depth_ref(CFG, _cam(), d, 4,
                                                    frame=1),
            (pc_depth,))


def _points():
    az = torch.linspace(-math.pi, math.pi, 40)
    return torch.stack([2 * torch.cos(az), 2 * torch.sin(az),
                        0.1 * torch.ones(40)], 1)


def _k7_points():
    return (lambda p: AB.alloc_candidates_points(CFG, _cam(), p, 4),
            lambda p: AB.alloc_candidates_points_ref(CFG, _cam(), p, 4),
            (_points(),))


def _keys():
    keys, valid = AB.alloc_candidates_points_ref(CFG, _cam(), _points(), 4)
    return keys, valid


def _k8_dedup():
    def twin(keys, valid):
        s = AB.dedup_scratch(CFG, 3, "cpu")
        AB.dedup_scatter(keys, valid, s)
        return AB.dedup_compact(keys, s, CFG.max_alloc_per_frame)
    return lambda k, v: AB.dedup(CFG, k, v, 3), twin, _keys()


def _k9_insert():
    keys = torch.unique(_keys()[0], dim=0)[:30].contiguous()

    def entry(k):
        info = AB.insert(H.make_table(64, 8), k, 0)
        assert info.pop("count") == k.shape[0]
        return info
    return (entry,
            lambda k: H.insert(H.make_table(64, 8), k,
                               torch.zeros(k.shape[0], dtype=torch.int32)),
            (keys,))


def _coarsen_state():
    st = make_state(64, 8)
    keys = torch.unique(_keys()[0], dim=0)[:6].contiguous()
    info = AB.insert(st.table, keys, 0)
    slots = info["slot"]
    decide = torch.tensor([True, False, True, True, False, True])
    return st, slots, keys, decide


def _k10_coarsen():
    _, slots, keys, decide = _coarsen_state()
    states = [_coarsen_state()[0] for _ in range(3)]   # one a call

    def run(fn):
        def call(s, k, d):
            st = states.pop()
            return fn(CFG, st.table, st.pool, s, k, d)
        return call
    return run(CB.coarsen), run(CB.coarsen_by_variance_ref), (slots, keys,
                                                              decide)


def _sph_cam():
    return C.make_camera(10.0, 10.0, COLS / 2, ROWS / 2, ROWS, COLS, 0.1,
                         5.0, model=C.SPHERICAL)


def _k13_raster():
    return (lambda p: SR.raster_scan(_sph_cam(), p),
            lambda p: SR.raster_scan_ref(_sph_cam(), p), (_points(),))


def _k14_project():
    bpos, _, res = _window(3)
    res[1] = 1
    mapping = SR.raster_scan_ref(_sph_cam(), _points())[1]
    return (lambda *a: SR.project_window(CFG, _sph_cam(), *a),
            lambda *a: SR.project_window_ref(CFG, _sph_cam(), *a),
            (bpos, res, mapping))


CASES = {"K1": _k1, "K2": _k2, "K3": _k3, "K4": _k4, "K5": _k5, "K6": _k6,
         "K7_depth": _k7_depth, "K7_points": _k7_points,
         "K7_K8_dedup": _k8_dedup, "K9_insert": _k9_insert,
         "K10_K12_coarsen": _k10_coarsen, "K13_raster": _k13_raster,
         "K14_project": _k14_project}


def _same(a, b):
    if torch.is_tensor(a):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)


def _meta(x):
    if torch.is_tensor(x):
        return x.to("meta")
    if isinstance(x, tuple) and all(torch.is_tensor(t) for t in x):
        return tuple(t.to("meta") for t in x)
    return x


@pytest.mark.parametrize("case", list(CASES))
def test_entry_takes_the_twin_on_cpu_and_raises_elsewhere(case):
    entry, twin, args = CASES[case]()
    before = dict(COUNTS)
    got = entry(*args)
    launched = {k: COUNTS[k] - before.get(k, 0) for k in COUNTS
                if k != SYNCS and COUNTS[k] != before.get(k, 0)}
    assert not launched, launched
    _same(got, twin(*args))

    before = dict(COUNTS)
    with pytest.raises(ValueError, match="no kernel or twin for meta"):
        entry(*(_meta(a) for a in args))
    assert dict(COUNTS) == before
