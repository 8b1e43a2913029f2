"""Coarsening on the card: kernels K10-K12 (ops/coarsen_blocks.py,
csrc/coarsen_blocks.cu) against their plain PyTorch twin, and the window
that keeps the entries coarsening freed.

The CPU cases hold the frame step's window after coarsening: it keeps
its entries and carries the freed mask (core/pipeline.py::_coarsen),
where the step used to drop the freed entries with a pick of each window
tensor.  On a real coarsening frame of each path, the mask gives what the
picked window gave: the stats' res-0 count, GC's freed blocks (on K1's
flags in the RGB-D step, on the pool in the point-centric LiDAR step)
and a starve after the coarsening on the same frame, pool and table
equal bit for bit.  Another case holds the CPU's coarsen_blocks.coarsen to
the twin (no kernel launch counted).

The `gpu` cases (`python -m pytest --noconftest -m gpu
tests/test_torch_coarsen_blocks.py` on a machine with a card) run the
kernels and the twin (coarsen_by_variance_ref, on the card) from the
same map, tests/test_torch_multires.py's 64x256 scene fused at one
resolution for two frames, and hold equal the served entries (the coarse
blocks' slots, which were inserted, the freed mask), the table (pos,
ptr, res, fp), both heaps and their counts, and the pool's weight and
colour bit for bit, its sdf within 2e-5 and sumsq within 5e-4 (the
merge sums the 8 children in another order; the tolerances of the merge
against the JAX package, tests/test_torch_multires.py).  Cases: the low
heap short, so the split pops the ids just freed and coarse blocks land
in rows that were fine a moment before; max_coarsen_per_frame cutting
the decisions, with the low heap long enough (no split); nothing
decided; coarsen_downsample False.  Each coarsening step on the card
makes two counted host reads and one launch of each kernel, or, where
nothing is served, K10's launch and read alone.
"""
import dataclasses

import pytest
import torch

import test_torch_lidar as LI
import test_torch_multires as MR
from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core import pipeline
from mrhash_tpu_torch.core.state import MapConfig, MapState, make_state
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import coarsen_blocks as CB
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.ops import integrate as I
from mrhash_tpu_torch.utils.profiler import COUNTS, SYNCS

KERNELS = ("coarsen_select", "coarsen_merge", "coarsen_scatter",
           "alloc_insert")
TABLE = ("pos", "ptr", "res", "fp", "heap_high", "heap_low")
FIELDS = ("sdf", "sumsq", "weight", "rgbp")
TOL = dict(sdf=2e-5, sumsq=5e-4)


def _clone(state):
    t = state.table
    table = H.HashTable(**{k: v.clone() if torch.is_tensor(v) else v
                           for k, v in vars(t).items()})
    pool = type(state.pool)(**{f: getattr(state.pool, f).clone()
                               for f in FIELDS})
    return MapState(table=table, pool=pool, frame=state.frame)


def _same_state(a, b, exact=FIELDS):
    for f in TABLE:
        assert torch.equal(getattr(a.table, f), getattr(b.table, f)), f
    assert (a.table.high_count, a.table.low_count) == (
        b.table.high_count, b.table.low_count)
    gaps = {}
    for f in FIELDS:
        x, y = getattr(a.pool, f), getattr(b.pool, f)
        if f in exact:
            assert torch.equal(x, y), f
        else:
            gaps[f] = float((x - y).abs().max())
            assert gaps[f] <= TOL[f], (f, gaps[f])
    return gaps


# ---------------------------------------------------------------------------
# the window after coarsening (CPU)
# ---------------------------------------------------------------------------

def _rgbd_coarsening_frame():
    """tests/test_torch_multires.py's RGB-D scene, coarsening held to 16
    blocks a frame so that decisions stand on every frame, through frame
    2; then frame 3 (a starve frame) up to its coarsening.  Returns (cfg,
    state, cam, window, gc_decision, freed)."""
    cfg = dataclasses.replace(MapConfig(**MR.KW), max_coarsen_per_frame=16)
    frames, rgb = MR._rgbd_frames(translate=True)
    state = make_state(cfg.num_blocks)
    for frame in frames[:3]:
        state, _ = MR._port_rgbd_step(cfg, state, frame, rgb)
    d, rot, t = frames[3]
    cam = C.with_pose(C.make_camera(*MR.CAM), rot, t)
    pc = C.get_depth(cam, C.compute_cloud(cam, torch.from_numpy(d)))
    keys, valid = AB.alloc_candidates_depth(
        cfg, cam, pc, cfg.dda_steps(float(cfg.max_integration_distance)),
        frame=state.frame)
    I.alloc_blocks(cfg, state.table, keys, valid, state.frame)
    window, _ = I.compact_window(cfg, state.table, cam)
    aux = I.fused_integrate_depth(cfg, state.pool, cam, pc,
                                  torch.from_numpy(rgb), *window[1:])
    _, freed = pipeline._coarsen(cfg, state, window, aux["coarsen_decide"])
    return cfg, state, cam, window, aux["gc_decision"], freed


def _points_coarsening_frame():
    """tests/test_torch_lidar.py's scans through the point-centric walk
    (starvation every 2 scans), multi-res with coarsening held to 16
    blocks a scan, through scan 1; then scan 2 (a starve scan) up to its
    coarsening.  Returns as _rgbd_coarsening_frame, with GC's decision
    left to the pool (None)."""
    cfg = MapConfig(**dict(LI.CFG, sdf_var_threshold=1.0,
                           n_frames_invalidate_voxels=2,
                           projective_sdf=False, max_coarsen_per_frame=16))
    scans = LI._frames()
    state = make_state(cfg.num_blocks, cfg.num_buckets)
    for i in range(2):
        state, _ = pipeline.integrate_points(
            cfg, state, LI._port_cam(scans[i][0]),
            torch.from_numpy(scans[i][1]), torch.from_numpy(LI._normals(i)))
    cam, pts = LI._port_cam(scans[2][0]), torch.from_numpy(scans[2][1])
    normals = torch.from_numpy(LI._normals(2))
    mdist = float(cfg.max_integration_distance)
    keys, valid = AB.alloc_candidates_points(cfg, cam, pts,
                                            cfg.dda_steps(mdist), normals)
    I.alloc_blocks(cfg, state.table, keys, valid, state.frame)
    window, _ = I.compact_window(cfg, state.table)
    I.integrate_points_sdf(cfg, state.table, state.pool, cam, pts, normals,
                           None, cfg.dda_voxel_steps(mdist), window)
    decide = I.coarsen_decide(cfg, state.pool, *window[2:])
    _, freed = pipeline._coarsen(cfg, state, window, decide)
    return cfg, state, cam, window, None, freed


@pytest.mark.parametrize("path", ["rgbd", "points"])
def test_freed_mask_equals_the_picked_window(path):
    """The starve, GC and res-0 count over the window with the freed mask
    against the same over the window with the freed entries picked out,
    as the step did before."""
    make = _rgbd_coarsening_frame if path == "rgbd" else \
        _points_coarsening_frame
    cfg, state, cam, window, gc_flags, freed = make()
    assert freed is not None and 0 < int(freed.sum()) < freed.shape[0]
    keep = ~freed
    picked = tuple(t[keep] for t in window)
    a, b = _clone(state), _clone(state)
    before = a.pool.weight.clone()

    # the picked window, as the step had it
    I.starve_voxels(cfg, a.pool, cam, *picked[1:])
    dec_a = (gc_flags[keep] if gc_flags is not None
             else I.gc_decide(cfg, cam, a.pool, *picked[2:]))
    gc_a = I.garbage_collect_sweep(cfg, a.table, a.pool, picked[0], dec_a)
    # the whole window and the mask
    I.starve_voxels(cfg, b.pool, cam, *window[1:], skip=freed)
    dec_b = (gc_flags if gc_flags is not None
             else I.gc_decide(cfg, cam, b.pool, *window[2:]))
    gc_b = I.garbage_collect_sweep(cfg, b.table, b.pool, window[0],
                                   pipeline._kept(dec_b, freed))

    assert not torch.equal(before, a.pool.weight), "nothing starved"
    assert gc_a == gc_b
    _same_state(a, b)
    res0 = pipeline._stats(b, 0, window[3], freed=freed)["res0_blocks"]
    assert res0 == int((picked[3] == 0).sum()) > 0
    assert res0 < int((window[3] == 0).sum())
    print(f"{path}: {int(freed.sum())} freed of {freed.shape[0]}, GC freed "
          f"{gc_a}, {res0} res-0 entries stay")


def test_coarsen_on_cpu_takes_the_twin():
    """CB.coarsen on CPU tensors is coarsen_by_variance_ref: the
    same result and no kernel launch."""
    cfg, state, slots, bpos, decide = _single_res_map("cpu", 50)
    twin = _clone(state)
    n0 = {k: COUNTS[k] for k in KERNELS}
    got = CB.coarsen(cfg, state.table, state.pool, slots, bpos,
                                decide)
    ref = CB.coarsen_by_variance_ref(cfg, twin.table, twin.pool, slots, bpos,
                                    decide)
    assert {k: COUNTS[k] - n0[k] for k in KERNELS} == dict.fromkeys(
        KERNELS, 0)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    _same_state(state, twin)
    assert int(got[2].sum()) == 50 and bool(got[1].all())


# ---------------------------------------------------------------------------
# the kernels against the twin (card)
# ---------------------------------------------------------------------------

def _single_res_map(device, cap, **kw):
    """The 64x256 scene fused at one resolution for two frames (an empty
    low heap), then the window and the coarsening decisions of frame 2's
    camera under the multi-res threshold, at most `cap` served a step.
    Returns (cfg, state, slots, bpos, decide)."""
    cfg = MapConfig(**dict(MR.KW, sdf_var_threshold=0.0))
    frames, rgb = MR._rgbd_frames(translate=False)
    state = make_state(cfg.num_blocks, device=device)
    for d, rot, t in frames[:2]:
        cam = C.with_pose(C.make_camera(*MR.CAM, device=device), rot, t)
        state, _ = pipeline.integrate_rgbd(cfg, state, cam,
                                           torch.from_numpy(d).to(device),
                                           torch.from_numpy(rgb).to(device))
    cfg = dataclasses.replace(cfg, sdf_var_threshold=MR.KW[
        "sdf_var_threshold"], max_coarsen_per_frame=cap, **kw)
    cam = C.with_pose(C.make_camera(*MR.CAM, device=device), *frames[2][1:])
    slots, bpos, bptr, bres = I.compact_active(cfg, state.table, cam)
    decide = I.coarsen_decide(cfg, state.pool, bptr, bres)
    assert int(decide.sum()) > 100 and state.table.low_count == 0
    return cfg, state, slots, bpos, decide


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _step(cfg, state, twin, slots, bpos, decide, exact=("weight", "rgbp")):
    """One coarsening step through the kernels on `state` and through the
    twin on `twin`; both equal.  Returns (new_slots, new_mask, freed) and
    the pool's largest sdf and sumsq gaps."""
    n0 = {k: COUNTS[k] for k in KERNELS}
    s0 = COUNTS[SYNCS]
    counts, counts_ref = {}, {}
    got = CB.coarsen(cfg, state.table, state.pool, slots, bpos,
                                decide, counts)
    syncs = COUNTS[SYNCS] - s0
    launches = {k: COUNTS[k] - n0[k] for k in KERNELS}
    ref = CB.coarsen_by_variance_ref(cfg, twin.table, twin.pool, slots, bpos,
                                    decide, counts_ref)
    torch.cuda.synchronize()
    for name, g, r in zip(("new_slots", "new_mask", "freed"), got, ref):
        assert torch.equal(g, r), name
    gaps = _same_state(state, twin, exact)
    served = int(got[2].sum())
    # the decisions the cap left for a later frame, from K10's own read
    assert counts == counts_ref == dict(unserved=int(decide.sum()) - served)
    assert syncs == (2 if served else 1), syncs
    want = dict(coarsen_select=1, coarsen_merge=int(served > 0),
                coarsen_scatter=int(served > 0 and cfg.coarsen_downsample),
                alloc_insert=int(served > 0))
    assert launches == want, launches
    return got, gaps


def _rows(ptr):
    return set((ptr.to(torch.int64) // P.TOTAL_SDF_BLOCK_SIZE).tolist())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["split", "cap", "none", "no_downsample"])
def test_kernels_match_the_twin_on_card(cuda, case):
    # "split": a chunk of 13 high blocks (104 low ids) for 100 served
    # keys, so the split pops only ids the step just freed
    kw = dict(split=dict(low_split_chunk=13),
              no_downsample=dict(coarsen_downsample=False)).get(case, {})
    cfg, state, slots, bpos, decide = _single_res_map(cuda, 100, **kw)
    twin = _clone(state)
    if case == "none":
        decide = torch.zeros_like(decide)
    fine = _rows(state.table.ptr[slots[decide]][:100])
    (new_slots, new_mask, freed), gaps = _step(cfg, state, twin, slots,
                                               bpos, decide)
    if case == "none":
        assert new_slots.numel() == 0 and not bool(freed.any())
        return
    assert int(freed.sum()) == 100 and bool(new_mask.all())
    coarse = state.table.ptr[new_slots]
    assert bool((state.table.res[new_slots] == 1).all())
    if case == "split":
        # every coarse block in a row that was fine before the step, whose
        # fine data the merge read first
        assert _rows(coarse) <= fine
    lanes = torch.arange(P.TOTAL_LOW_BLOCK_SIZE, device=cuda)
    w1 = state.pool.weight.view(-1)[
        (coarse.to(torch.int64)[:, None] + lanes).reshape(-1)]
    assert (int(w1.sum()) > 0) == cfg.coarsen_downsample
    if case == "cap":
        # a second step on the same window's later decisions: the low heap
        # holds enough ids, so no split; 7 of them served
        cfg = dataclasses.replace(cfg, max_coarsen_per_frame=7)
        low = state.table.low_count
        later = decide & ~freed
        (_, new_mask, freed), gaps = _step(cfg, state, twin, slots, bpos,
                                           later)
        assert int(later.sum()) > 7 and int(freed.sum()) == 7
        assert bool(new_mask.all()) and state.table.low_count == low - 7
    print(f"{case}: sdf gap {gaps['sdf']:.3g}, sumsq gap "
          f"{gaps['sumsq']:.3g}")
