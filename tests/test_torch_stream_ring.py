"""Host streaming on a route that returns over streamed ground: GeoWrapper
(device="cpu") walking laps of benchmark/scene_kinds/corridor_ring.py's
office ring on a pool that streams, against the plain reference's replay
(benchmark/reference/replay.py, plain torch, which imports neither JAX nor
the port and never streams) and against the port's own map on a pool that
never streams, compared through the benchmark's compare.map_content and
compare.compare with every number 0.

Scene: benchmark/configs/replica_rgbd_stream.json at a CPU size: a 24x40
pinhole camera with the configuration's field of view narrowed to
tan 0.74 x 0.44, a 1.5 m range, 5 cm voxels, a pool of 192 blocks, and a
ring of 8 m sides walked at 0.2 m a frame (150 frames a lap) for 330
frames.  On a ring of 4 m sides the keep radius (about 4 m at 5 cm
voxels, GeoWrapper._protect_radius) would cover the whole ring, and
nothing would stream.  A split of 16 high blocks when the low heap runs
short covers a frame's coarsening, held to 128 blocks, as the
configuration's 1,024-block split covers its 8,192.

- the union of the card's map and the host grid equals the replay and the
  port's map on a pool of 4,096 blocks, block for block;
- the walk streams out at least 3 times and brings blocks back over
  revisited ground, and no key is on the card and in the grid at once
  after any frame whose stream-out has landed;
- last_stats' stream counters equal the Streamer's events;
- on a straight walk the frame step syncs as often with a host grid that
  holds far chunks as with an empty one.
"""
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import compare  # noqa: E402
import program  # noqa: E402
import scenes  # noqa: E402
from reference import replay  # noqa: E402

from mrhash_tpu_torch import params as P  # noqa: E402
from mrhash_tpu_torch.utils.profiler import COUNTS, SYNCS  # noqa: E402

SEED = 2**31 + 23
N = 330
POOL, BIG = 192, 1 << 12


def load(name):
    with open(os.path.join(BENCH, name)) as f:
        return json.load(f)


def ring_conf(num_blocks=POOL):
    conf = load("configs/replica_rgbd_stream.json")
    conf["sensor"].update(rows=24, cols=40, fx=27.0, fy=27.0, cx=19.5,
                          cy=11.5, max_depth=1.5)
    conf["map"].update(max_depth=1.5, virtual_voxel_size=0.05,
                       sdf_truncation=0.15, num_blocks=num_blocks,
                       num_buckets=1 << 12, max_active_blocks=1 << 12,
                       max_alloc_per_frame=1024)
    conf["map_config"] = {"low_split_chunk": 16, "max_coarsen_per_frame": 128}
    return conf


@functools.lru_cache(maxsize=None)
def ring_frames():
    ring = load("traffic/ring.json")
    ring.update(side_m=8.0, door_every_m=2.0, step_m=0.2, wobble_frames=5)
    return scenes.make(ring, ring_conf()["sensor"], SEED, "cpu")


def keys_of(codes_by_res):
    return set(np.concatenate([codes_by_res[0][0], codes_by_res[1][0]]))


def card_and_grid_keys(gw):
    """(key codes on the card, key codes in the host grid, copies in the
    grid beyond the first of each key)."""
    t = gw.state.table
    occ = t.ptr != P.FREE_ENTRY
    card = set(compare.key_codes(t.pos[occ].numpy()))
    chunks = list(gw.streamer.grid.chunks.values())
    grid = (compare.key_codes(np.concatenate([c["pos"] for c in chunks]))
            if chunks else np.zeros(0, np.int64))
    return card, set(grid), grid.size - len(set(grid))


@functools.lru_cache(maxsize=None)
def streamed_run():
    """The walk on the pool that streams: (union map, stream counts, each
    frame's last_stats, the Streamer's out, in and joined events up to the
    last frame, frames checked for keys held twice, keys held twice)."""
    conf, frames = ring_conf(), ring_frames()
    gw = program.build(conf, frames, "cpu")
    stats, checked, twice = [], 0, 0
    for i in range(N):
        stats.append(dict(program.feed(gw, frames, i)))
        if not gw.streamer.busy():
            card, grid, dups = card_and_grid_keys(gw)
            checked += 1
            twice += len(card & grid) + dups
    st = gw.streamer
    events = (list(st.out_events), list(st.in_events),
              list(getattr(st, "joined", [])))
    program.close(gw)
    got, streams = program.read_map(gw)
    return got, streams, stats, events, checked, twice


@pytest.fixture
def streamed(tmp_path_factory):
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("ring"))   # the memory report
    try:
        return streamed_run()
    finally:
        os.chdir(cwd)


def assert_equal_maps(got, want):
    numbers = compare.compare(got, want)
    assert numbers["ref_blocks"] > 0
    for k in ("blocks_apart", "weight_apart", "sdf_gap", "rgb_apart"):
        assert numbers[k] == 0.0, numbers
    return numbers


def test_streamed_map_equals_the_replay(streamed):
    got, streams, *_ = streamed
    assert got["dups"] == 0
    want = replay.replay(ring_conf(), ring_frames(), N, "cpu",
                         compare.map_content)
    assert_equal_maps(got, want)
    assert streams["host_blocks"] > 0


def test_streamed_map_equals_a_pool_that_never_streams(streamed, tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = streamed[0]
    gw = program.build(ring_conf(BIG), ring_frames(), "cpu")
    for i in range(N):
        program.feed(gw, ring_frames(), i)
    program.close(gw)
    whole, streams = program.read_map(gw)
    assert streams["events"] == 0
    assert keys_of(whole) == keys_of(got)
    assert_equal_maps(got, whole)


def test_the_ring_streams_out_and_back_in_without_holding_a_key_twice(
        streamed):
    _, streams, stats, (out, ins, _), checked, twice = streamed
    assert streams["events"] >= 3 and streams["blocks_out"] > 0
    # blocks come back on the second lap, over ground streamed out on the
    # first
    lap = ring_frames().n * 4
    assert sum(s["streamed_in"] for s in stats[lap:]) > 0
    assert all(e["clashed"] == 0 and e["kept"] == 0 for e in ins), ins
    assert checked > N // 2 and twice == 0
    # no cap of coarsening or GC left a decision for a later frame
    assert not any(s["coarsen_unserved"] or s["gc_unserved"] for s in stats)


def test_last_stats_stream_counters_equal_the_streamers_events(streamed):
    _, _, stats, (out, ins, joined), _, _ = streamed
    assert sum(s["streamed_out"] for s in stats) == sum(
        e["blocks"] for e in out)
    assert sum(s["streamed_out_voxels"] for s in stats) == sum(
        e["voxels"] for e in out)
    assert sum(s["streamed_in"] for s in stats) == sum(
        e["inserted"] for e in ins)
    assert sum(s["stream_clashed"] for s in stats) == sum(
        e["clashed"] for e in ins) == 0
    # a refill streams out within the step: an event of its own
    refills = sum(s["stream_refills"] for s in stats)
    assert 0 <= refills <= len(out)
    assert sum(s["stream_joined"] for s in stats) == len(joined) > 0
    assert sum(s["stream_ingest_ms"] for s in stats) == pytest.approx(
        sum(e["ingest_ms"] for e in joined))
    for e in out:
        # 512 voxels a res-0 block and 64 a res-1 block
        res1, rest = divmod(512 * e["blocks"] - e["voxels"], 448)
        assert rest == 0 and 0 <= res1 <= e["blocks"], e


def test_a_grid_of_far_chunks_adds_no_sync_on_a_straight_walk(tmp_path,
                                                              monkeypatch):
    """The first side's straight (frames 0-30) with an empty host grid,
    and with a grid that holds blocks 100 m away: the same syncs a frame,
    inside and around the frame step, and nothing comes back.  A first
    walk with an empty grid goes before: the process's first frame step
    syncs twice more (a one-time set-up)."""
    monkeypatch.chdir(tmp_path)
    frames = ring_frames()
    counted = []
    for far in (False, False, True):
        gw = program.build(ring_conf(BIG), frames, "cpu")
        if far:
            n = 3
            pos = np.array([[250, 0, 250 + k] for k in range(n)], np.int32)
            z = np.zeros((n, 512), np.float32)
            gw.streamer.grid.add_blocks(
                pos * P.SDF_BLOCK_SIZE * 0.05, pos, np.zeros(n, np.int32),
                z, z, z.astype(np.int32), z.astype(np.int32))
        syncs = []
        for i in range(30):
            c0 = COUNTS[SYNCS]
            s = program.feed(gw, frames, i)
            syncs.append((COUNTS[SYNCS] - c0, s["host_syncs"]))
        assert gw.streamer.grid.num_blocks() == (3 if far else 0)
        assert not gw.streamer.in_events
        counted.append(syncs)
        program.close(gw)
    assert counted[1] == counted[2]
    assert all(a > 0 for a, _ in counted[1])


def test_a_frame_that_runs_the_heap_dry_refills_and_places_every_key():
    """ops/integrate.py::alloc_blocks on a table of 32 blocks that holds
    28: 20 fresh keys find 4 free blocks.  Without a refill 16 keys are
    left out; with MapState.refill's role played by a function that frees
    17 old entries (as a stream-out frees far blocks), every key goes in,
    and the refill is asked once, the heap holding a block after it."""
    from mrhash_tpu_torch.core.state import MapConfig
    from mrhash_tpu_torch.ops import hashtable as H
    from mrhash_tpu_torch.ops import integrate as I

    cfg = MapConfig(num_blocks=32, num_buckets=64, max_alloc_per_frame=64)
    old = torch.tensor([[k, 0, 0] for k in range(28)], dtype=torch.int32)
    fresh = torch.tensor([[k, 5, 0] for k in range(20)], dtype=torch.int32)
    codes = set(compare.key_codes(fresh.numpy()))
    for refilled in (False, True):
        table = H.make_table(32, 64, "cpu")
        slots = H.insert(table, old, torch.zeros(28, dtype=torch.int32))[
            "slot"]
        assert table.high_count == 4
        calls = []

        def refill():
            calls.append(table.high_count)
            if len(calls) > 1:
                return False
            H.free_slots(table, slots[:17])
            return True
        submitted, drawn = I.alloc_blocks(
            cfg, table, fresh, torch.ones(20, dtype=torch.bool), 3,
            refill=refill if refilled else None)
        occ = table.ptr != P.FREE_ENTRY
        held = codes & set(compare.key_codes(table.pos[occ].numpy()))
        assert submitted == 20
        if refilled:
            assert calls == [0] and len(held) == 20 and drawn == 20
        else:
            assert len(held) == 4 and drawn == 4
