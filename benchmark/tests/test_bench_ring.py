"""The cell replica_rgbd_stream.ring on the CPU at a tiny size, through
harness.run_cell from a shrunk copy (tests/test_torch_stream_ring.py's
walk: a 24x40 camera, a 1.5 m range, 5 cm voxels, a pool of 192 blocks,
a ring of 8 m sides at 0.2 m a frame, 240 warm-up frames, every limit 0):
a sound run is correct with every number 0 and streams out and back in;
a stream-in gated by the watermark again (the frames map fresh blocks
over host ground, whose copies then stay in the grid as further copies),
the same with those host copies skipped, as the reference's stream-in
skips a resident key (the history lost), and a streamed block dropped
from the grid come out not correct.  Then the cell's five readers on a
recorded trace, and on one of a program without the new ranges and
counters."""
import json
import os

import harness
import pytest
import tracing

CELL = "replica_rgbd_stream.ring"
SEED = 2**31 + 37


def shrink_ring(base):
    def edit(path, fn):
        with open(path) as f:
            d = json.load(f)
        fn(d)
        with open(path, "w") as f:
            json.dump(d, f)

    def conf(c):
        c["sensor"].update(rows=24, cols=40, fx=27.0, fy=27.0, cx=19.5,
                           cy=11.5, max_depth=1.5)
        c["map"].update(max_depth=1.5, virtual_voxel_size=0.05,
                        sdf_truncation=0.15, num_blocks=192,
                        num_buckets=1 << 12, max_active_blocks=1 << 12,
                        max_alloc_per_frame=1024)
        c["map_config"] = {"low_split_chunk": 16,
                           "max_coarsen_per_frame": 128}
    edit(os.path.join(base, "configs", "replica_rgbd_stream.json"), conf)
    edit(os.path.join(base, "traffic", "ring.json"), lambda t: t.update(
        side_m=8.0, door_every_m=2.0, step_m=0.2, wobble_frames=5,
        warmup_frames=240, trace_frames=3))
    with open(os.path.join(base, "limits", f"{CELL}.json"), "w") as f:
        json.dump({k: 0.0 for k in ("blocks_apart", "weight_apart",
                                    "sdf_gap", "rgb_apart")}, f)


@pytest.fixture
def ring(tiny):
    shrink_ring(tiny[1])
    return tiny


def streams_logged(err):
    """(stream-out events, blocks streamed back in) from the log."""
    w = next(x for x in err.splitlines() if x.startswith("streams: ")).split()
    return int(w[1]), int(w[7])


def test_a_sound_ring_is_correct_and_streams_both_ways(ring, capsys):
    bench, base = ring
    r = harness.run_cell(bench, CELL, SEED, 0.0, 0, "cpu", base=base)
    events, back_in = streams_logged(capsys.readouterr().err)
    assert events >= 3 and back_in > 0
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {"frame_ms_p95", "peak_mem_gib", "setup_s"}
    for c in r["checks"].values():
        assert c["value"] == 0.0


def gated(gw):
    """The parent's trigger: stream-in only inside the watermark's
    stream, at the camera, after the stream-out."""
    from mrhash_tpu_torch import params as P
    need = min(int(P.STREAM_TARGET * gw.cfg.num_blocks) - gw._high_free,
               4096, gw.streamer.staging)
    gw.state = gw.streamer.stream(gw.state, gw.curr_trans,
                                  gw._protect_radius(), budget=max(need, 0),
                                  asynchronous=True)
    gw._high_free = gw.state.table.high_count


def drop_one(real):
    """The host grid's ingest, losing the first block of every call."""
    def add_blocks(self, block_world, pos, res, *fields):
        return real(self, block_world[1:], pos[1:], res[1:],
                    *(f[1:] for f in fields))
    return add_blocks


def placed(real):
    """insert_blocks reporting every block placed: a host copy whose key
    is resident is skipped, and dropped, as the reference's stream-in
    does."""
    def insert_blocks(*a, **k):
        present, slot, new = real(*a, **k)
        return present | True, slot, new
    return insert_blocks


@pytest.mark.parametrize("fault", ["gated", "dropped", "skipped"])
def test_streaming_faults_come_out_not_correct(ring, monkeypatch, capsys,
                                               fault):
    from mrhash_tpu_torch import geowrapper
    from mrhash_tpu_torch.core import streaming
    bench, base = ring
    gw = geowrapper.GeoWrapper
    if fault in ("gated", "skipped"):
        monkeypatch.setattr(gw, "_bring_back", lambda self: None)
        monkeypatch.setattr(gw, "_stream", gated)
    if fault == "skipped":
        monkeypatch.setattr(streaming, "insert_blocks",
                            placed(streaming.insert_blocks))
    if fault == "dropped":
        monkeypatch.setattr(streaming.ChunkGrid, "add_blocks",
                            drop_one(streaming.ChunkGrid.add_blocks))
    r = harness.run_cell(bench, CELL, SEED, 0.0, 0, "cpu", base=base)
    assert streams_logged(capsys.readouterr().err)[0] >= 1
    assert r["correct"] is False, r["checks"]


def ev(name, ts, dur, cat="user_annotation", corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def read(base, name, trace):
    return harness.load_reader(base, name)(trace)


NAMES = ("stream.out_ms", "stream.in_ms", "stream_blocks_per_frame",
         "stream.ingest_ms", "stream.gather.roofline_pct")


@pytest.mark.parametrize("new_program", [True, False])
def test_the_cells_readers_on_a_recorded_trace(new_program):
    """Four frames of 100 us: frame 1 streams out (stream.out over 20 us,
    its gather launching a 10 us kernel), frame 2 streams in (stream.in
    over 8 us) and joins the event; without the new program, none of the
    ranges and counters."""
    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(base, "configs", "replica_rgbd_stream.json")) as f:
        conf = json.load(f)
    events = [ev(tracing.WINDOW, 0, 400)]
    for f in range(4):
        events += [ev(tracing.FRAME, 100 * f, 100),
                   ev("compute", 100 * f + 40, 50)]
    if new_program:
        events += [ev("stream.out", 110, 20), ev("stream.gather", 112, 6),
                   ev("cudaLaunchKernel", 113, 1, "cuda_runtime", 7),
                   ev("gather", 114, 10, "kernel", 7),
                   ev("stream.in", 205, 8)]
    zero = dict(streamed_out=0, streamed_out_voxels=0, streamed_in=0,
                stream_joined=0, stream_ingest_ms=0.0)
    stats = [dict(zero) for _ in range(4)]
    stats[1].update(streamed_out=100, streamed_out_voxels=100 * 512)
    stats[2].update(streamed_in=60, stream_joined=1, stream_ingest_ms=12.5)
    if not new_program:
        stats = [{} for _ in range(4)]
    tr = tracing.Trace(events, 4, stats, conf)
    got = {n: read(base, n, tr) for n in NAMES}
    if not new_program:
        assert got == {n: None for n in NAMES}
        return
    assert got["stream.out_ms"] == pytest.approx(20 / 1e3)
    assert got["stream.in_ms"] == pytest.approx(8 / 1e3 / 4)
    assert got["stream_blocks_per_frame"] == pytest.approx(160 / 4)
    assert got["stream.ingest_ms"] == pytest.approx(12.5)
    least = 3 * 16 * 100 * 512 / 3.35e12
    assert got["stream.gather.roofline_pct"] == pytest.approx(
        100 * least / 10e-6)
