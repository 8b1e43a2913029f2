"""The harness end to end on the CPU at a tiny size: the result line, the
port's plain path against the reference, the faults the comparison must
catch, the control, a configuration, mix, per-layer metric and cell
added as files alone, and a street drive that streams to host memory,
with the streaming faults the union of device map and host grid must
catch."""
import json
import os

import control
import harness
import numpy as np
import pytest

CELLS = ("replica_rgbd_mr.orbit", "newer_college_lidar_mr.loop")
SEED = 2**31 + 11


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_and_port_equals_reference(tiny, cell):
    bench, base = tiny
    spec = harness.load_json(bench)
    for trace in (0, 1):
        r = harness.run_cell(bench, cell, SEED, 0.5, trace, "cpu", base=base)
        assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                               "device"] and list(r)[-1] == "checks"
        assert ("breakdown" in r) == bool(trace)
        assert r["correct"] is True and r["failed"] == 0
        assert r["attempted"] >= 1
        assert set(r["device"]) >= {"platform", "kind", "count",
                                    "memory_peak_bytes"}
        want = [m["name"] for m in harness.metrics_of(
            spec, "per_layer" if trace else "end_to_end", cell)]
        if trace:
            assert set(r["device"]) >= {"busy_s", "window_s"}
            got = set(r["metrics"])
            # no card: no device operation, so no roofline share
            assert got == {n for n in want if "roofline" not in n}
        else:
            assert list(r["metrics"]) == want
        for m in r["metrics"].values():
            assert set(m) == {"value", "unit"}
        for c in r["checks"].values():
            assert c["value"] == 0.0        # the same plain path, the CPU
        json.dumps(r)


def no_op(cfg, state, *a, **k):
    """A frame step that returns its state unchanged."""
    from mrhash_tpu_torch.core import pipeline
    return state, pipeline._stats(state, 0, state.table.res[:0])


def half_batch(real):
    """The frame step with the second half of the image rows (or of the
    points) left out: depth 0 and the zero point are no observation."""
    def step(cfg, state, cam, data, *rest):
        data = data.clone()
        data[data.shape[0] // 2:] = 0
        return real(cfg, state, cam, data, *rest)
    return step


def altered(real):
    """The frame step, then one weighted voxel's sdf altered."""
    def step(cfg, state, *a, **k):
        out = real(cfg, state, *a, **k)
        w = state.pool.weight.view(-1)
        i = int((w > 0).nonzero()[0])
        state.pool.sdf.view(-1)[i] += 0.5 * cfg.sdf_truncation
        return out
    return step


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_faults_come_out_not_correct(tiny, monkeypatch, cell, fault):
    from mrhash_tpu_torch.core import pipeline
    bench, base = tiny
    name = "integrate_rgbd" if cell.startswith("replica") else \
        "integrate_points"
    real = getattr(pipeline, name)
    broken = {"unchanged": no_op, "half": half_batch(real),
              "altered": altered(real)}[fault]
    monkeypatch.setattr(pipeline, name, broken)
    # a window of one frame: a step that does nothing would fill a timed
    # window with more frames than the reference can replay here
    r = harness.run_cell(bench, cell, SEED, 0.0, 0, "cpu", base=base)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(tiny, cell):
    bench, base = tiny
    out = control.run(bench, cell, SEED, 12, "cpu", base=base)
    assert out["passed"] is False, out


def test_a_cell_added_as_files_is_found(tiny):
    bench, base = tiny
    spec = harness.load_json(bench)
    with open(os.path.join(base, "configs", "replica_rgbd_mr.json")) as f:
        conf = json.load(f)
    conf["map"]["sdf_var_threshold"] = 0.0
    with open(os.path.join(base, "configs", "replica_rgbd_sr.json"),
              "w") as f:
        json.dump(conf, f)
    with open(os.path.join(base, "traffic", "orbit.json")) as f:
        mix = json.load(f)
    mix.update(orbit=4, wobble_m=[0.0, 0.0])
    with open(os.path.join(base, "traffic", "still.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(base, "metrics", "frames_traced.py"), "w") as f:
        f.write("def read(trace):\n    return trace.frames\n")
    with open(os.path.join(base, "limits", "replica_rgbd_sr.still.json"),
              "w") as f:
        json.dump({"blocks_apart": 0.0, "sdf_gap": 0.0}, f)
    spec["configs"].append(dict(spec["configs"][0], name="replica_rgbd_sr",
                                file="benchmark/configs/replica_rgbd_sr.json"))
    spec["workloads"].append(dict(name="replica_rgbd_sr.still",
                                  config="replica_rgbd_sr", traffic="still",
                                  chips=1, why="added by a test"))
    spec["per_layer"].append(dict(name="frames_traced", unit="frames",
                                  better="higher", source="program_counter",
                                  layer="device", moves="fps",
                                  workloads=["replica_rgbd_sr.still"]))
    with open(bench, "w") as f:
        json.dump(spec, f)
    r = harness.run_cell(bench, "replica_rgbd_sr.still", SEED, 0.3, 1, "cpu",
                         base=base)
    assert r["correct"] is True
    assert r["metrics"]["frames_traced"] == {"value": 3.0,
                                             "unit": "frames"}
    assert "rgbd.coarsen_ms" not in r["metrics"]   # not this cell's
    assert set(r["checks"]) == {"blocks_apart", "sdf_gap"}


@pytest.mark.gpu
@pytest.mark.parametrize("cell,frames", [("replica_rgbd_mr.orbit", 1200),
                                         ("newer_college_lidar_mr.loop",
                                          1400)])
def test_control_fails_on_the_card_at_the_cells_size(cell, frames):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = control.run(os.path.join(root, "BENCHMARK.json"), cell, SEED,
                      frames)
    assert out["passed"] is False, out


def streams_logged(err):
    """(events, blocks out) from the run's log line."""
    line = next(x for x in err.splitlines() if x.startswith("streams: "))
    w = line.split()
    return int(w[1]), int(w[4])


def test_a_drive_that_streams_is_judged_on_device_and_host(drive, capsys):
    bench, base = drive
    r = harness.run_cell(bench, "newer_college_drive.street", SEED, 0.0, 0, "cpu", base=base)
    events, out = streams_logged(capsys.readouterr().err)
    assert events >= 1 and out >= 1
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == {"blocks_apart", "weight_apart", "sdf_gap"}
    for c in r["checks"].values():
        assert c["value"] == 0.0


def drop_one(real):
    """The host grid's ingest, losing the first block of every event."""
    def add_blocks(self, block_world, pos, res, *fields):
        return real(self, block_world[1:], pos[1:], res[1:],
                    *(f[1:] for f in fields))
    return add_blocks


def alter_one(real):
    """The host grid's ingest, the first block's first weighted voxel's
    sdf altered."""
    def add_blocks(self, block_world, pos, res, sdf, ssq, w, rgb):
        sdf = sdf.copy()
        sdf[0, int(np.argmax(w[0] > 0))] += 0.2
        return real(self, block_world, pos, res, sdf, ssq, w, rgb)
    return add_blocks


def keep_one(real):
    """The eviction plan, with the first evicted key put back into the
    table: it stays on the card and goes to the grid too."""
    def plan_evictions(cfg, table, *a, **k):
        from mrhash_tpu_torch.ops import hashtable as H
        pos, ptr, res = real(cfg, table, *a, **k)
        if pos.shape[0]:
            H.insert(table, pos[:1], res[:1])
        return pos, ptr, res
    return plan_evictions


def inside_reach(gw):
    """The stream trigger evicting every block beyond half the sensor's
    range, inside the reach of its scans."""
    gw.state = gw.streamer.stream(gw.state, gw.curr_trans,
                                  0.5 * float(gw.camera.max_depth))
    gw._high_free = gw.state.table.high_count


@pytest.mark.parametrize("fault", ["dropped", "altered", "duplicate",
                                   "inside_reach"])
def test_streaming_faults_come_out_not_correct(drive, monkeypatch, capsys,
                                               fault):
    from mrhash_tpu_torch import geowrapper
    from mrhash_tpu_torch.core import streaming
    bench, base = drive
    grid = streaming.ChunkGrid
    if fault == "dropped":
        monkeypatch.setattr(grid, "add_blocks", drop_one(grid.add_blocks))
    elif fault == "altered":
        monkeypatch.setattr(grid, "add_blocks", alter_one(grid.add_blocks))
    elif fault == "duplicate":
        monkeypatch.setattr(streaming, "plan_evictions",
                            keep_one(streaming.plan_evictions))
    else:
        monkeypatch.setattr(geowrapper.GeoWrapper, "_stream", inside_reach)
    r = harness.run_cell(bench, "newer_college_drive.street", SEED, 0.0, 0, "cpu", base=base)
    assert streams_logged(capsys.readouterr().err)[0] >= 1
    assert r["correct"] is False, r["checks"]


def test_union_counts_each_further_copy_of_a_key():
    """A key on the card and in the host grid, at either resolution, or
    twice in the grid, is one block apart for each further copy, even
    where every copy holds the same voxels."""
    import compare
    rng = np.random.default_rng(5)

    def blocks(pos, res):
        n = len(pos)
        return compare.host_content(
            np.asarray(pos, np.int32), np.asarray(res, np.int32),
            rng.random((n, 512), np.float32), np.zeros((n, 512), np.float32),
            np.ones((n, 512), np.int32), np.zeros((n, 512), np.int32))
    card = blocks([[0, 0, 0], [1, 0, 0], [2, 0, 0]], [0, 0, 1])
    grid = blocks([[3, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]], [0, 1, 1, 0])
    one = compare.union(card, grid)
    assert one["dups"] == 3
    assert one[0][0].size + one[1][0].size == 4
    ref = compare.union(card, blocks([[3, 0, 0]], [0]))
    assert ref["dups"] == 0
    got = compare.compare(one, ref)
    assert got["blocks_apart"] == 3 / 4          # the copies alone
    assert compare.compare(ref, ref)["blocks_apart"] == 0
