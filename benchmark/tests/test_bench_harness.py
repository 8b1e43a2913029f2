"""The harness end to end on the CPU at a tiny size: the result line, the
port's plain path against the reference, the faults the comparison must
catch, the control, and a configuration, mix, per-layer metric and cell
added as files alone."""
import json
import os

import control
import harness
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
