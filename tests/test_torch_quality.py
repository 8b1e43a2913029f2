"""The quality protocol through the port on the CPU, against the JAX
package's on the same preset.

tools/quality_eval.py's small preset (120x160, 5 cm voxels, 15 cm
truncation, 12 frames of the orbit, 100,000 evaluation points) runs in both
packages: the port's mrhash_tpu_torch/apps/quality_eval.py with
device="cpu" and the JAX package's tools/quality_eval.run_quality, the
JAX side meshing with extractMesh's host sweep (its "resident" mode takes
minutes on the CPU).  The port is held to
tests/test_quality.py's gates at 5 cm, and every row (each threshold) to
the JAX package's: Chamfer-L1 within 5e-4 m, precision, recall and F-score
within 5e-3.  The two maps differ only where jitted XLA contracts
`voxel * vvs - t` into an FMA (PORT_NOTES.md P4), since the orbit
translates.

- (1) the box room at one resolution (gates: Chamfer < 0.025, F > 0.97,
  P > 0.965);
- (2) the cluttered room with variance coarsening (threshold 1.0, min
  weight 2; gates: Chamfer < 0.028, F > 0.90, P > 0.87), whose map must
  hold res-1 blocks; the port meshes it with extract_mode="resident"
  (GeoWrapper._extract_resident, the device sweep of the map), as
  tests/test_quality.py does the JAX package's.

This file holds exactly two tests: it is the heaviest of the port's
files, and a file of at most two tests sorts at the tail of the Tier-1
run's queue (ROADMAP C1).
"""
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATES = dict(box=(0.025, 0.97, 0.965), clutter=(0.028, 0.90, 0.87))


def _run_both(tmp_path, monkeypatch, scene, multires, extract_mode):
    pytest.importorskip("jax")
    monkeypatch.chdir(tmp_path)     # both GeoWrappers write reports here
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import quality_eval as JQ

    from mrhash_tpu_torch.apps import quality_eval as Q
    torch.set_num_threads(1)
    stats = {}
    got = Q.run_quality(frames=12, res="small", n_eval_points=100_000,
                        mesh_path=str(tmp_path / "port.ply"), scene=scene,
                        multires=multires, extract_mode=extract_mode,
                        device="cpu", stats=stats)
    want = JQ.run_quality(frames=12, res="small", n_eval_points=100_000,
                          mesh_path=str(tmp_path / "ref.ply"),
                          write_json=False, scene=scene, multires=multires)
    assert [r["threshold"] for r in got] == [r["threshold"] for r in want]
    for g, w in zip(got, want):
        assert abs(g["chamfer_l1"] - w["chamfer_l1"]) <= 5e-4, (g, w)
        for k in ("precision", "recall", "fscore"):
            assert abs(g[k] - w[k]) <= 5e-3, (k, g, w)
    r5 = next(r for r in got if r["threshold"] == 0.05)
    chamfer, fscore, precision = GATES[scene]
    assert r5["chamfer_l1"] < chamfer, r5
    assert r5["fscore"] > fscore, r5
    assert r5["precision"] > precision, r5
    return stats


def test_box_room_quality_small_matches_reference(tmp_path, monkeypatch):
    stats = _run_both(tmp_path, monkeypatch, "box", False, "sweep")
    assert stats["vertices"] > 10000, stats


def test_clutter_room_quality_small_multires_matches_reference(
        tmp_path, monkeypatch):
    stats = _run_both(tmp_path, monkeypatch, "clutter", True, "resident")
    diag = stats["recall_miss_diag"]
    assert diag["res1_blocks"] > 100, diag
