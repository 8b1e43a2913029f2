"""Shared fixtures of the benchmark's CPU tests: the harness's folder on
sys.path, a copy of the benchmark shrunk to a size a CPU test holds
(small sensors and pools; the widths of the map, its voxel size,
truncation and thresholds as configured), and the same copy with a street
drive that streams added as files."""
import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [ROOT, BENCH_DIR]


def shrink(base):
    """Shrink the copy at `base`: 17x30 RGB-D frames on an 8-pose orbit,
    8x64 LiDAR scans on a 5-scan lap, pools of 2^14 and 2^12 blocks, 5
    warm-up and 3 traced frames."""
    def edit(path, fn):
        with open(path) as f:
            d = json.load(f)
        fn(d)
        with open(path, "w") as f:
            json.dump(d, f)

    def rgbd(c):
        c["sensor"].update(rows=17, cols=30, fx=15.0, fy=15.0, cx=14.5,
                           cy=8.0)
        c["map"].update(num_blocks=1 << 14, num_buckets=1 << 12,
                        max_active_blocks=1 << 13, max_alloc_per_frame=1024)

    def lidar(c):
        c["sensor"].update(rows=8, cols=64)
        c["map"].update(num_blocks=1 << 12, num_buckets=1 << 10,
                        max_active_blocks=1 << 11, max_alloc_per_frame=1024)
    edit(os.path.join(base, "configs", "replica_rgbd_mr.json"), rgbd)
    edit(os.path.join(base, "configs", "newer_college_lidar_mr.json"), lidar)
    for mix, extra in (("orbit", dict(orbit=8, laps=1)),
                       ("loop", dict(circle_r=0.1))):
        edit(os.path.join(base, "traffic", f"{mix}.json"),
             lambda t: t.update(warmup_frames=5, trace_frames=3, **extra))


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """(BENCHMARK.json path, base folder) of a shrunk copy; the working
    directory is tmp_path (the wrapper writes its memory report there)."""
    base = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shrink(str(base))
    monkeypatch.chdir(tmp_path)
    return str(tmp_path / "BENCHMARK.json"), str(base)


# a drive whose pool of 2^10 blocks reaches the stream watermark within
# the 60 warm-up scans: a 10 m range (so the program keeps the blocks
# within ~33.5 m, its stream radius), 1.6 m a scan, and a split of 64 high
# blocks, not 1,024, when the low heap runs short
DRIVE = "newer_college_drive.street"
STREET = dict(scene="lidar_street", ground_z=-1.73, half_width_m=6.0,
              lot_m=4.8, period_m=9.6, step_m=1.6, setback_m=[0.0, 2.0],
              height_m=[3.0, 9.0], depth_m=6.0, gaps=0, noise_m=0.01,
              warmup_frames=60, trace_frames=3)


def add_drive(bench, base):
    """The street drive as a cell added as files to the tiny copy."""
    with open(bench) as f:
        spec = json.load(f)
    with open(os.path.join(base, "configs",
                           "newer_college_lidar_mr.json")) as f:
        conf = json.load(f)
    conf["sensor"]["max_depth"] = conf["map"]["max_depth"] = 10.0
    conf["map"].update(num_blocks=1 << 10, num_buckets=1 << 10,
                       max_active_blocks=1 << 11, max_alloc_per_frame=1024)
    conf["map_config"] = {"low_split_chunk": 64}
    for path, obj in (("configs/newer_college_drive.json", conf),
                      ("traffic/street.json", STREET),
                      (f"limits/{DRIVE}.json", {"blocks_apart": 0.0,
                                                "weight_apart": 0.0,
                                                "sdf_gap": 0.0})):
        with open(os.path.join(base, path), "w") as f:
            json.dump(obj, f)
    spec["configs"].append(dict(
        spec["configs"][1], name="newer_college_drive",
        file="benchmark/configs/newer_college_drive.json"))
    spec["workloads"].append(dict(name=DRIVE, config="newer_college_drive",
                                  traffic="street", chips=1,
                                  why="added by a test"))
    with open(bench, "w") as f:
        json.dump(spec, f)


@pytest.fixture
def drive(tiny):
    """The tiny copy with the street drive added as files, the cell
    newer_college_drive.street."""
    add_drive(*tiny)
    return tiny
