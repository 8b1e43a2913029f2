"""The control of the comparison that decides `correct`: the plain
reference put in the program's place, with the voxel pool's sdf and sumsq
stored in bfloat16 (the step below the configuration's float32), held to
the cell's limits against the float32 reference on the same frames.  It
has to come out not correct.

    python3 benchmark/control.py --workload <cell> --frames <n> \\
        --seeds <s1> <s2> <s3> [--device cuda]

prints one JSON line per seed: the numbers compared, and whether the
control passed the cell's limits (it must not).  The benchmark's own runs
never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def run(bench_path, cell, seed, n_frames, device="cuda", base=HERE):
    import compare
    import harness
    import scenes
    from reference import replay
    _, _, conf, traffic, limits = harness.load_cell(bench_path, cell, base)
    frames = scenes.make(traffic, conf["sensor"], seed, device)
    t0 = time.perf_counter()
    ref = replay.replay(conf, frames, n_frames, device, compare.map_content)
    low = replay.replay(conf, frames, n_frames, device, compare.map_content,
                        precision="bfloat16")
    numbers = compare.compare(low, ref)
    passed, checks = compare.judge(numbers, limits)
    return dict(cell=cell, seed=seed, frames=n_frames, passed=passed,
                seconds=time.perf_counter() - t0, checks=checks,
                numbers=numbers)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.dirname(HERE), HERE]
    bench = os.path.join(os.path.dirname(HERE), "BENCHMARK.json")
    for seed in args.seeds:
        print(json.dumps(run(bench, args.workload, seed, args.frames,
                             args.device)), flush=True)


if __name__ == "__main__":
    main()
