"""The benchmark of mrhash_tpu_torch on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

One process runs one cell of BENCHMARK.json once and prints, as the last
line of standard output, one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device, with --trace 1 breakdown, and last the numbers compared
with the reference beside their limits (also the last lines of standard
error).  It exits non-zero, printing no result, when no CUDA card is
present, and when jax, jaxlib, flax or mrhash_tpu is loaded once the
window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("benchmark: no CUDA device; the benchmark runs on the card "
                 "only")
    bench = os.path.join(ROOT, "BENCHMARK.json")
    with open(bench) as f:
        chips = next((w["chips"] for w in json.load(f)["workloads"]
                      if w["name"] == args.workload), 1)
    if torch.cuda.device_count() < chips:
        sys.exit(f"benchmark: {args.workload} needs {chips} cards, "
                 f"{torch.cuda.device_count()} present")
    sys.path[:0] = [ROOT, HERE]
    import harness
    try:
        smi = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi: {e}"
    harness.log(f"card: {smi}; torch {torch.__version__}, CUDA "
                f"{torch.version.cuda}")
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              args.trace, "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        sys.exit(f"benchmark: loaded {found}; the port must not load JAX or "
                 "the JAX package")
    harness.log(f"correct: {result['correct']}")
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
