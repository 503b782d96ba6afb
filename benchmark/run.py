#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of BENCHMARK.json on one card.

    python3 benchmark/run.py --workload hc_wgs30x.vcf --seed 7 --seconds 40 --trace 0

Run from the root of a checkout that holds gatk_tpu_torch. The numeric
runtimes run one thread each (OMP_NUM_THREADS and the like). Set-up (the CUDA
context, the kernels from the checkout's build directory, the cell's inputs
from --seed under TMPDIR, one warm-up call) ends where the window starts;
the window runs the cell's tool over the shards of its pool for --seconds;
then the run judges what the window's calls wrote and prints, last on
standard output, one JSON line: with --trace 0 the cell's end-to-end metrics,
with --trace 1 its per-layer metrics, read from a torch.profiler trace of the
window. The numbers compared for `correct` go last on standard error too.
Exits non-zero, with no result, without enough CUDA devices, or when the run
has loaded jax, jaxlib, flax or gatk_tpu.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the numeric runtimes (OpenMP, so torch's CPU
# ops and the native read scan, and BLAS) get one thread each, whatever the
# host's core count, so that a host whose cores are shared slows a run less
# unevenly; set before torch or numpy is imported
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from yardstick import catalog

    cell = catalog.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    from yardstick import core, runner

    result, rows = runner.execute(args.workload, args.seed, args.seconds, bool(args.trace),
                                  T_START, cell=cell)
    found = core.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, value, limit, ok in rows:
        print(f"check {name} {value} limit {limit} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
