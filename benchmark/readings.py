#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, for one cell, in
one process: for each seed, the cell's inputs and a warm-up call, then a
short window of the program and, on the first --fault-seeds seeds, of the
control (the plain PairHMM in bfloat16 in the kernels' place) and of each
fault (half of each launch's pairs left out and the mean of the rest put in
their place; every record altered where the VCF writer writes it). One JSON
line per window with the numbers compared.

    python3 benchmark/readings.py --workload hc_wgs30x.vcf --seeds 11,12,13 --seconds 12

The benchmark's own runs (run.py) never run the control or a fault.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--modes", default="control,half_batch,records_altered")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from yardstick import catalog, core

    cell = catalog.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    for k, seed in enumerate(seeds):
        tmp = tempfile.mkdtemp(prefix="readings-")
        try:
            sample, _ = core.setup(cell, seed, args.device, tmp)
            modes = ["program"] + (args.modes.split(",") if k < args.fault_seeds else [])
            for mode in modes:
                t0 = time.perf_counter()
                cap = core.Capture(seed, mode=mode)
                run = core.window(cell, sample, args.seconds, args.device, tmp, cap,
                                  alter_records=mode == "records_altered")
                correct, nums, rows, _ = core.judge_run(cell, sample, run, cap, seed, args.device)
                print(json.dumps(dict(workload=args.workload, seed=seed, mode=mode,
                                      calls=len(run.calls), correct=correct, numbers=nums,
                                      failed=[n for n, _, _, ok in rows if not ok],
                                      wall_s=time.perf_counter() - t0)), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
