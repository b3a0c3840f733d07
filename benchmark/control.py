"""The controls of a cell's comparison, on the card at the cell's own size.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3
    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --fault <name> --seconds 3

Without ``--fault``, prints for each seed one JSON line of the readings
that the cell's checks compare, taken from the cell's runner's controls
(the reference with TF32 on in the program's place; for a training cell
also the reference on half of every batch), judged as a run judges the
program.  With ``--fault``, runs the cell with that fault of
``benchmark/faults.py`` planted in the program and prints the run's
checks.  The benchmark's runs do not run it; the limits in the traffic
files are set between these readings and the runs' own.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark.harness.core import load_cell, runner


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--fault", default=None)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    module = runner(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.fault is None:
            readings = module.control_readings(cell, seed, device)
        else:
            from benchmark.faults import FAULTS

            with FAULTS[args.fault]():
                outcome = module.run(cell, seed, args.seconds, False, device, time.perf_counter())
            readings = {args.fault: {c.name: c.value for c in outcome.checks},
                        "correct": all(c.ok for c in outcome.checks), **outcome.extra}
        print(json.dumps({"workload": cell.name, "seed": seed, **readings}, default=float),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
