"""The readings that a cell's limits are set from, several seeds in one
process (the benchmark's own runs never run this):

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 --mode program
    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 --mode control

`program`: the cell's run (`traffic/<driver>.py` `run`) with a short
window on each seed, its compared numbers; `fault`: the same with a
fault of `benchmark/faults.py` planted (`--fault`). `control`: the reference
computed one precision step below the cell's dtype
(`reference/precision.py`: tf32 for float32, fp8 for bfloat16), put in
the program's place and judged the same way
(the driver's `control`). One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from benchmark import run as R


def fault(spec, name):
    """The planted fault `name`, or nothing."""
    import contextlib

    from benchmark import faults

    if name is None:
        return contextlib.nullcontext()
    kind = "serve" if spec["traffic"]["driver"] == "serve_frames" else "train"
    return faults.planted(kind, name, spec["traffic"].get("window", 0))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", choices=("program", "control", "fault"),
                   required=True)
    p.add_argument("--fault", default=None,
                   help="with --mode fault: a name of benchmark/faults.py")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch
    from benchmark.reference.precision import CONTROL_OF

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    spec = R.load_cell(args.workload)
    driver = R.load_module(os.path.join(R.HERE, "traffic",
                                        spec["traffic"]["driver"] + ".py"),
                           "bench_driver")
    device = torch.device("cuda")
    prec = CONTROL_OF[spec["workload"]["dtype"]]
    limits = spec["workload"]["limits"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = R.Run(spec, seed, args.seconds, False, device, t0)
        if args.mode in ("program", "fault"):
            with fault(spec, args.fault):
                o = driver.run(r)
            numbers = {k: v for k, (v, _) in o.checks.items()}
        else:
            numbers = driver.control(r, prec)
        torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, "mode": args.mode,
                          "fault": args.fault,
                          "precision": prec if args.mode == "control"
                          else spec["workload"]["dtype"],
                          "numbers": numbers, "limits": limits,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
