"""Run one benchmark cell once and print its result as one JSON line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data. `BENCHMARK.json` names the cell's
configuration and traffic mix; the harness reads
- `benchmark/configs/<config>.json`: the model configuration as run;
- `benchmark/traffic/<traffic>.json`: the mix's parameters, among them
  `driver`, the general generator and loop that runs it
  (`benchmark/traffic/<driver>.py`);
- `benchmark/workloads/<cell>.json`: the cell's dtype, the limits of
  the numbers that decide `correct`, and its judge's candidate window;
- `benchmark/metrics/<metric>.py`: one reader a per-layer metric; a
  metric named for a family of cells (`serve.mfu`,
  `mlp_head_roofline.train`) without a file of its own is read by the
  file of the name without that part (`mfu.py`, `mlp_head_roofline.py`).
A later cell, mix or metric is a new file; no file here needs an edit.

Set-up (`setup_s`) runs from the harness's first line to the first timed
call: imports, the kernels' library from its build directory, weights
and inputs from the seed, warm-up and capture. The driver then measures
for `--seconds` (with `--trace 1`, a traced slice of the same loop),
reads the peak memory, frees the program and judges what the timed path
produced against the plain reference (`benchmark/reference/`).

A run exits non-zero and prints no result when CUDA is missing or has
fewer cards than the cell asks for, and when `jax`, `jaxlib`, `flax` or
the JAX package `plr2_tpu` is loaded in this process once the window has
closed (whole top-level module names: `plr2_tpu_torch` is the program).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "plr2_tpu")


class Refused(RuntimeError):
    """A run that must print no result (exit code 2)."""


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among `modules` (sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str) -> Dict:
    """Everything the run of cell `name` reads, by name from
    BENCHMARK.json: the cell, its configuration, traffic and workload
    files, its end-to-end metrics and its per-layer metrics."""
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in e2e_names
                              else [])]
    return dict(cell=cell, config=_json(os.path.join(ROOT, config["file"])),
                traffic=_json(os.path.join(HERE, "traffic",
                                           cell["traffic"] + ".json")),
                workload=_json(os.path.join(HERE, "workloads",
                                            name + ".json")),
                end_to_end=e2e, per_layer=layer)


class Run:
    """What a driver is given: the cell's files, the run's arguments and
    the device. A driver returns an `Outcome`."""

    def __init__(self, spec: Dict, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        self.name = spec["cell"]["name"]
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.workload = spec["workload"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start


class Outcome:
    """A driver's result: `end_to_end` values by name (host clock),
    `counts` for the per-layer readers (model FLOPs, kernel bounds, the
    dtype), the `trace` of the traced slice (or None), the compared
    numbers `checks` {name: (value, limit)}, requests attempted and
    failed, and the peak device memory."""

    def __init__(self, end_to_end, counts, trace, checks, attempted, failed,
                 memory_peak_bytes):
        self.end_to_end, self.counts, self.trace = end_to_end, counts, trace
        self.checks, self.attempted, self.failed = checks, attempted, failed
        self.memory_peak_bytes = memory_peak_bytes


def power_limit_w():
    """The card's power limit from nvidia-smi, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def correct_of(outcome: Outcome) -> bool:
    return outcome.failed == 0 and all(
        v <= lim for v, lim in outcome.checks.values())


def reader_path(metric: str) -> str:
    """The reader of per-layer metric `metric`: `metrics/<metric>.py`, or
    where there is none, the file of the name without its last dotted
    part, then without its first."""
    parts = metric.split(".")
    for name in (metric, ".".join(parts[:-1]), ".".join(parts[1:])):
        path = os.path.join(HERE, "metrics", name + ".py")
        if name and os.path.exists(path):
            return path
    raise Refused(f"no reader for per-layer metric {metric!r}")


def result_line(spec: Dict, outcome: Outcome, device: Dict,
                trace: bool) -> Dict:
    """The contract's last line: end-to-end metrics without trace, the
    cell's per-layer metrics (those whose reader finds something) with."""
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            reader = load_module(reader_path(m["name"]),
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(outcome)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    out = {"correct": correct_of(outcome), "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and outcome.trace is not None:
        out["breakdown"] = outcome.trace.breakdown()
    out["checks"] = {k: {"value": _finite(v), "limit": lim}
                     for k, (v, lim) in outcome.checks.items()}
    return out


def _finite(v):
    """A number as measured, or its name where JSON has none (inf, nan)."""
    return v if math.isfinite(v) else str(v)


def execute(spec: Dict, args, device=None, check_card: bool = True):
    """Run the cell: (result line dict, Outcome)."""
    import torch

    chips = spec["cell"]["chips"]
    if check_card and (not torch.cuda.is_available()
                       or torch.cuda.device_count() < chips):
        raise Refused(f"the cell needs {chips} CUDA device(s); "
                      f"available: {torch.cuda.is_available()}, "
                      f"count: {torch.cuda.device_count()}")
    device = torch.device("cuda") if device is None else device
    driver = load_module(os.path.join(HERE, "traffic",
                                      spec["traffic"]["driver"] + ".py"),
                         "bench_driver_" + spec["traffic"]["driver"])
    run = Run(spec, args.seed, args.seconds, bool(args.trace), device,
              T_START)
    outcome = driver.run(run)
    found = forbidden_modules()
    if found:
        raise Refused("forbidden modules loaded in this process: "
                      + ", ".join(found))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips, "memory_peak_bytes": outcome.memory_peak_bytes}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    if args.trace and outcome.trace is not None:
        dev["busy_s"] = outcome.trace.busy_s
        dev["window_s"] = outcome.trace.window_s
    return result_line(spec, outcome, dev, bool(args.trace)), outcome


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        spec = load_cell(args.workload)
        line, _ = execute(spec, args)
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
