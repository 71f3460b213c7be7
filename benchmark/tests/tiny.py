"""Tiny specs of the four cells for the CPU tests: the cells' own files,
cut to sizes a CPU runs in seconds (64 points, 80-pixel canvases on
120 x 160 frames, a handful of frames and samples)."""

from __future__ import annotations

import copy
import json
import os
import types

from benchmark import run as R

CELLS = [w["name"] for w in json.load(open(os.path.join(
    R.ROOT, "BENCHMARK.json")))["workloads"]]


def spec(cell: str, **limits):
    s = copy.deepcopy(R.load_cell(cell))
    cfg, tr = s["config"], s["traffic"]
    cfg.update(num_points=48, mesh_points=32, img_h=120, img_w=160,
               num_objects=5, symmetric=[1, 3])
    cfg["camera"] = dict(cfg["camera"], cx=80.0, cy=60.0, fx=572.0, fy=572.0)
    tr.update(canvas=80, trace_seconds=0.5)
    if tr["driver"] == "serve_frames":
        tr.update(pool_frames=4, frames_per_call=min(tr["frames_per_call"], 2),
                  objects_per_frame=min(tr["objects_per_frame"], 2))
    else:
        tr.update(objects_per_frame=3, min_sample_pixels=60)
        tr.update(batch=4, pool_batches=3) if "batch" in tr \
            else tr.update(window=3, pool_windows=3)
    s["workload"]["limits"].update(limits)
    return s


def args(seed: int = 2 ** 31 + 11, seconds: float = 0.5, trace: int = 0):
    return types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)


def run(spec_, seed: int = 2 ** 31 + 11, seconds: float = 0.5):
    import torch

    return R.execute(spec_, args(seed, seconds), device=torch.device("cpu"),
                     check_card=False)
