"""The evaluation loop, the port of plr2_tpu/eval/evaluator.py (the
reference's tools/eval_linemod.py and tools/eval_ycb.py protocol): per
sample, the estimate (PoseNet, best hypothesis, refinement), ADD(-S)
against the ground-truth-posed model points, aggregated per object.

LineMOD protocol: success = dis < 0.1 * object diameter (ADD; ADD-S for
symmetric objects). YCB protocol: ADD-S AUC (< 0.1 m) and the < 2 cm rate
over all (frame, object) samples.

Draws: JAX's `evaluate` splits its key once per sample that is not lost and
preprocesses without noise, so only the choose hash's key words matter.
Here each sample that is not lost takes one `preprocess.Draws` from a CPU
`torch.Generator(seed)`, or from the `draws` callable the caller passes
(the parity tests pass JAX's key words that way).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from plr2_tpu_torch.data.loader import raw_to_sample, stack_samples
from plr2_tpu_torch.data.preprocess import Draws, draw
from plr2_tpu_torch.eval.metrics import (compute_auc, pose_distance,
                                         success_rate)
from plr2_tpu_torch.pipeline import DenseFusionPipeline


@dataclass
class EvalResult:
    per_object_success: Dict[int, float] = field(default_factory=dict)
    per_object_auc: Dict[int, float] = field(default_factory=dict)
    # raw ADD(-S) distances per object id: the input to the offline
    # accuracy report and curves (eval/report.py, --save_distances)
    per_object_distances: Dict[int, List[float]] = field(default_factory=dict)
    mean_success: float = 0.0
    auc: float = 0.0
    under_2cm: float = 0.0
    mean_distance: float = 0.0
    num_samples: int = 0
    # samples whose (predicted) mask had no valid pixels: the upstream
    # eval's "NOT Pass! Lost detection!" path, which skips the sample
    # (out of both numerator and denominator)
    lost_detections: int = 0


def evaluate(
    pipe: DenseFusionPipeline,
    dataset,
    sym_list: Tuple[int, ...],
    refine_iterations: int = 2,
    diameters: Optional[Dict[int, float]] = None,
    num_points: Optional[int] = None,
    max_samples: Optional[int] = None,
    seed: int = 0,
    batch_size: int = 1,
    crop_canvas: int = 240,
    draws: Optional[Callable[[], Draws]] = None,
) -> EvalResult:
    """Run the eval protocol over `dataset` (any `get_raw` provider) on the
    pipeline's device, in its mode (f32, or bf16 after `cast`).

    batch_size 1 is the reference's per-crop mode (one estimate per sample
    at its own crop); batch_size > 1 stacks crops onto a shared canvas of
    max(crop_canvas, largest crop) and runs the estimate batched
    (throughput mode). `draws()` gives each sample's draws (default: from
    `torch.Generator().manual_seed(seed)`)."""
    n_pts = num_points or pipe.num_points
    draws = draws or functools.partial(draw, torch.Generator().manual_seed(seed))
    dists: List[float] = []
    per_obj: Dict[int, List[float]] = {}

    def score(obj, model_points, q, t, target):
        dis = float(pose_distance(model_points, q, t, target,
                                  symmetric=obj in sym_list))
        dists.append(dis)
        per_obj.setdefault(obj, []).append(dis)

    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    pending: List[Tuple[int, object]] = []

    def flush():
        if not pending:
            return
        ss = [s for _, s in pending]
        canvas = max([crop_canvas] + [max(s.img.shape[0], s.img.shape[1])
                                      for s in ss])
        batch = stack_samples(ss, crop=canvas)
        est = pipe.estimate(batch.img, batch.points, batch.choose, batch.idx,
                            refine_iterations=refine_iterations)
        for bi, (obj, _) in enumerate(pending):
            score(obj, batch.model_points[bi], est.quat[bi], est.trans[bi],
                  batch.target[bi])
        pending.clear()

    lost = 0
    for i in range(n):
        raw = dataset.get_raw(i)
        if raw.get("lost"):
            lost += 1
            continue
        s = raw_to_sample(raw, draws(), n_pts, add_noise=False,
                          device=pipe.device)
        obj = int(raw["obj_idx"])
        if batch_size > 1:
            pending.append((obj, s))
            if len(pending) >= batch_size:
                flush()
            continue
        est = pipe.estimate(s.img[None], s.points[None], s.choose[None],
                            s.idx[None], refine_iterations=refine_iterations)
        score(obj, s.model_points, est.quat[0], est.trans[0], s.target)
    flush()

    result = EvalResult(num_samples=len(dists), lost_detections=lost)
    if not dists:
        return result
    result.mean_distance = float(np.mean(dists))
    result.auc = compute_auc(dists)
    result.under_2cm = success_rate(dists, 0.02)
    result.per_object_auc = {obj: compute_auc(d) for obj, d in per_obj.items()}
    result.per_object_distances = per_obj
    if diameters:
        succ = {obj: success_rate(d, 0.1 * diameters.get(obj, 0.1))
                for obj, d in per_obj.items()}
        result.per_object_success = succ
        result.mean_success = float(np.mean(list(succ.values())))
    return result
