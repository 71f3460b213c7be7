"""Offline accuracy reporting, the port of plr2_tpu/eval/report.py (the
reference's MATLAB YCB toolbox post-processing step: replace_ycb_toolbox/
evaluate_poses_keyframe.m + plot_accuracy_keyframe.m).

Three capabilities, from a live eval run or from saved artifacts:

- distance reports: per-object ADD(-S) distances saved and loaded as JSON
  (`save_distance_report` / `load_distance_report`), written by
  tools/eval_linemod.py --save_distances; the same format as the JAX
  package's, so either package reads the other's reports.
- `distances_from_mat_dir`: distances recomputed from per-frame pose .mat
  files (`poses` (K, 7) wxyz|xyz rows + `cls_indexes`) against ground
  truth (evaluate_poses_keyframe.m), on the CPU: an offline step, as the
  JAX CLI runs it.
- tables and curves: per-object AUC / <2cm / 0.1*diameter success
  (`accuracy_table`, `format_accuracy_table`) and the accuracy-vs-
  threshold figure (`plot_accuracy_curves`; matplotlib is imported inside
  it, so nothing else needs it). tools/plot_accuracy.py is the CLI.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from plr2_tpu_torch.eval.metrics import (accuracy_threshold_curve,
                                         compute_auc, pose_distance,
                                         success_rate)

# Categorical series colors (validated 8-slot palette: lightness band,
# chroma floor, CVD-adjacent separation). Slot 1 is reserved for the
# aggregate curve; objects take slots 2..8 when they fit.
_SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
           "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
_GRAY = "#b5b5b5"
_INK = "#3a3a3a"


def save_distance_report(path: str,
                         per_object_distances: Mapping[int, Sequence[float]],
                         meta: Optional[Dict] = None) -> None:
    """Write a per-object distance report as JSON ({"distances": {id: [...]},
    "meta": {...}}). Object ids are stored as strings (JSON keys)."""
    payload = {
        "distances": {str(k): [float(x) for x in v]
                      for k, v in per_object_distances.items()},
        "meta": dict(meta or {}),
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)


def load_distance_report(path: str) -> Tuple[Dict[int, List[float]], Dict]:
    with open(path) as f:
        payload = json.load(f)
    dists = {int(k): [float(x) for x in v]
             for k, v in payload["distances"].items()}
    return dists, payload.get("meta", {})


def distances_from_mat_dir(
    mat_dir: str,
    frames,
    models: Mapping[int, np.ndarray],
    sym_list: Sequence[int],
) -> Dict[int, List[float]]:
    """Recompute per-object ADD(-S) distances from saved per-frame pose
    .mat files against ground truth, on the CPU: the toolbox's offline
    re-evaluation of a pose dump.

    `frames[i].poses` maps object id -> (R_gt (3,3), t_gt (3,)); the .mat
    for frame i is `{i:06d}.mat` with `poses` (K, 7) [wxyz quat | xyz
    trans] and `cls_indexes` (K,) object ids, as the JAX package's
    eval/full_pipeline.py writes them. Object ids in `sym_list` are 0-based
    indices (id - 1), as `evaluate` takes them.
    """
    import scipy.io as sio

    per_obj: Dict[int, List[float]] = {}
    for fi, frame in enumerate(frames):
        path = os.path.join(mat_dir, f"{fi:06d}.mat")
        if not os.path.exists(path):
            continue
        mat = sio.loadmat(path)
        poses = np.atleast_2d(np.asarray(mat["poses"], np.float64))
        cls = np.asarray(mat["cls_indexes"], np.int64).reshape(-1)
        by_cls = {int(c): row for row, c in zip(poses, cls)}
        # score every GT object of the frame; ids absent from the dump are
        # lost detections = distance inf (toolbox semantics, matching the
        # live evaluate_full_pipeline accounting)
        for obj_id, (r_gt, t_gt) in frame.poses.items():
            row = by_cls.get(obj_id)
            if row is None:
                per_obj.setdefault(obj_id, []).append(float("inf"))
                continue
            mp = np.asarray(models[obj_id], np.float32)
            target = mp @ np.asarray(r_gt, np.float32).T + \
                np.asarray(t_gt, np.float32)
            dis = float(pose_distance(
                *(torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in
                  (mp, row[:4], row[4:7], target)),
                symmetric=(obj_id - 1) in sym_list))
            per_obj.setdefault(obj_id, []).append(dis)
    return per_obj


def accuracy_table(per_object_distances: Mapping[int, Sequence[float]],
                   diameters: Optional[Mapping[int, float]] = None,
                   max_dist: float = 0.1) -> List[Dict]:
    """Per-object metric rows (plus an 'all' aggregate row): AUC over
    [0, max_dist], <2cm rate, mean distance, and — when `diameters` is
    given — the LineMOD 0.1*diameter success rate."""
    rows: List[Dict] = []
    all_d: List[float] = []
    for obj in sorted(per_object_distances):
        d = list(per_object_distances[obj])
        all_d.extend(d)
        finite = [x for x in d if np.isfinite(x)]
        row = {
            "object": obj,
            "count": len(d),
            "auc": compute_auc(d, max_dist=max_dist),
            "under_2cm": success_rate(d, 0.02),
            # lost detections (inf) count in AUC/rates; the mean stays
            # over detected objects so it remains a distance
            "mean_distance": float(np.mean(finite)) if finite else 0.0,
        }
        if diameters is not None and obj in diameters:
            row["success_01d"] = success_rate(d, 0.1 * diameters[obj])
        rows.append(row)
    all_finite = [x for x in all_d if np.isfinite(x)]
    agg = {
        "object": "all",
        "count": len(all_d),
        "auc": compute_auc(all_d, max_dist=max_dist),
        "under_2cm": success_rate(all_d, 0.02),
        "mean_distance": float(np.mean(all_finite)) if all_finite else 0.0,
    }
    if any("success_01d" in r for r in rows):
        succ = [r["success_01d"] for r in rows if "success_01d" in r]
        agg["success_01d"] = float(np.mean(succ))  # upstream: mean over objects
    rows.append(agg)
    return rows


def format_accuracy_table(rows: List[Dict],
                          names: Optional[Mapping[int, str]] = None) -> str:
    has_succ = any("success_01d" in r for r in rows)
    head = f"{'object':>12s} {'n':>6s} {'AUC':>7s} {'<2cm':>7s} {'mean m':>8s}"
    if has_succ:
        head += f" {'<0.1d':>7s}"
    lines = [head]
    for r in rows:
        name = (names or {}).get(r["object"], str(r["object"]))
        line = (f"{name:>12s} {r['count']:>6d} {r['auc']:>7.2f} "
                f"{r['under_2cm'] * 100:>6.2f}% {r['mean_distance']:>8.4f}")
        if has_succ:
            line += (f" {r['success_01d'] * 100:>6.2f}%"
                     if "success_01d" in r else f" {'—':>7s}")
        lines.append(line)
    return "\n".join(lines)


def plot_accuracy_curves(per_object_distances: Mapping[int, Sequence[float]],
                         out_path: str,
                         max_dist: float = 0.1,
                         title: str = "ADD(-S) accuracy vs threshold",
                         names: Optional[Mapping[int, str]] = None) -> str:
    """Write the toolbox-style accuracy-threshold figure as a PNG/SVG.

    The aggregate curve is the headline; per-object curves get their own
    colors + a legend only when there are few enough to tell apart (<= 7).
    Beyond that they render as thin gray context lines with the worst
    (lowest-AUC) object direct-labeled, and identity lives in the table
    (format_accuracy_table) instead of a 13-entry legend.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    objs = sorted(per_object_distances)
    all_d = [x for o in objs for x in per_object_distances[o]]
    fig, ax = plt.subplots(figsize=(7.0, 4.6), dpi=150)

    few = len(objs) <= 7
    worst = None
    if objs:
        worst = min(objs, key=lambda o: compute_auc(
            per_object_distances[o], max_dist=max_dist))
    for i, obj in enumerate(objs):
        d = per_object_distances[obj]
        ts, acc = accuracy_threshold_curve(d, max_dist=max_dist,
                                           num_thresholds=200)
        name = (names or {}).get(obj, f"obj {obj}")
        auc = compute_auc(d, max_dist=max_dist)
        if few:
            ax.plot(ts, acc * 100.0, color=_SERIES[1 + i], linewidth=1.4,
                    label=f"{name} (AUC {auc:.1f})")
        else:
            ax.plot(ts, acc * 100.0, color=_GRAY, linewidth=0.9, zorder=1)
            if obj == worst:
                ax.annotate(f"{name} (AUC {auc:.1f})",
                            (ts[len(ts) // 2], acc[len(ts) // 2] * 100.0),
                            textcoords="offset points", xytext=(4, -10),
                            fontsize=8, color=_INK)

    if all_d:
        ts, acc = accuracy_threshold_curve(all_d, max_dist=max_dist,
                                           num_thresholds=200)
        ax.plot(ts, acc * 100.0, color=_SERIES[0], linewidth=2.2,
                label=f"all objects (AUC {compute_auc(all_d, max_dist=max_dist):.1f})",
                zorder=3)

    ax.set_xlim(0.0, max_dist)
    ax.set_ylim(0.0, 100.0)
    ax.set_xlabel("distance threshold (m)", color=_INK)
    ax.set_ylabel("accuracy (%)", color=_INK)
    ax.set_title(title, color=_INK)
    ax.grid(True, linewidth=0.4, alpha=0.35)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    ax.tick_params(colors=_INK)
    ax.legend(loc="lower right", fontsize=8, frameon=False)
    fig.tight_layout()
    d = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(d, exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
