"""Offline accuracy curves and tables, the port of tools/plot_accuracy.py
(the reference's MATLAB toolbox step, plot_accuracy_keyframe.m +
evaluate_poses_keyframe.m):

  # a distance report saved by an eval run (--save_distances):
  python -m plr2_tpu_torch.tools.plot_accuracy --distances report.json --out curves.png
  # per-frame pose .mat dumps re-evaluated against the synthetic frames:
  python -m plr2_tpu_torch.tools.plot_accuracy --mat_dir DIR --synthetic --json table.json
  # ... or against a YCB-Video test split's keyframes:
  python -m plr2_tpu_torch.tools.plot_accuracy --mat_dir DIR --dataset_root YCB_ROOT

Prints the per-object AUC / <2cm / mean-distance table (with 0.1*diameter
success when the report holds diameters), and writes the curve figure
(--out, which needs matplotlib) and the table as JSON (--json). It runs on
the CPU: no model, only distances. YCB ground truth (--dataset_root)
comes from `eval/full_pipeline.py` `ycb_frames_and_models`, the frames
the live full-pipeline eval scores.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m plr2_tpu_torch.tools.plot_accuracy")
    p.add_argument("--distances", type=str, default="",
                   help="distance-report JSON from an eval run")
    p.add_argument("--mat_dir", type=str, default="",
                   help="directory of %%06d.mat pose dumps to re-evaluate "
                        "against ground truth")
    p.add_argument("--dataset_root", type=str, default="",
                   help="YCB-Video root for --mat_dir ground truth")
    p.add_argument("--synthetic", action="store_true",
                   help="the synthetic fixture frames as --mat_dir ground truth")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--max_dist", type=float, default=0.1)
    p.add_argument("--out", type=str, default="",
                   help="write the accuracy-vs-threshold figure here")
    p.add_argument("--json", type=str, default="",
                   help="write the metric table as JSON here")
    p.add_argument("--title", type=str, default="ADD(-S) accuracy vs threshold")
    return p, p.parse_args(argv)


def main(argv=None):
    p, args = parse_args(argv)
    if bool(args.distances) == bool(args.mat_dir):
        p.error("pass exactly one of --distances / --mat_dir")
    from plr2_tpu_torch.eval.report import (
        accuracy_table, distances_from_mat_dir, format_accuracy_table,
        load_distance_report, plot_accuracy_curves)

    diameters = None
    if args.distances:
        per_obj, meta = load_distance_report(args.distances)
        if meta.get("diameters"):
            diameters = {int(k): float(v)
                         for k, v in meta["diameters"].items()}
    else:
        if args.synthetic == bool(args.dataset_root):
            raise SystemExit("--mat_dir needs --dataset_root DIR (a YCB-Video "
                             "tree) or --synthetic: pick one")
        from plr2_tpu_torch.config import get_preset
        cfg = get_preset("ycb_refine")
        if args.synthetic:
            from plr2_tpu_torch.data import SyntheticPoseDataset
            ds = SyntheticPoseDataset(num_frames=2, num_objects=3,
                                      model_points=cfg.dataset.num_mesh_points,
                                      num_points=cfg.model.num_points, seed=7)
            frames, models = ds.frames, dict(ds.models)
        else:
            from plr2_tpu_torch.data import YCBDataset
            from plr2_tpu_torch.eval.full_pipeline import ycb_frames_and_models
            ds = YCBDataset(args.dataset_root, "test", cfg.model.num_points,
                            cfg.dataset.num_mesh_points, add_noise=False)
            frames, models = ycb_frames_and_models(ds, args.max_frames)
        per_obj = distances_from_mat_dir(args.mat_dir, frames, models,
                                         sym_list=cfg.dataset.sym_list)

    rows = accuracy_table(per_obj, diameters=diameters, max_dist=args.max_dist)
    print(format_accuracy_table(rows))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"table written to {args.json}")
    if args.out:
        plot_accuracy_curves(per_obj, args.out, max_dist=args.max_dist,
                             title=args.title)
        print(f"accuracy curves written to {args.out}")
    return rows


if __name__ == "__main__":
    main()
