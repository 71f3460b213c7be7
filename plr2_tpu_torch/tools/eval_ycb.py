"""YCB-Video evaluation CLI, the port of tools/eval_ycb.py (the reference's
tools/eval_ycb.py and the YCB toolbox protocol: ADD-S AUC (< 0.1 m) and
the < 2 cm rate):

  python -m plr2_tpu_torch.tools.eval_ycb --dataset_root DIR --model M        # card
  python -m plr2_tpu_torch.tools.eval_ycb --synthetic --full_pipeline --cpu   # CPU

Per-sample mode (the default) runs `eval.evaluate` over the test split
(`--batch_size 1` per crop, > 1 on a shared canvas). `--full_pipeline`
(implied by --save_mat, --posecnn_results and --device_pipeline) runs
BASELINE config 5 (`eval/full_pipeline.py`): every object of a frame
from its mask (the GT labels, or PoseCNN's with --posecnn_results, whose
`rois` switch to the upstream detection-box protocol), one batched
estimate a frame, lost detections scored as failures, optionally the
per-frame poses as `.mat` files (--save_mat). `--device_pipeline` runs
the frame program of `serving.py` (one CUDA graph a frame on the card).
`--model` is a directory of the port's checkpoints (`best.pt`); without it
the weights are the seeded initialisation. The card is the default device;
without CUDA it raises unless --cpu is given.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m plr2_tpu_torch.tools.eval_ycb")
    p.add_argument("--dataset_root", type=str, default="")
    p.add_argument("--model", type=str, default="",
                   help="checkpoint directory (tag 'best')")
    p.add_argument("--refine_iterations", type=int, default=2)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--save_mat", type=str, default="",
                   help="directory for per-frame pose .mat files "
                        "(implies --full_pipeline)")
    p.add_argument("--full_pipeline", action="store_true",
                   help="BASELINE config 5: per-frame batched multi-object "
                        "estimation through masks (GT labels unless "
                        "--posecnn_results)")
    p.add_argument("--posecnn_results", type=str, default="",
                   help="results_PoseCNN_RSS2018-style dir of %%06d.mat "
                        "segmentations to use as masks (the reference eval_ycb "
                        "protocol; implies --full_pipeline)")
    p.add_argument("--device_pipeline", action="store_true",
                   help="run the full pipeline as the frame program of "
                        "serving.py (implies --full_pipeline)")
    p.add_argument("--save_distances", type=str, default="",
                   help="write the per-object ADD-S distance report (JSON) "
                        "for tools.plot_accuracy")
    p.add_argument("--plot", type=str, default="",
                   help="write the accuracy-vs-threshold figure (PNG/SVG)")
    p.add_argument("--batch_size", type=int, default=1,
                   help="estimate batch (1 = the reference's per-crop mode; "
                        "> 1 stacks crops onto a shared canvas)")
    p.add_argument("--num_points", type=int, default=None,
                   help="override the preset's sampled-cloud size")
    p.add_argument("--mesh_points", type=int, default=None,
                   help="override the preset's model-mesh point count")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.save_mat or args.posecnn_results or args.device_pipeline:
        args.full_pipeline = True
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.synthetic == bool(args.dataset_root):
        raise SystemExit("give --dataset_root DIR (a YCB-Video tree) or "
                         "--synthetic: pick one")
    from plr2_tpu_torch.config import get_preset
    from plr2_tpu_torch.data import SyntheticPoseDataset, YCBDataset
    from plr2_tpu_torch.eval import evaluate
    from plr2_tpu_torch.tools.train import with_sizes
    from plr2_tpu_torch.train import CheckpointManager, Trainer

    cfg = with_sizes(get_preset("ycb_refine"), args.num_points,
                     args.mesh_points)
    trainer = Trainer(cfg, device="cpu" if args.cpu else "cuda")
    state = trainer.init_state()
    if args.model:
        ckpt = CheckpointManager(args.model)
        if ckpt.restore("best") is None:
            raise SystemExit(f"no checkpoint 'best' under {args.model!r}")
        state = ckpt.restore_into(state)
        print(f"loaded checkpoint (epoch {state.epoch})")
    pipe = trainer.pipe
    if args.synthetic:
        ds = SyntheticPoseDataset(num_frames=2, num_objects=3,
                                  model_points=cfg.dataset.num_mesh_points,
                                  num_points=cfg.model.num_points, seed=7)
    else:
        ds = YCBDataset(args.dataset_root, "test", cfg.model.num_points,
                        cfg.dataset.num_mesh_points, add_noise=False)

    if args.full_pipeline:
        from plr2_tpu_torch.eval.full_pipeline import (evaluate_full_pipeline,
                                                       ycb_frames_and_models)
        if args.synthetic:
            frames, models = ds.frames, dict(ds.models)
        else:
            frames, models = ycb_frames_and_models(ds, args.max_samples)
        seg_predict = None
        if args.posecnn_results:
            from plr2_tpu_torch.data.posecnn import PoseCNNMasks
            seg_predict = PoseCNNMasks(args.posecnn_results)
            if args.device_pipeline and seg_predict.detections(0) is not None:
                print("note: --device_pipeline derives crop windows from the "
                      "predicted masks on the device; the PoseCNN ROI-box "
                      "protocol (upstream get_bbox(posecnn_rois)) runs in "
                      "host mode: drop --device_pipeline for "
                      "protocol-identical config-5 numbers")
        res = evaluate_full_pipeline(
            pipe, frames, models, sym_list=cfg.dataset.sym_list,
            refine_iterations=args.refine_iterations, seg_predict=seg_predict,
            save_mat_dir=args.save_mat, device_pipeline=args.device_pipeline)
        print(f"ADD-S AUC (<0.1 m): {res.auc:.2f}")
        print(f"ADD-S < 2 cm:       {res.under_2cm * 100:.2f}%")
        print(f"mean distance:      {res.mean_distance:.4f} m "
              f"({res.num_objects} objects / {res.num_frames} frames)")
        if res.lost_detections:
            print(f"lost detections (scored as failures): {res.lost_detections}")
        if res.extra_detections:
            print(f"extra detections (exported, not scored): "
                  f"{res.extra_detections}")
        if args.save_mat:
            print(f"per-frame poses written to {args.save_mat}")
        report(args, res.per_object_distances)
        return res

    res = evaluate(pipe, ds, sym_list=cfg.dataset.sym_list,
                   refine_iterations=args.refine_iterations,
                   max_samples=args.max_samples, batch_size=args.batch_size)
    for obj, auc in sorted(res.per_object_auc.items()):
        print(f"object {obj:2d}: AUC {auc:6.2f}")
    print(f"ADD-S AUC (<0.1 m): {res.auc:.2f}")
    print(f"ADD-S < 2 cm:       {res.under_2cm * 100:.2f}%")
    print(f"mean distance:      {res.mean_distance:.4f} m "
          f"({res.num_samples} samples)")
    # the evaluator keys distances by 0-based index; shift to the 1-based
    # YCB label ids of the full-pipeline mode and the .mat dumps
    report(args, {o + 1: d for o, d in res.per_object_distances.items()})
    return res


def report(args, per_object_distances) -> None:
    if args.save_distances:
        from plr2_tpu_torch.eval.report import save_distance_report
        save_distance_report(args.save_distances, per_object_distances,
                             meta={"dataset": "ycb",
                                   "object_ids": "ycb label ids (1-based)",
                                   "refine_iterations": args.refine_iterations})
        print(f"distance report written to {args.save_distances}")
    if args.plot:
        from plr2_tpu_torch.eval.report import plot_accuracy_curves
        plot_accuracy_curves(per_object_distances, args.plot,
                             title="YCB-Video ADD-S accuracy vs threshold")
        print(f"accuracy curves written to {args.plot}")


if __name__ == "__main__":
    main()
