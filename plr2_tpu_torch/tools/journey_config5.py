"""The config-5 journey as one script, the port of tools/journey_config5.py:
train -> segment -> evaluate -> report on synthetic scenes at YCB scale
(BASELINE config 5; upstream tools/train.py ->
vanilla_segmentation/train.py -> tools/eval_ycb.py -> replace_ycb_toolbox).

  1. a fixed 21-object model library (the symmetric subset plain cuboids
     at YCB's symmetric indices 12/15/18/19/20, the rest knobbed boxes),
     rendered into multi-object scenes (`data/synthetic.py`
     `make_model_library`, `data/loader.py` `SyntheticSceneDataset`);
  2. PoseNet and the refiner trained by `BatchTrainer` through both
     curriculum switches, best and last checkpoints (`best.pt`, `last.pt`);
  3. SegNet trained on the same frames (`train/seg_trainer.py`),
     `segnet.pt`;
  4. the held-out full pipeline with SegNet-predicted masks and
     4-iteration refinement, per-frame `.mat` poses
     (`eval/full_pipeline.py`);
  5. the offline toolbox step: the `.mat` dump re-evaluated against ground
     truth, the per-object table, curves (when matplotlib is there) and the
     distance report (`eval/report.py`).

Full scale (defaults):  python -m plr2_tpu_torch.tools.journey_config5
Shrunk scale (the tests' run):
  python -m plr2_tpu_torch.tools.journey_config5 --objects 3 --sym 2 \\
      --train_frames 6 --test_frames 2 --per_frame 2 --num_points 96 \\
      --model_points 128 --batch 4 --epochs 2 --seg_epochs 2 \\
      --force_switches --cpu
The card is the default device; without CUDA it raises unless --cpu is
given.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m plr2_tpu_torch.tools.journey_config5")
    p.add_argument("--objects", type=int, default=21)
    p.add_argument("--sym", type=int, default=-1,
                   help="-1: the YCB symmetric subset {13,16,19,20,21} "
                        "(1-based); N: the last N object ids")
    p.add_argument("--train_frames", type=int, default=160)
    p.add_argument("--test_frames", type=int, default=24)
    p.add_argument("--per_frame", type=int, default=5,
                   help="objects rendered per scene")
    p.add_argument("--num_points", type=int, default=1000)
    p.add_argument("--model_points", type=int, default=500)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--epochs", type=int, default=80)
    p.add_argument("--repeat_epoch", type=int, default=2)
    p.add_argument("--seg_epochs", type=int, default=24)
    p.add_argument("--seg_batch", type=int, default=4)
    p.add_argument("--refine_iterations", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--outf", type=str, default="trained_models/journey_c5")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    p.add_argument("--decay_margin", type=float, default=0.016)
    p.add_argument("--refine_margin", type=float, default=0.013,
                   help="the reference thresholds are sized to real data; "
                        "size them to the synthetic task so the switch "
                        "mechanism runs at a reachable operating point")
    p.add_argument("--resume", action="store_true",
                   help="resume PoseNet training from <outf>/best.pt")
    p.add_argument("--distinct_colors", action="store_true",
                   help="well-separated object palette (not compatible with "
                        "checkpoints trained on the default palette)")
    p.add_argument("--force_switches", action="store_true",
                   help="both curriculum margins +inf, so the decay and "
                        "refine switches fire on the first test epochs (the "
                        "shrunk-scale run)")
    return p.parse_args(argv)


def build_datasets(args):
    from plr2_tpu_torch.data import SyntheticSceneDataset
    from plr2_tpu_torch.data.synthetic import make_model_library

    if args.sym < 0:
        sym_ids = tuple(i for i in (13, 16, 19, 20, 21) if i <= args.objects)
    else:
        sym_ids = tuple(range(args.objects - args.sym + 1, args.objects + 1))
    models = make_model_library(args.objects, args.model_points,
                                seed=args.seed, sym_ids=sym_ids)

    def scenes(n, seed):
        return SyntheticSceneDataset(models, n, objects_per_frame=args.per_frame,
                                     num_points=args.num_points, seed=seed,
                                     distinct_colors=args.distinct_colors)
    # other seed streams: novel poses and compositions of the SAME library;
    # the val set gates the curriculum and the best checkpoint, the test set
    # is touched only by the final full-pipeline evaluation
    train_ds = scenes(args.train_frames, args.seed)
    val_ds = scenes(max(2, args.test_frames // 2), args.seed + 57)
    test_ds = scenes(args.test_frames, args.seed + 31)
    sym_list = tuple(i - 1 for i in sym_ids)  # 0-based
    return models, train_ds, val_ds, test_ds, sym_list


def train_posenet(args, train_ds, val_ds, sym_list, log):
    import torch

    from plr2_tpu_torch.config import (DatasetConfig, ModelConfig,
                                       PipelineConfig, TrainConfig)
    from plr2_tpu_torch.train import BatchTrainer, CheckpointManager

    inf = float("inf")
    cfg = PipelineConfig(
        dataset=DatasetConfig(name="synthetic", num_points=args.num_points,
                              num_objects=args.objects,
                              num_mesh_points=args.model_points,
                              sym_list=sym_list),
        model=ModelConfig(num_points=args.num_points, num_objects=args.objects),
        train=TrainConfig(batch_size=args.batch, lr=args.lr,
                          nepoch=args.epochs, repeat_epoch=args.repeat_epoch,
                          seed=args.seed,
                          decay_margin=(inf if args.force_switches
                                        else args.decay_margin),
                          refine_margin=(inf if args.force_switches
                                         else args.refine_margin)))
    trainer = BatchTrainer(cfg, device="cpu" if args.cpu else "cuda")
    state = trainer.init_state()
    ckpt = CheckpointManager(args.outf)
    if args.resume:
        state = ckpt.restore_into(state, "best")
        log(f"resumed from {args.outf}/best.pt: epoch {state.epoch}, "
            f"best={state.best_test:.5f}, refine={state.refine_started}")
    state = trainer.fit(
        state, train_ds, val_ds, torch.Generator().manual_seed(args.seed + 1),
        epochs=args.epochs, log_fn=log,
        checkpoint_fn=lambda s, d: ckpt.save(s, d),
        save_last_fn=lambda s: ckpt.save(s, s.best_test, tag="last"))
    if not state.refine_started:
        log("WARNING: the refine switch never fired: the metrics below are "
            "stage-1 / decay only")
    summary = {k: getattr(state, k) for k in ("epoch", "best_test",
                                              "decay_started", "refine_started")}
    # evaluate the BEST checkpoint, as the reference eval drivers do
    ckpt.restore_into(state, "best")
    return trainer, summary


def train_segnet(args, train_ds, test_ds, log):
    import numpy as np

    from plr2_tpu_torch.eval.full_pipeline import segment_frame
    from plr2_tpu_torch.train.seg_trainer import SegTrainer, save_weights

    seg = SegTrainer(num_classes=args.objects + 1, crop=128,
                     batch=args.seg_batch, device="cpu" if args.cpu else "cuda")
    st = seg.init_state(args.seed + 2)
    for e in range(args.seg_epochs):
        st = seg.train_epoch(st, train_ds.frames, seed=args.seed * 100 + e)
        log(f"segnet epoch {e + 1}: loss={st['last_epoch_loss']:.4f} "
            f"({st['seconds']:.1f}s)")
    save_weights(os.path.join(args.outf, "segnet.pt"), seg.model)
    # held-out pixel accuracy on full frames (the pad-to-32 predict path)
    accs = [float((segment_frame(seg, fr.color) == fr.label).mean())
            for fr in test_ds.frames[:8]]
    log(f"segnet held-out full-frame pixel acc: {np.mean(accs):.4f}")
    return seg, float(np.mean(accs))


def eval_full_pipeline(args, pipe, test_ds, sym_list, seg, log):
    from plr2_tpu_torch.eval.full_pipeline import (evaluate_full_pipeline,
                                                   segment_frame)

    mat_dir = os.path.join(args.outf, "mat")
    res = evaluate_full_pipeline(
        pipe, test_ds.frames, dict(test_ds.models), sym_list=sym_list,
        refine_iterations=args.refine_iterations,
        seg_predict=lambda color: segment_frame(seg, color),
        num_points=args.num_points, save_mat_dir=mat_dir)
    log(f"full pipeline (SegNet masks, {args.refine_iterations}-iter "
        f"refine): ADD-S AUC={res.auc:.2f} <2cm={res.under_2cm * 100:.1f}% "
        f"mean_dis={res.mean_distance * 1000:.1f}mm "
        f"lost={res.lost_detections}/{res.num_objects} "
        f"({res.num_frames} frames)")
    return res, mat_dir


def toolbox_report(args, test_ds, sym_list, res, mat_dir, log):
    """The offline toolbox step: the exported .mat poses re-evaluated
    against ground truth, the table, the curves and the report."""
    from plr2_tpu_torch.eval.report import (accuracy_table,
                                            distances_from_mat_dir,
                                            format_accuracy_table,
                                            plot_accuracy_curves,
                                            save_distance_report)

    per_obj = distances_from_mat_dir(mat_dir, test_ds.frames,
                                     dict(test_ds.models), sym_list=sym_list)
    # the offline re-evaluation scores the exported (detected) poses and
    # counts absent ids as inf, as the live result does
    diam = {oid: test_ds.diameters[oid - 1] for oid in test_ds.models}
    rows = accuracy_table(per_obj, diameters=diam)
    log(format_accuracy_table(rows))
    report_json = os.path.join(args.outf, "distance_report.json")
    save_distance_report(report_json, res.per_object_distances,
                         meta={"diameters": diam,
                               "lost_detections": res.lost_detections,
                               "auc": res.auc, "under_2cm": res.under_2cm})
    curves = os.path.join(args.outf, "accuracy_curves.png")
    try:
        plot_accuracy_curves(per_obj, curves)
        log(f"curves written to {curves}")
    except ImportError as e:  # matplotlib is optional (not on every host)
        log(f"curve plot skipped: {e!r}")
    log(f"distance report written to {report_json}")
    return rows


def main(argv=None):
    args = parse_args(argv)

    def log(msg):
        print(msg, flush=True)

    t0 = time.time()
    models, train_ds, val_ds, test_ds, sym_list = build_datasets(args)
    log(f"library: {args.objects} objects (sym 0-based {sym_list}); "
        f"{len(train_ds)} train / {len(val_ds)} val / {len(test_ds)} test "
        f"samples over {args.train_frames}/{len(val_ds.frames)}/"
        f"{args.test_frames} frames ({time.time() - t0:.0f}s)")

    t1 = time.time()
    trainer, trained = train_posenet(args, train_ds, val_ds, sym_list, log)
    t_train = time.time() - t1
    log(f"posenet+refiner training: {t_train:.0f}s (epoch {trained['epoch']}, "
        f"best={trained['best_test']:.5f}, decay={trained['decay_started']} "
        f"refine={trained['refine_started']})")

    t2 = time.time()
    seg, seg_acc = train_segnet(args, train_ds, test_ds, log)
    t_seg = time.time() - t2

    t3 = time.time()
    res, mat_dir = eval_full_pipeline(args, trainer.pipe, test_ds, sym_list,
                                      seg, log)
    t_eval = time.time() - t3
    toolbox_report(args, test_ds, sym_list, res, mat_dir, log)

    summary = {
        "auc": round(res.auc, 2),
        "under_2cm_pct": round(res.under_2cm * 100, 1),
        "mean_distance_mm": round(res.mean_distance * 1000, 2),
        "lost_detections": res.lost_detections,
        "num_objects_scored": res.num_objects,
        "segnet_pixel_acc": round(seg_acc, 4),
        "refine_started": bool(trained["refine_started"]),
        "decay_started": bool(trained["decay_started"]),
        "epochs": trained["epoch"],
        "wall_s": {"total": round(time.time() - t0, 1),
                   "train": round(t_train, 1), "segnet": round(t_seg, 1),
                   "eval": round(t_eval, 1)},
    }
    with open(os.path.join(args.outf, "journey_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    log("JOURNEY " + json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
