"""LineMOD evaluation CLI, the port of tools/eval_linemod.py (the
reference's protocol: per-object ADD(-S) < 0.1 * diameter success rates):

  python -m plr2_tpu_torch.tools.eval_linemod --dataset_root DIR --model M   # card
  python -m plr2_tpu_torch.tools.eval_linemod --synthetic --cpu              # CPU

`--dataset_root` is a Linemod_preprocessed tree (its test split, read by
`data/linemod.py` with no PIL or PyYAML); `--segnet_results` replaces the
GT masks by predicted ones in the upstream layout
(`{dir}/{obj:02d}_label/{frame:04d}_label.png`, pixel 255 = object), and
an empty predicted mask is a lost detection that the evaluator skips.
`--model` is a directory of the port's checkpoints (`best.pt`, as
`python -m plr2_tpu_torch.tools.train` writes under `<outf>/linemod`);
without it the weights are the seeded initialisation.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m plr2_tpu_torch.tools.eval_linemod")
    p.add_argument("--dataset_root", type=str, default="",
                   help="Linemod_preprocessed root (its test split)")
    p.add_argument("--model", type=str, default="",
                   help="checkpoint directory (tag 'best')")
    p.add_argument("--refine_iterations", type=int, default=4)
    p.add_argument("--segnet_results", type=str, default="",
                   help="directory of predicted masks in the upstream layout "
                        "{dir}/{obj:02d}_label/{frame:04d}_label.png (the "
                        "reference eval's segnet_results/); empty = GT masks")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--save_distances", type=str, default="",
                   help="write the per-object ADD(-S) distance report "
                        "(JSON) for tools/plot_accuracy")
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
    return p.parse_args(argv)


def refuse_unsupported(args) -> None:
    if args.synthetic == bool(args.dataset_root):
        raise SystemExit("give --dataset_root DIR (a Linemod_preprocessed "
                         "tree) or --synthetic: pick one")
    if args.segnet_results and args.synthetic:
        raise SystemExit("--segnet_results holds masks of --dataset_root's "
                         "frames, not of --synthetic ones")


def run(args):
    """The eval run of `args`: (EvalResult, diameters by 0-based id)."""
    refuse_unsupported(args)
    from plr2_tpu_torch.config import get_preset
    from plr2_tpu_torch.data import LinemodDataset, SyntheticPoseDataset
    from plr2_tpu_torch.eval import evaluate
    from plr2_tpu_torch.tools.train import with_sizes
    from plr2_tpu_torch.train import CheckpointManager, Trainer

    cfg = with_sizes(get_preset("linemod_train"), args.num_points,
                     args.mesh_points)
    if args.synthetic:
        ds = SyntheticPoseDataset(num_frames=2, num_objects=2,
                                  model_points=cfg.dataset.num_mesh_points,
                                  num_points=cfg.model.num_points, seed=42)
        diameters = ds.diameters
    else:
        ds = LinemodDataset(args.dataset_root, "test", cfg.model.num_points,
                            cfg.dataset.num_mesh_points, add_noise=False,
                            segnet_results=args.segnet_results or None)
        diameters = {ds.objlist.index(o): d for o, d in ds.diameters.items()}
    trainer = Trainer(cfg, device="cpu" if args.cpu else "cuda")
    state = trainer.init_state()
    if args.model:
        ckpt = CheckpointManager(args.model)
        if ckpt.restore("best") is None:
            raise SystemExit(f"no checkpoint 'best' under {args.model!r}")
        state = ckpt.restore_into(state)
        print(f"loaded checkpoint (epoch {state.epoch})")
    res = evaluate(trainer.pipe, ds, sym_list=cfg.dataset.sym_list,
                   refine_iterations=args.refine_iterations,
                   diameters=diameters, max_samples=args.max_samples,
                   batch_size=args.batch_size)
    return res, diameters


def main(argv=None):
    args = parse_args(argv)
    res, diameters = run(args)
    for obj, s in sorted(res.per_object_success.items()):
        print(f"object {obj:2d}: success {s * 100:.2f}%")
    print(f"mean success rate: {res.mean_success * 100:.2f}%  "
          f"(mean dis {res.mean_distance:.4f} m, {res.num_samples} samples)")
    if res.lost_detections:
        print(f"lost detections (empty predicted mask, skipped): "
              f"{res.lost_detections}")
    if args.save_distances:
        from plr2_tpu_torch.eval.report import save_distance_report
        save_distance_report(
            args.save_distances, res.per_object_distances,
            meta={"dataset": "linemod",
                  "refine_iterations": args.refine_iterations,
                  "diameters": {int(k): float(v)
                                for k, v in diameters.items()}})
        print(f"distance report written to {args.save_distances}")
    if args.plot:
        from plr2_tpu_torch.eval.report import plot_accuracy_curves
        plot_accuracy_curves(res.per_object_distances, args.plot,
                             title="LineMOD ADD(-S) accuracy vs threshold")
        print(f"accuracy curves written to {args.plot}")
    return res


if __name__ == "__main__":
    main()
