"""Training CLI, the port of tools/train.py (the reference's argparse
surface) over this package's trainers:

  python -m plr2_tpu_torch.tools.train --synthetic --nepoch 2          # card
  python -m plr2_tpu_torch.tools.train --synthetic --nepoch 2 --cpu    # CPU
  python -m plr2_tpu_torch.tools.train --dataset linemod \
      --dataset_root /data/Linemod_preprocessed --workers 4 --cache_mb 2048
  python -m plr2_tpu_torch.tools.train --dataset ycb \
      --dataset_root /data/YCB_Video_Dataset --workers 4
  torchrun --nproc_per_node N -m plr2_tpu_torch.tools.train \
      --synthetic --data_parallel N                          # N cards

Runs `Trainer` (per-sample accumulation), `FusedTrainer` (--fused) or
`BatchTrainer` (--batched, or --data_parallel 1 as in the JAX CLI) `.fit`
on synthetic frames or on a LineMOD / YCB-Video tree (`--dataset_root`:
the upstream layouts that `data/linemod.py` and `data/ycb.py` read, with
no PIL or PyYAML), writes `best` and `last` checkpoints under
`<outf>/<dataset>/`, resumes from `last` when it exists, and stops cleanly
on SIGTERM / SIGINT (the first signal is a request that `fit` honours at
the next sample or batch boundary; a second one aborts). The card is the
default device; without CUDA it raises unless --cpu is given.

`--workers N` feeds the epochs from N threads of the native data plane
(`data/prefetch.py`; 0 preprocesses inline on the device), `--cache_mb`
caches decoded frames (`data/frame_cache.py`), and `--noise_trans` sets
`DatasetConfig.noise_trans`, the translation noise that both sample
iterators draw (JAX stores it on the datasets, where no path reads it,
and draws 0.03). Flags of the JAX CLI that this port does not run raise
NotImplementedError with the ROADMAP item that brings them: --config
(YAML), --pretrained_trunk. On the card --fused runs each accumulation
window, and --batched each step's forward and backward, as one CUDA
graph; --sym_slots sizes --batched mode's ADD-S compaction, as in the JAX
CLI.

--data_parallel D / --model_parallel M with D x M > 1 run `BatchTrainer`
over a (data, model) mesh of D x M ranks, one process a rank under
torchrun (`--nproc_per_node D*M`); the world size must equal D x M.
Every rank joins the process group from torchrun's environment: over NCCL
with rank r on `cuda:LOCAL_RANK`, or with --cpu over gloo on the CPU. Only
rank 0 logs and writes checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m plr2_tpu_torch.tools.train")
    p.add_argument("--config", type=str, default="",
                   help="YAML experiment config (not ported: raises)")
    p.add_argument("--dataset", choices=["ycb", "linemod"], default="linemod")
    p.add_argument("--dataset_root", type=str, default="",
                   help="LineMOD (Linemod_preprocessed) or YCB-Video root")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--workers", type=int, default=0,
                   help="native data-plane worker threads (0: inline)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_rate", type=float, default=0.3)
    p.add_argument("--w", type=float, default=0.015)
    p.add_argument("--w_rate", type=float, default=0.3)
    p.add_argument("--decay_margin", type=float, default=0.016)
    p.add_argument("--refine_margin", type=float, default=0.013)
    p.add_argument("--noise_trans", type=float, default=0.03,
                   help="translation noise of the train samples (m)")
    p.add_argument("--iteration", type=int, default=2)
    p.add_argument("--nepoch", type=int, default=500)
    p.add_argument("--repeat_epoch", type=int, default=1)
    p.add_argument("--pretrained_trunk", type=str, default="",
                   help="torchvision resnet18 .pth (not ported: raises)")
    p.add_argument("--resume_posenet", type=str, default="")
    p.add_argument("--resume_refinenet", type=str, default="")
    p.add_argument("--start_epoch", type=int, default=1)
    p.add_argument("--outf", type=str, default="trained_models")
    p.add_argument("--log_dir", type=str, default="experiments/logs")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated frames")
    p.add_argument("--synthetic_frames", type=int, default=4,
                   help="synthetic train-set size in frames (2 samples each)")
    p.add_argument("--batched", action="store_true",
                   help="one optimizer step per batch (mean gradient, batch "
                        "BN) instead of per-sample accumulation")
    p.add_argument("--fused", action="store_true",
                   help="accumulation windows on a shared canvas: per-sample "
                        "semantics (summed gradients, batch-1 BN)")
    p.add_argument("--batched_test", action="store_true",
                   help="batched test loop in the per-sample / --fused modes")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="split each batch over this many ranks (torchrun; "
                        "implies --batched)")
    p.add_argument("--model_parallel", type=int, default=0,
                   help="tensor-parallel `model` axis: slice the fusion "
                        "trunks' and heads' column / row pairs over this "
                        "many ranks of a (data_parallel, N) mesh (torchrun; "
                        "implies --batched)")
    p.add_argument("--sym_slots", type=int, default=0,
                   help="batched-mode ADD-S compaction slots (-1 auto, 0 off)")
    p.add_argument("--cache_mb", type=int, default=0,
                   help="decoded-frame cache per dataset (MB, 0: off)")
    p.add_argument("--num_points", type=int, default=None,
                   help="override the preset's sampled-cloud size")
    p.add_argument("--mesh_points", type=int, default=None,
                   help="override the preset's model-mesh point count")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    return p.parse_args(argv)


def refuse_unsupported(args) -> None:
    """NotImplementedError for every flag the port does not run."""
    refused = [
        (args.config, "--config (YAML) needs config_io.py, which needs "
                      "PyYAML: ROADMAP A8"),
        (args.pretrained_trunk, "--pretrained_trunk (torch_import.py): "
                                "ROADMAP A8"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"not ported: {what}")
    if args.synthetic == bool(args.dataset_root):
        raise SystemExit("give --dataset_root DIR (a LineMOD or YCB-Video "
                         "tree) or --synthetic: pick one")
    if batched_mode(args) and args.fused:
        raise SystemExit("--fused is the exact-semantics mode; --batched / "
                         "--data_parallel is the mean-gradient deviation: "
                         "pick one")


def batched_mode(args) -> bool:
    """JAX's choice (tools/train.py): --batched or any --data_parallel
    (1 included) or --model_parallel > 1 runs BatchTrainer."""
    return bool(args.batched or args.data_parallel or args.model_parallel > 1)


def build_config(args):
    from plr2_tpu_torch.config import TrainConfig, get_preset
    cfg = get_preset("linemod_train" if args.dataset == "linemod"
                     else "ycb_train")
    cfg = dataclasses.replace(cfg, train=TrainConfig(
        batch_size=args.batch_size, lr=args.lr, lr_rate=args.lr_rate,
        w=args.w, w_rate=args.w_rate, decay_margin=args.decay_margin,
        refine_margin=args.refine_margin, refine_iterations=args.iteration,
        nepoch=args.nepoch, repeat_epoch=args.repeat_epoch, seed=args.seed,
        checkpoint_dir=args.outf, log_dir=args.log_dir,
        resume_posenet=args.resume_posenet,
        resume_refinenet=args.resume_refinenet,
        start_epoch=args.start_epoch, workers=args.workers,
        sym_slots=args.sym_slots, fused_accum=args.fused,
        batched_test=args.batched_test))
    cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(
        cfg.dataset, root=args.dataset_root, noise_trans=args.noise_trans))
    if args.data_parallel:
        cfg = dataclasses.replace(cfg, data_parallel=args.data_parallel)
    if args.model_parallel:
        cfg = dataclasses.replace(cfg, model_parallel=args.model_parallel)
    return with_sizes(cfg, args.num_points, args.mesh_points)


def build_datasets(args, cfg):
    """(train, test) datasets: synthetic frames, or the LineMOD / YCB-Video
    tree at --dataset_root (tools/train.py's wiring)."""
    from plr2_tpu_torch.data import (LinemodDataset, SyntheticPoseDataset,
                                     YCBDataset)
    n_pts, mesh = cfg.model.num_points, cfg.dataset.num_mesh_points
    if args.synthetic:
        return (SyntheticPoseDataset(num_frames=args.synthetic_frames,
                                     num_objects=2, model_points=mesh,
                                     num_points=n_pts, seed=args.seed),
                SyntheticPoseDataset(num_frames=max(2, args.synthetic_frames // 8),
                                     num_objects=2, model_points=mesh,
                                     num_points=n_pts, seed=args.seed + 1))
    root, noise, cache = args.dataset_root, cfg.dataset.noise_trans, args.cache_mb
    if args.dataset == "linemod":
        return (LinemodDataset(root, "train", n_pts, mesh, noise_trans=noise,
                               cache_mb=cache),
                LinemodDataset(root, "test", n_pts, mesh, add_noise=False,
                               cache_mb=cache))
    large = cfg.dataset.num_mesh_points_large
    return (YCBDataset(root, "train", n_pts, mesh, noise_trans=noise,
                       num_mesh_points_large=large, cache_mb=cache),
            YCBDataset(root, "test", n_pts, mesh, add_noise=False,
                       num_mesh_points_large=large, cache_mb=cache))


def with_sizes(cfg, num_points=None, mesh_points=None):
    """`cfg` with the sampled-cloud size and the model-mesh point count
    overridden where given (--num_points, --mesh_points)."""
    if not (num_points or mesh_points):
        return cfg
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model, num_points=num_points or cfg.model.num_points),
        dataset=dataclasses.replace(
            cfg.dataset, num_points=num_points or cfg.dataset.num_points,
            num_mesh_points=mesh_points or cfg.dataset.num_mesh_points))


def join_mesh(args):
    """Join torchrun's process group for a D x M mesh: (device, rank), or
    ("cpu" / "cuda", 0) without a mesh. Raises SystemExit unless the world
    size is D x M."""
    ranks = max(args.data_parallel, 1) * max(args.model_parallel, 1)
    if ranks == 1:
        return ("cpu" if args.cpu else "cuda"), 0
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world != ranks:
        raise SystemExit(
            f"--data_parallel {max(args.data_parallel, 1)} x --model_parallel "
            f"{max(args.model_parallel, 1)} needs {ranks} ranks, but the world "
            f"size is {world}: run under torchrun --nproc_per_node {ranks}")
    from plr2_tpu_torch.parallel import init_distributed
    if args.cpu:
        rank, _, _ = init_distributed("gloo")
        return "cpu", rank
    import torch
    rank, _, local_rank = init_distributed("nccl")
    torch.cuda.set_device(local_rank)
    return f"cuda:{local_rank}", rank


def main(argv=None):
    args = parse_args(argv)
    refuse_unsupported(args)
    device, rank = join_mesh(args)
    try:
        return train(args, device, rank)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def train(args, device, rank: int):
    from plr2_tpu_torch.train import (BatchTrainer, CheckpointManager,
                                      FusedTrainer, Trainer)
    from plr2_tpu_torch.utils import GracefulInterrupt, setup_logger

    cfg = build_config(args)
    train_ds, test_ds = build_datasets(args, cfg)
    logger = setup_logger(
        "train", os.path.join(args.log_dir, f"train_{args.dataset}.log"))
    if rank:
        logger.disabled = True  # rank 0 logs for the mesh
    kind = (BatchTrainer if batched_mode(args)
            else FusedTrainer if cfg.train.fused_accum else Trainer)
    # the first SIGTERM / SIGINT latches from here on; fit stops at the
    # next sample boundary and saves `last` (auto-resume replays the epoch)
    with GracefulInterrupt() as stop:
        trainer = kind(cfg, device=device)
        state = trainer.init_state()
        ckpt = CheckpointManager(os.path.join(args.outf, args.dataset))
        if args.resume_posenet or args.resume_refinenet:
            state = trainer.restore_into(ckpt, state,
                                         args.resume_posenet or "best")
            logger.info(f"resumed from epoch {state.epoch} "
                        f"(best_test={state.best_test:.5f})")
        elif ckpt.restore("last") is not None:
            state = trainer.restore_into(ckpt, state, "last")
            logger.info(f"auto-resumed from last checkpoint (epoch {state.epoch})")
        mesh = ("" if trainer.mesh is None else
                f", data_parallel={cfg.data_parallel}, "
                f"model_parallel={cfg.model_parallel}")
        logger.info(f"training {args.dataset} ({kind.__name__}, "
                    f"{trainer.device}{mesh}, "
                    f"{'synthetic' if args.synthetic else args.dataset_root}, "
                    f"{args.workers} workers): {len(train_ds)} train / "
                    f"{len(test_ds)} test samples")
        trainer.fit(state, train_ds, test_ds, epochs=args.nepoch,
                    log_fn=logger.info,
                    checkpoint_fn=lambda s, d: ckpt.save(s, d),
                    save_last_fn=lambda s: ckpt.save(s, s.best_test, tag="last"),
                    stop_fn=stop)
    return state


if __name__ == "__main__":
    main()
