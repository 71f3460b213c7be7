"""Full-curriculum end-to-end run on synthetic data, the port of
tools/train_synthetic_e2e.py: batched training through the decay and
refiner-switch stages with best-checkpoint saving, then the held-out
evaluation of the standard protocol (ADD-S AUC, < 2 cm).

Unlike `overfit_synthetic` (one batch), this trains on many frames and
scores unseen frames of the same objects.

  python -m plr2_tpu_torch.tools.train_synthetic_e2e --steps 1500       # card
  python -m plr2_tpu_torch.tools.train_synthetic_e2e --steps 4 --batch 2 \
      --num_points 64 --train_frames 2 --test_frames 1 --eval_every 2 --cpu

Every train sample is prepared once (noise on, draws from a seeded
`torch.Generator`) and stacked into batches of --batch on a 240 px
canvas, which the steps cycle through. Every --eval_every steps (and at
the last) `Trainer.test_epoch` scores the held-out frames,
`Trainer.update_curriculum` applies the decay / refine switches, an
improvement saves `best` under --outf, and a switch rebuilds the step
(and Adam) for the new stage, as the JAX tool does. All four objects are
scored as symmetric (`sym_list` (0, 1, 2, 3)), so every stage-1 step runs
the ADD-S match. The held-out `evaluate` prints
`FINAL: ADD-S AUC=... <2cm=...`, and the last line the run's wall time.
"""

from __future__ import annotations

import argparse
import time

SYM_LIST = (0, 1, 2, 3)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m plr2_tpu_torch.tools.train_synthetic_e2e")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--num_points", type=int, default=500)
    p.add_argument("--train_frames", type=int, default=24)
    p.add_argument("--test_frames", type=int, default=6)
    p.add_argument("--test_seed", type=int, default=31,
                   help="seed of the held-out monitor / model-selection set; "
                        "a seed other than 31 keeps the curriculum's "
                        "checkpoint gating apart from the seed-31 set that "
                        "eval_precision_modes scores")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--decay_margin", type=float, default=0.016)
    p.add_argument("--refine_margin", type=float, default=0.013)
    p.add_argument("--eval_every", type=int, default=200)
    p.add_argument("--outf", type=str, default="trained_models/synthetic_e2e_torch")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the final `EvalResult`."""
    args = parse_args(argv)
    t_start = time.time()
    import torch

    from plr2_tpu_torch.config import (DatasetConfig, ModelConfig,
                                       PipelineConfig, TrainConfig)
    from plr2_tpu_torch.data import (SyntheticPoseDataset, draw, raw_to_sample,
                                     stack_samples)
    from plr2_tpu_torch.eval import evaluate
    from plr2_tpu_torch.parallel import make_train_step
    from plr2_tpu_torch.pipeline import DenseFusionPipeline
    from plr2_tpu_torch.train import CheckpointManager, Trainer

    num_objects = 4
    pipe = DenseFusionPipeline(num_points=args.num_points,
                               num_objects=num_objects,
                               device="cpu" if args.cpu else "cuda", seed=0)
    train_ds = SyntheticPoseDataset(num_frames=args.train_frames,
                                    num_objects=2, model_points=256,
                                    num_points=args.num_points, seed=0)
    # held-out frames: other seeds, so novel box instances and poses
    test_ds = SyntheticPoseDataset(num_frames=args.test_frames,
                                   num_objects=2, model_points=256,
                                   num_points=args.num_points,
                                   seed=args.test_seed)
    cfg = PipelineConfig(
        dataset=DatasetConfig(num_points=args.num_points,
                              num_objects=num_objects, sym_list=SYM_LIST),
        model=ModelConfig(num_points=args.num_points, num_objects=num_objects),
        train=TrainConfig(lr=args.lr, decay_margin=args.decay_margin,
                          refine_margin=args.refine_margin))
    trainer = Trainer(cfg, pipe)
    state = trainer.init_state()
    ckpt = CheckpointManager(args.outf)

    # every train batch prepared once on the device, then cycled
    print("preparing batches...", flush=True)
    g_data = torch.Generator().manual_seed(1)
    samples = [raw_to_sample(train_ds.get_raw(i), draw(g_data),
                             args.num_points, add_noise=True, device=pipe.device)
               for i in range(len(train_ds))]
    groups = [samples[s0:s0 + args.batch]
              for s0 in range(0, len(samples) - args.batch + 1, args.batch)]
    batches = []
    for group in groups or [samples]:
        bs = stack_samples(group, crop=240)
        batches.append({k: getattr(bs, k) for k in (
            "img", "points", "choose", "target", "model_points", "idx", "obj")})
    print(f"{len(batches)} batches of {args.batch}", flush=True)

    def build_step():
        return make_train_step(
            pipe, sym_list=SYM_LIST, w=state.w, lr=state.lr,
            refine_iterations=(cfg.train.refine_iterations
                               if state.refine_started else 0))

    step = build_step()
    g_drop = torch.Generator().manual_seed(2)
    t0 = time.time()
    for i in range(args.steps):
        m = step(batches[i % len(batches)], g_drop)
        if (i + 1) % args.eval_every == 0 or i == args.steps - 1:
            test_dis = trainer.test_epoch(
                state, test_ds, torch.Generator().manual_seed(10 ** 6 + i))
            improved = test_dis < state.best_test
            prev = (state.decay_started, state.refine_started)
            state = trainer.update_curriculum(state, test_dis)
            print(f"step {i + 1:5d}: train_dis={float(m['dis']):.5f} "
                  f"test_dis={test_dis:.5f} best={state.best_test:.5f} "
                  f"decay={state.decay_started} refine={state.refine_started} "
                  f"({time.time() - t0:.0f}s)", flush=True)
            if improved:
                ckpt.save(state, test_dis)
            if (state.decay_started, state.refine_started) != prev:
                step = build_step()
                print(f"  curriculum switch: lr={state.lr:g} w={state.w:g} "
                      f"refine={state.refine_started} (new step and Adam)",
                      flush=True)

    res = evaluate(pipe, test_ds, sym_list=SYM_LIST,
                   refine_iterations=(2 if state.refine_started else 0),
                   diameters=test_ds.diameters)
    print(f"FINAL: ADD-S AUC={res.auc:.2f}  <2cm={res.under_2cm * 100:.1f}%  "
          f"mean_dis={res.mean_distance:.4f} m  "
          f"mean_success={res.mean_success * 100:.1f}% "
          f"({res.num_samples} held-out samples)", flush=True)
    print(f"wall {time.time() - t_start:.1f}s (set-up, {args.steps} steps, "
          f"evaluations)", flush=True)
    return res


if __name__ == "__main__":
    main()
