"""Learning-dynamics check, the port of tools/overfit_synthetic.py: overfit
one stacked batch of synthetic frames and print the ADD distance's
trajectory, which exercises the gradients end to end through the colour
encoder, the fusion trunk, the heads and the loss.

  python -m plr2_tpu_torch.tools.overfit_synthetic --steps 300          # card
  python -m plr2_tpu_torch.tools.overfit_synthetic --steps 300 --bf16   # mixed
  python -m plr2_tpu_torch.tools.overfit_synthetic --steps 4 --cpu      # CPU

The batch is `--batch` samples of `max(2, batch // 2)` frames (two objects
each), stacked on a `--crop` px canvas; the samples' draws and the
dropout masks come from explicit `torch.Generator`s. Each step is
`parallel/data_parallel.make_train_step` (stage 1 with no symmetric
objects, or the refine stage with --refine_iterations > 0); --bf16 is
mixed precision (bf16 compute over f32 parameters, optimizer and loss).
The last line gives the steps' wall time and samples/s, which include the
synchronisations of the printed steps.
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m plr2_tpu_torch.tools.overfit_synthetic")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--num_points", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--refine_iterations", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision: bf16 network compute, f32 "
                        "parameters / optimizer / loss")
    p.add_argument("--crop", type=int, default=240,
                   help="stack_samples canvas size (crops must fit)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns {"history": [(step, loss, dis), ...], "seconds", "samples_per_s"}."""
    args = parse_args(argv)
    import torch

    from plr2_tpu_torch.data import (SyntheticPoseDataset, draw, raw_to_sample,
                                     stack_samples)
    from plr2_tpu_torch.parallel import make_train_step
    from plr2_tpu_torch.pipeline import DenseFusionPipeline

    device = "cpu" if args.cpu else "cuda"
    pipe = DenseFusionPipeline(num_points=args.num_points, num_objects=4,
                               device=device, seed=0,
                               dtype=torch.bfloat16 if args.bf16 else torch.float32)
    ds = SyntheticPoseDataset(num_frames=max(2, args.batch // 2),
                              num_objects=2, model_points=256,
                              num_points=args.num_points, seed=0)
    g_data = torch.Generator().manual_seed(0)
    samples = [raw_to_sample(ds.get_raw(i % len(ds)), draw(g_data),
                             args.num_points, device=pipe.device)
               for i in range(args.batch)]
    bs = stack_samples(samples, crop=args.crop)
    batch = {k: getattr(bs, k) for k in ("img", "points", "choose", "target",
                                         "model_points", "idx")}
    step = make_train_step(pipe, sym_list=(), w=0.015, lr=args.lr,
                           refine_iterations=args.refine_iterations)
    g_drop = torch.Generator().manual_seed(1)

    history = []
    t0 = time.time()
    for i in range(args.steps):
        m = step(batch, g_drop)
        if i % max(1, args.steps // 15) == 0 or i == args.steps - 1:
            loss, dis = float(m["loss"]), float(m["dis"])
            history.append((i, loss, dis))
            print(f"step {i:4d}: loss={loss:.5f} dis={dis:.5f}", flush=True)
    dt = time.time() - t0
    rate = args.steps * args.batch / dt
    print(f"{args.steps} steps in {dt:.1f}s ({rate:.1f} samples/s)")
    return {"history": history, "seconds": dt, "samples_per_s": rate}


if __name__ == "__main__":
    main()
