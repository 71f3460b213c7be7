"""Single-frame pose inference CLI, the port of tools/infer.py:

  python -m plr2_tpu_torch.tools.infer --synthetic             # card
  python -m plr2_tpu_torch.tools.infer --synthetic --cpu       # CPU
  python -m plr2_tpu_torch.tools.infer --color c.png --depth d.png \
      --label l.png --obj 1 --points obj.xyz --cam cx,cy,fx,fy,scale

Prints the estimated pose (wxyz quaternion + translation), the confidence
and, against the synthetic frame's ground truth, the ADD error. A real
frame is an RGB PNG, a 16-bit depth PNG and a label PNG (the object's
pixels = --obj), read by `data/codecs.py` (no PIL), with the object's
model as a `.ply` in millimetres or an `.xyz` in metres (500 points
kept, as in JAX). `--model` is a directory of the port's checkpoints
(`best.pt`); without it the weights are the seeded initialisation.
"""

from __future__ import annotations

import argparse
import dataclasses


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m plr2_tpu_torch.tools.infer")
    p.add_argument("--color", type=str, default="")
    p.add_argument("--depth", type=str, default="")
    p.add_argument("--label", type=str, default="")
    p.add_argument("--obj", type=int, default=1, help="object id in the label map")
    p.add_argument("--points", type=str, default="", help="model .xyz/.ply file")
    p.add_argument("--cam", type=str,
                   default="312.9869,241.3109,1066.778,1067.487,10000",
                   help="cx,cy,fx,fy,cam_scale")
    p.add_argument("--model", type=str, default="", help="checkpoint dir")
    p.add_argument("--num_points", type=int, default=1000)
    p.add_argument("--num_objects", type=int, default=21)
    p.add_argument("--refine_iterations", type=int, default=2)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    real = (args.color, args.depth, args.label, args.points)
    if args.synthetic == any(real) or not (args.synthetic or all(real)):
        raise SystemExit("give --synthetic, or a real frame: --color, "
                         "--depth, --label and --points")
    import numpy as np
    import torch

    from plr2_tpu_torch.config import DatasetConfig, ModelConfig, get_preset
    from plr2_tpu_torch.data import SyntheticPoseDataset, draw, raw_to_sample
    from plr2_tpu_torch.eval.metrics import add_distance
    from plr2_tpu_torch.train import CheckpointManager, Trainer

    if args.synthetic:
        raw = SyntheticPoseDataset(num_frames=1, num_objects=1,
                                   model_points=500,
                                   num_points=args.num_points, seed=0).get_raw(0)
    else:
        raw = real_frame(args)
    cfg = dataclasses.replace(
        get_preset("ycb_refine"),
        dataset=DatasetConfig(num_points=args.num_points,
                              num_objects=args.num_objects),
        model=ModelConfig(num_points=args.num_points,
                          num_objects=args.num_objects))
    trainer = Trainer(cfg, device="cpu" if args.cpu else "cuda")
    if args.model:
        ckpt = CheckpointManager(args.model)
        if ckpt.restore("best") is None:
            raise SystemExit(f"no checkpoint found under {args.model!r}")
        state = ckpt.restore_into(trainer.init_state())
        print(f"loaded checkpoint (epoch {state.epoch})")
    pipe = trainer.pipe
    s = raw_to_sample(raw, draw(torch.Generator().manual_seed(0)),
                      args.num_points, add_noise=False, device=pipe.device)
    est = pipe.estimate(s.img[None], s.points[None], s.choose[None],
                        s.idx[None], refine_iterations=args.refine_iterations)
    q = est.quat[0].float().cpu().numpy()
    t = est.trans[0].float().cpu().numpy()
    print(f"pose quaternion (wxyz): {np.round(q.astype(np.float64), 5).tolist()}")
    print(f"translation (m):        {np.round(t.astype(np.float64), 5).tolist()}")
    print(f"confidence:             {float(est.confidence[0]):.4f}")
    if not args.synthetic:
        return est, None
    err = float(add_distance(s.model_points, est.quat[0], est.trans[0],
                             s.target))
    print(f"ADD error vs ground truth: {err:.4f} m "
          "(untrained weights unless --model given)")
    return est, err


def real_frame(args):
    """The raw dict of --color / --depth / --label / --points / --cam (an
    identity pose: a real frame has no ground truth), as tools/infer.py
    builds it."""
    import numpy as np

    from plr2_tpu_torch.data.codecs import read_png
    from plr2_tpu_torch.data.linemod import parse_ply_vertices
    cx, cy, fx, fy, cam_scale = (float(x) for x in args.cam.split(","))
    color = read_png(args.color, "RGB")
    depth = np.asarray(read_png(args.depth), dtype=np.float32)
    label = np.asarray(read_png(args.label), dtype=np.int32)
    if args.points.endswith(".ply"):
        mp = parse_ply_vertices(args.points) / 1000.0
    else:
        mp = np.loadtxt(args.points, dtype=np.float32)
    if len(mp) > 500:
        mp = mp[np.sort(np.random.default_rng(0).choice(len(mp), 500,
                                                        replace=False))]
    return dict(color=color, depth=depth,
                mask=(label == args.obj) & (depth > 0),
                target_r=np.eye(3, dtype=np.float32),
                target_t=np.zeros(3, np.float32),
                model_points=mp.astype(np.float32),
                obj_idx=args.obj - 1,
                intrinsics=dict(cx=cx, cy=cy, fx=fx, fy=fy,
                                cam_scale=cam_scale))


if __name__ == "__main__":
    main()
