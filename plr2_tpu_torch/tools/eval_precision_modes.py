"""Accuracy of the bf16 inference mode against the f32 mode, the port of
tools/eval_precision_modes.py:

  python -m plr2_tpu_torch.tools.eval_precision_modes --ckpt DIR [--cpu]

Loads a checkpoint directory of the port (`best.pt`: PoseNet's and the
refiner's state dicts, e.g. a synthetic end-to-end run's) and runs the
held-out eval protocol (ADD-S AUC / <2cm / mean distance / 0.1*diameter
success) in each mode:

  f32    full f32 (TF32 off), the reference-parity mode
  bf16   `pipe.cast(torch.bfloat16)`: bf16 weights and compute

with a bootstrap std per metric and the paired bf16 - f32 AUC interval
(the same resample indices in both modes). The JAX CLI's `+phase` rows
(the phase-decomposed upsample) have no counterpart here: the port's
decoder is the `upconv3x3_prelu` kernel in either mode. The number of
objects is read from the checkpoint.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m plr2_tpu_torch.tools.eval_precision_modes")
    p.add_argument("--ckpt", type=str, default="trained_models/synthetic_e2e",
                   help="checkpoint directory of the port (tag 'best')")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    p.add_argument("--test_frames", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=16,
                   help="eval estimate batch")
    p.add_argument("--bootstrap", type=int, default=200,
                   help="bootstrap resamples for the per-mode metric std")
    p.add_argument("--num_points", type=int, default=500)
    p.add_argument("--mesh_points", type=int, default=256)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.data import SyntheticPoseDataset
    from plr2_tpu_torch.eval import compute_auc, evaluate, success_rate
    from plr2_tpu_torch.train import CheckpointManager

    payload = CheckpointManager(args.ckpt).restore("best")
    if payload is None:
        print(f"no checkpoint at {args.ckpt}: train one with "
              "python -m plr2_tpu_torch.tools.train first")
        return 1
    refine = bool(payload["meta"]["refine_started"])
    num_objects = payload["posenet"]["conv4_c.weight"].shape[0]
    # held-out frames: the JAX CLI's construction
    test_ds = SyntheticPoseDataset(num_frames=args.test_frames, num_objects=2,
                                   model_points=args.mesh_points,
                                   num_points=args.num_points, seed=31)
    device = "cpu" if args.cpu else "cuda"
    pair_sig = None  # (object, count) layout of the first mode's samples
    mode_aucs = {}  # name -> (point AUC, bootstrap AUC array)
    n_samples = 0
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        pipe = DenseFusionPipeline(args.num_points, num_objects, device=device,
                                   seed=None)
        pipe.posenet.load_state_dict(payload["posenet"], strict=True)
        pipe.refiner.load_state_dict(payload["refiner"], strict=True)
        if dtype != torch.float32:
            pipe.cast(dtype)
        res = evaluate(pipe, test_ds, sym_list=tuple(range(num_objects)),
                       refine_iterations=(2 if refine else 0),
                       diameters=test_ds.diameters,
                       batch_size=args.batch_size)
        n_samples = res.num_samples
        # bootstrap over paired (distance, 0.1 * diameter threshold), so
        # each mode gap can be read against sampling noise
        dists = np.concatenate([np.asarray(d, np.float64)
                                for d in res.per_object_distances.values()])
        thresh = np.concatenate([
            np.full(len(d), 0.1 * test_ds.diameters.get(o, 0.1))
            for o, d in res.per_object_distances.items()])
        # the paired delta needs every mode to see the same samples in the
        # same order
        sig = [(o, len(d)) for o, d in res.per_object_distances.items()]
        if pair_sig is None:
            pair_sig = sig
        assert sig == pair_sig, (
            f"mode {name!r} evaluated another sample set or order than the "
            f"first mode, so the paired bootstrap is invalid: {sig} vs "
            f"{pair_sig}")
        rng = np.random.default_rng(0)
        aucs, twocm, succ = [], [], []
        for _ in range(args.bootstrap):
            sel = rng.integers(0, dists.size, size=dists.size)
            samp = dists[sel]
            aucs.append(compute_auc(samp.tolist()))
            twocm.append(success_rate(samp.tolist(), 0.02))
            succ.append(float(np.mean(samp < thresh[sel])))
        print(f"{name:5s} ADD-S AUC={res.auc:.2f}±{np.std(aucs):.2f}  "
              f"<2cm={res.under_2cm * 100:.1f}±{np.std(twocm) * 100:.1f}%  "
              f"mean_dis={res.mean_distance * 1000:.2f} mm  "
              f"0.1d-success={res.mean_success * 100:.1f}"
              f"±{np.std(succ) * 100:.1f}%", flush=True)
        mode_aucs[name] = (res.auc, np.asarray(aucs))
    # paired difference: both modes' bootstraps used the same resample
    # indices (the generator re-seeded per mode)
    (base_pt, base_bs), (pt, bs) = mode_aucs["f32"], mode_aucs["bf16"]
    lo, hi = np.percentile(bs - base_bs, [2.5, 97.5])
    verdict = "includes 0" if lo <= 0.0 <= hi else "EXCLUDES 0"
    print(f"AUC delta bf16 vs f32: {pt - base_pt:+.3f} (paired 95% CI "
          f"[{lo:+.3f}, {hi:+.3f}] — {verdict})", flush=True)
    print(f"({n_samples} held-out samples/mode, {args.bootstrap} bootstrap "
          "resamples; the JAX CLI's +phase rows have no port counterpart)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
