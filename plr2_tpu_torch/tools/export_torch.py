"""Export a training checkpoint of the port as reference-layout .pth
files, the port of tools/export_torch.py: the reference's PyTorch stack
(upstream lib/network.py) loads them with `load_state_dict(strict=True)`,
and `models/torch_import.load_reference_checkpoint` reads them back.

  python -m plr2_tpu_torch.tools.export_torch --checkpoint trained_models/linemod \
      --out_dir exported/      # pose_model.pth + pose_refine_model.pth
  python -m plr2_tpu_torch.tools.export_torch --checkpoint trained_models/ycb \
      --tag best --reference_names   # pose_model_<epoch>_<dis>.pth naming

A port checkpoint is one `<tag>.pt` under a `CheckpointManager` directory
(`<outf>/<dataset>/`) holding both networks' upstream state dicts and the
curriculum scalars; the export splits it into the reference's two files.
It moves tensors only, on the CPU.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m plr2_tpu_torch.tools.export_torch")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="checkpoint dir (CheckpointManager root) or the "
                        "path of one saved tag (e.g. .../linemod/best.pt)")
    p.add_argument("--tag", type=str, default="best")
    p.add_argument("--out_dir", type=str, default=".")
    p.add_argument("--reference_names", action="store_true",
                   help="name files pose_model_<epoch>_<dis>.pth like the "
                        "reference's epoch-best saves")
    p.add_argument("--no_refiner", action="store_true",
                   help="export only the PoseNet .pth")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the paths written."""
    args = parse_args(argv)
    from plr2_tpu_torch.models.torch_export import save_reference_checkpoint
    from plr2_tpu_torch.train import CheckpointManager

    ckpt_dir, tag = args.checkpoint, args.tag
    if os.path.isfile(ckpt_dir):  # one saved tag, not the manager root
        ckpt_dir, tag = os.path.dirname(os.path.abspath(ckpt_dir)), ckpt_dir
    payload = CheckpointManager(ckpt_dir).restore(tag)
    if payload is None:
        raise SystemExit(f"no checkpoint {tag!r} under {ckpt_dir!r}")
    meta = payload["meta"]

    if args.reference_names:
        stem = f"_{int(meta['epoch'])}_{float(meta['best_test']):.6f}.pth"
        pose_name, refine_name = "pose_model" + stem, "pose_refine_model" + stem
    else:
        pose_name, refine_name = "pose_model.pth", "pose_refine_model.pth"

    os.makedirs(args.out_dir, exist_ok=True)
    pose_path = os.path.join(args.out_dir, pose_name)
    refine_path = "" if args.no_refiner else os.path.join(args.out_dir,
                                                          refine_name)
    save_reference_checkpoint(payload, pose_path, refine_path)
    print(f"wrote {pose_path}")
    if refine_path:
        print(f"wrote {refine_path}")
    print(f"(epoch {int(meta['epoch'])}, best test dis "
          f"{float(meta['best_test']):.6f})")
    return [p for p in (pose_path, refine_path) if p]


if __name__ == "__main__":
    main()
