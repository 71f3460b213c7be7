"""Predicted LineMOD masks, the port of tools/segment_linemod.py: renders
the upstream `segnet_results/` layout from a trained segmenter,

  python -m plr2_tpu_torch.tools.segment_linemod --dataset_root DIR \\
      --model experiments/trained_models/seg/best.pt --out DIR/segnet_results

then `python -m plr2_tpu_torch.tools.eval_linemod --dataset_root DIR
--segnet_results DIR/segnet_results` evaluates with those masks. `--model`
is a state dict that `tools.train_segmentation` saved (`best.pt`); frames
are read and masks written with no PIL. The card is the default device;
without CUDA it raises unless --cpu is given.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m plr2_tpu_torch.tools.segment_linemod")
    p.add_argument("--dataset_root", type=str, required=True)
    p.add_argument("--model", type=str, required=True,
                   help="segmenter weights (train_segmentation's best.pt)")
    p.add_argument("--out", type=str, required=True,
                   help="output segnet_results directory")
    p.add_argument("--num_classes", type=int, default=14,
                   help="background + objlist classes")
    p.add_argument("--arch", type=str, default="segnet",
                   choices=("segnet", "pspnet"))
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from plr2_tpu_torch.eval.segment import segnet_predictor, write_segnet_results
    from plr2_tpu_torch.train.seg_trainer import SegTrainer, load_weights

    trainer = SegTrainer(num_classes=args.num_classes, arch=args.arch,
                         device="cpu" if args.cpu else "cuda")
    load_weights(args.model, trainer.model)
    n = write_segnet_results(args.dataset_root, args.out,
                             segnet_predictor(trainer), split=args.split)
    print(f"wrote {n} predicted masks under {args.out}")
    return n


if __name__ == "__main__":
    main()
