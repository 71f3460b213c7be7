"""Segmentation training CLI, the port of tools/train_segmentation.py (the
reference's vanilla_segmentation/train.py):

  python -m plr2_tpu_torch.tools.train_segmentation --synthetic --nepoch 2          # card
  python -m plr2_tpu_torch.tools.train_segmentation --synthetic --nepoch 1 --cpu    # CPU
  python -m plr2_tpu_torch.tools.train_segmentation --dataset_root /data/YCB_Video_Dataset

Trains a segmenter (`--arch segnet`, the reference-parity VGG16, or
`pspnet`, the light ResNet-18 stride-8 segmenter for serving) with
`train/seg_trainer.py` on the colour / label frames of a YCB-Video train
split (read with no PIL) or of synthetic scenes, and writes `last.pt`
after every epoch and `best.pt` on a lower epoch loss under `--save_path`
(the segmenter's state dict; `tools.segment_linemod --model` and `serve
--seg_model` read it). The first SIGTERM / SIGINT stops at the next batch
boundary and saves `last`; a second one aborts. The card is the default
device; without CUDA it raises unless --cpu is given.
"""

from __future__ import annotations

import argparse
import os
import types


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m plr2_tpu_torch.tools.train_segmentation")
    p.add_argument("--dataset_root", type=str, default="")
    p.add_argument("--nepoch", type=int, default=600)
    p.add_argument("--batch_size", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--num_classes", type=int, default=22)
    p.add_argument("--arch", type=str, default="segnet",
                   choices=("segnet", "pspnet"),
                   help="segnet = reference-parity VGG16; pspnet = light "
                        "ResNet-18 stride-8 segmenter for serving")
    p.add_argument("--crop", type=int, default=128)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--logs_path", type=str, default="experiments/logs/seg")
    p.add_argument("--save_path", type=str,
                   default="experiments/trained_models/seg",
                   help="directory for best.pt / last.pt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    return p.parse_args(argv)


def load_frames(args):
    """(color, label) frames: 6 synthetic scenes of 3 objects, or the
    YCB-Video train split."""
    import numpy as np

    if args.synthetic == bool(args.dataset_root):
        raise SystemExit("give --dataset_root DIR (a YCB-Video tree) or "
                         "--synthetic: pick one")
    if args.synthetic:
        from plr2_tpu_torch.data.synthetic import make_scene
        return [make_scene(num_objects=3, seed=s)[0] for s in range(6)]
    from plr2_tpu_torch.data import YCBDataset
    ds = YCBDataset(args.dataset_root, "train")
    frames = []
    for i in range(len(ds)):
        fr = ds.get_frame(i)
        frames.append(types.SimpleNamespace(
            color=fr["color"], label=np.asarray(fr["label"], np.int32)))
    return frames


def main(argv=None):
    args = parse_args(argv)
    frames = load_frames(args)
    from plr2_tpu_torch.train.seg_trainer import SegTrainer, save_weights
    from plr2_tpu_torch.utils.interrupt import GracefulInterrupt
    from plr2_tpu_torch.utils.logger import setup_logger

    logger = setup_logger("seg", os.path.join(args.logs_path, "train.log"))
    trainer = SegTrainer(num_classes=args.num_classes, lr=args.lr,
                         crop=args.crop, batch=args.batch_size, arch=args.arch,
                         device="cpu" if args.cpu else "cuda")
    state = trainer.init_state(args.seed)
    last = os.path.join(args.save_path, "last.pt")
    with GracefulInterrupt() as stop:
        for epoch in range(1, args.nepoch + 1):
            # stop is checked at batch boundaries inside the epoch, so a
            # SIGTERM mid-epoch saves 'last' within one step
            state = trainer.train_epoch(state, frames, seed=epoch, stop_fn=stop)
            if state["interrupted"]:
                save_weights(last, trainer.model)
                logger.info(f"interrupt requested: stopped during epoch "
                            f"{epoch} at a batch boundary ('last' saved)")
                break
            logger.info(f"epoch {epoch}: loss={state['last_epoch_loss']:.5f} "
                        f"({state['seconds']:.1f}s)")
            save_weights(last, trainer.model)
            if state["last_epoch_loss"] < state["best_loss"]:
                state["best_loss"] = state["last_epoch_loss"]
                save_weights(os.path.join(args.save_path, "best.pt"),
                             trainer.model)
            if stop():
                logger.info(f"interrupt requested: stopped cleanly after "
                            f"epoch {epoch} ('last' saved)")
                break
    return state


if __name__ == "__main__":
    main()
