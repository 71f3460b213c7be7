"""Frame-serving CLI over `plr2_tpu_torch.serving.FrameEstimator`, the port
of tools/serve.py:

  python -m plr2_tpu_torch.tools.serve --synthetic --num_frames 8          # card
  python -m plr2_tpu_torch.tools.serve --synthetic --batch 8               # run_frames
  python -m plr2_tpu_torch.tools.serve --synthetic --num_frames 2 --cpu    # CPU
  python -m plr2_tpu_torch.tools.serve --dataset_root /data/YCB_Video_Dataset
  python -m plr2_tpu_torch.tools.serve --synthetic --seg_arch pspnet --seg_scale 2

Streams RGB-D frames through the frame program (one CUDA graph per
static-knob set on the card; `--eager` runs without graphs) and prints one
JSON line per frame with the per-object poses and the wall latency of the
call, the pose download included; the first frame of a knob set pays the
warm-up and the capture. The frames are synthetic scenes (--synthetic), or
the test split of a YCB-Video tree (--dataset_root: `YCBDataset.get_frame`,
its GT label maps and the first --max_objects labelled objects, read with
no PIL). Frame i's key words derive from seed i in both modes, so
`--batch` serves the same poses as single frames. `--model` is a
directory of the port's checkpoints (`best.pt`); without it the weights
are the seeded initialisation. `--seg_arch {segnet,pspnet}` segments each
frame on the device inside the frame program (the frame's label map is
then not read), with `--seg_model`'s weights (a state dict from
`tools.train_segmentation`, 22 classes) or seeded ones, on an s-times
smaller frame with `--seg_scale s`; with --bf16 the segmenter runs in bf16
too. Without --cpu it runs on the CUDA card or raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

NUM_OBJECTS = 21


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m plr2_tpu_torch.tools.serve")
    p.add_argument("--dataset_root", type=str, default="",
                   help="YCB-Video root (its test split)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--model", type=str, default="",
                   help="checkpoint directory (tag 'best')")
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--batch", type=int, default=1,
                   help=">1: batched run_frames throughput mode")
    p.add_argument("--max_objects", type=int, default=5)
    p.add_argument("--num_points", type=int, default=1000)
    p.add_argument("--iters", type=int, default=4,
                   help="refinement iterations")
    p.add_argument("--canvas", type=int, default=240)
    p.add_argument("--auto_grow_canvas", action="store_true",
                   help="single-frame mode: when a detection's snapped "
                        "window exceeds the canvas, build an estimator (a "
                        "new graph) at the next border-list canvas and "
                        "serve the frame again instead of dropping the "
                        "object")
    p.add_argument("--seg_arch", type=str, default="",
                   choices=("", "segnet", "pspnet"),
                   help="segment the frames on the device with this segmenter")
    p.add_argument("--seg_model", type=str, default="",
                   help="segmenter weights (train_segmentation's best.pt); "
                        "needs --seg_arch")
    p.add_argument("--seg_scale", type=int, default=1,
                   help="run the segmenter on an s-times downsampled frame")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--eager", action="store_true",
                   help="run the frame program eagerly (no CUDA graphs)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    return p.parse_args(argv)


def refuse_unsupported(args) -> None:
    if args.synthetic and args.dataset_root:
        raise SystemExit("give --dataset_root DIR (a YCB-Video tree) or "
                         "--synthetic: pick one")
    if args.seg_model and not args.seg_arch:
        raise SystemExit("--seg_model needs --seg_arch (segnet or pspnet)")


def build_pipeline(args):
    """The pipeline at YCB width on the requested device: seeded weights,
    or `--model`'s `best.pt`; cast to bf16 with --bf16."""
    import torch

    from plr2_tpu_torch import DenseFusionPipeline
    device = "cpu" if args.cpu else "cuda"
    pipe = DenseFusionPipeline(args.num_points, NUM_OBJECTS, device=device,
                               seed=0)
    if args.model:
        from plr2_tpu_torch.config import DatasetConfig, ModelConfig, get_preset
        from plr2_tpu_torch.train import CheckpointManager, Trainer

        cfg = dataclasses.replace(
            get_preset("ycb_refine"),
            dataset=DatasetConfig(num_points=args.num_points,
                                  num_objects=NUM_OBJECTS),
            model=ModelConfig(num_points=args.num_points,
                              num_objects=NUM_OBJECTS))
        trainer = Trainer(cfg, pipe)
        ckpt = CheckpointManager(args.model)
        if ckpt.restore("best") is None:
            raise SystemExit(f"serve: no checkpoint found under {args.model!r} "
                             "(refusing to serve randomly initialised weights)")
        state = ckpt.restore_into(trainer.init_state())
        print(f"loaded checkpoint (epoch {state.epoch})", file=sys.stderr)
    if args.bf16:
        pipe.cast(torch.bfloat16)
    return pipe


def load_segmenter(args, pipe):
    """The --seg_arch segmenter (22 classes: background and the 21 YCB
    objects) on the pipeline's device: --seg_model's weights or seeded
    ones, in bf16 with --bf16; None without --seg_arch."""
    if not args.seg_arch:
        return None
    import torch

    from plr2_tpu_torch.models.segnet import build_segmenter as build
    from plr2_tpu_torch.train.seg_trainer import load_weights
    seg = build(args.seg_arch, NUM_OBJECTS + 1, device=pipe.device, seed=1)
    if args.seg_model:
        load_weights(args.seg_model, seg)
    return seg.to(torch.bfloat16) if args.bf16 else seg


def synthetic_frames(num_frames: int, k: int):
    """(color, depth, label, obj_ids (k,), model_points (k, 500, 3), intr)
    per frame: make_scene's objects in the first slots, 0 in the rest, and
    every slot's mesh from a present object."""
    import numpy as np

    from plr2_tpu_torch.data.synthetic import make_scene
    for i in range(num_frames):
        frame, models = make_scene(num_objects=min(k, 8), model_points=500,
                                   seed=i)
        oids = np.zeros(k, np.int64)
        present = sorted(frame.poses)
        oids[:len(present)] = present[:k]
        mps = np.stack([models[present[j % len(present)]] for j in range(k)])
        intr = [frame.intrinsics[n] for n in ("cx", "cy", "fx", "fy",
                                              "cam_scale")]
        yield (frame.color, frame.depth.astype(np.float32),
               frame.label.astype(np.int32), oids, mps.astype(np.float32),
               np.asarray(intr, np.float32))


def ycb_frames(root: str, num_frames: int, k: int, num_points: int):
    """The same tuples from the first `num_frames` frames of a YCB-Video
    test split (tools/serve.py's frame source): the frame's first k
    labelled objects (1-based label ids), their 500-point meshes, zeros in
    the slots beyond."""
    import numpy as np

    from plr2_tpu_torch.data import YCBDataset
    ds = YCBDataset(root, "test", num_points, 500, add_noise=False)
    n_mesh = ds.get_num_points_mesh()
    for i in range(min(num_frames, len(ds))):
        fr = ds.get_frame(i)
        present = sorted(fr["objects"])[:k]
        oids = np.zeros(k, np.int64)
        oids[:len(present)] = [o + 1 for o in present]
        mps = np.zeros((k, n_mesh, 3), np.float32)
        for j, o in enumerate(present):
            mps[j] = ds.model_points[o]
        intr = [fr["intrinsics"][n] for n in ("cx", "cy", "fx", "fy",
                                              "cam_scale")]
        yield (fr["color"], fr["depth"].astype(np.float32),
               fr["label"].astype(np.int32), oids, mps,
               np.asarray(intr, np.float32))


def next_canvas(c: int) -> int:
    from plr2_tpu_torch.data.bbox import BORDER_LIST
    return next((b for b in BORDER_LIST if b > c), c)


def main(argv=None):
    args = parse_args(argv)
    refuse_unsupported(args)
    import numpy as np

    from plr2_tpu_torch.serving import FrameEstimator
    from plr2_tpu_torch.utils.interrupt import GracefulInterrupt

    pipe = build_pipeline(args)
    seg = load_segmenter(args, pipe)
    k = args.max_objects

    def estimator(canvas):
        return FrameEstimator(pipe, canvas=canvas, refine_iterations=args.iters,
                              seg_model=seg, seg_scale=args.seg_scale,
                              graphs=not args.eager)
    fe = estimator(args.canvas)
    totals = {"dropped": 0, "oversized": 0}

    def emit(i, ms, oids, poses, slot0=0):
        def pick(x, *tail):  # frame slot0's (k, *tail) slice on the host
            return x.cpu().numpy().reshape((-1, k) + tail)[slot0]
        quat, trans, conf = (pick(x.double(), *t) for x, t in (
            (poses.quat, (4,)), (poses.trans, (3,)), (poses.confidence, ())))
        valid, over = pick(poses.valid), pick(poses.oversized)
        objs = [{"obj": int(oids[j]), "valid": bool(valid[j]),
                 "quat": quat[j].round(5).tolist(),
                 "trans": trans[j].round(5).tolist(),
                 "conf": float(conf[j])} for j in range(k)]
        dropped = int(((np.asarray(oids) > 0) & ~valid).sum())
        n_over = int(over.sum())
        totals["dropped"] += dropped
        totals["oversized"] += n_over
        line = {"frame": i, "ms": round(ms, 2), "objects": objs}
        if dropped:
            line["dropped"] = dropped
        if n_over:
            line["oversized"] = n_over
        print(json.dumps(line), flush=True)

    def serve_one(fe_, i, color, depth, label, oids, mps, intr):
        """One frame through `run`; with --auto_grow_canvas, a new
        estimator at the next border-list canvas while a detection's
        window exceeds the canvas."""
        t0 = time.perf_counter()
        poses = fe_.run(color, depth, label, oids, mps, intr, i)
        over = poses.oversized.cpu().numpy()  # the wall includes the fetch
        while (args.auto_grow_canvas and over.any()
               and next_canvas(fe_.canvas) <= min(fe_.img_h, fe_.img_w)):
            grown = next_canvas(fe_.canvas)
            print(f"oversized window at canvas {fe_.canvas}: new estimator "
                  f"at {grown}", file=sys.stderr, flush=True)
            fe_ = estimator(grown)
            poses = fe_.run(color, depth, label, oids, mps, intr, i)
            over = poses.oversized.cpu().numpy()
        emit(i, (time.perf_counter() - t0) * 1e3, oids, poses)
        return fe_

    # graceful drain: the first SIGTERM / SIGINT finishes the frame (or
    # batch) in flight and stops; a second one aborts
    served = 0
    with GracefulInterrupt() as stop:
        frames = (ycb_frames(args.dataset_root, args.num_frames, k,
                             args.num_points) if args.dataset_root
                  else synthetic_frames(args.num_frames, k))
        if args.batch <= 1:
            for item in frames:
                if stop():
                    break
                fe = serve_one(fe, served, *item)
                served += 1
        else:
            buf = []
            for item in frames:
                if stop():
                    buf = []
                    break
                buf.append(item)
                if len(buf) < args.batch:
                    continue
                stacked = [np.stack(x) for x in zip(*buf)]
                t0 = time.perf_counter()
                poses = fe.run_frames(*stacked, np.arange(served,
                                                          served + len(buf)))
                poses.quat.cpu()
                ms = (time.perf_counter() - t0) * 1e3 / len(buf)
                for f in range(len(buf)):
                    emit(served + f, ms, stacked[3][f], poses, slot0=f)
                served += len(buf)
                buf = []
            # a tail short of a full batch: one frame at a time through the
            # single-frame program rather than dropped
            for item in buf:
                if stop():
                    break
                fe = serve_one(fe, served, *item)
                served += 1
        if stop():
            print("interrupt requested: drained in-flight work and stopped",
                  file=sys.stderr)
        print(f"served {served} frames", file=sys.stderr)
        if totals["dropped"]:
            print(f"dropped {totals['dropped']} object slots "
                  f"({totals['oversized']} oversized windows"
                  + ("" if args.auto_grow_canvas else
                     " - rerun with --auto_grow_canvas or a larger "
                     "--canvas") + ")", file=sys.stderr)
    return served, totals


if __name__ == "__main__":
    main()
