"""Faults planted underneath a cell's timed path, to show that `correct`
catches them (`benchmark/tests/test_bench_faults.py` on the CPU; `control.py
--mode fault` reads them on the card). Each is a context manager that
patches the program while it is open.

Serve cells, each keeping the flags (valid / oversized) as the program
made them: `stale` (every call answered with the first call's poses),
`half` (the second half of a call's frames never estimated: their poses
and confidences left at zero; a one-frame call is its own second half),
`slot` (two object slots of each frame mis-indexed: slot 0 answered with
slot 1's pose and the reverse), `pick` (the least confident hypothesis
of each crop refined in place of the most confident), `altered` (the
estimate's translation off by 30% where it is produced). Training
cells: `unchanged` (the optimizer step leaves the parameters as they
were), `half` (half of a step's samples never reach the gradient: the
batch cut to its first half, its mean taken over the rest; a window's
later samples adding nothing), `altered` (the step's loss off by 1%
where it is produced).
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

SERVE = ("stale", "half", "slot", "pick", "altered")
TRAIN = ("unchanged", "half", "altered")


@contextlib.contextmanager
def planted(kind: str, name: str, window: int = 0):
    """Plant fault `name` for a cell of `kind` ("serve" or "train";
    `window`: a window cell's samples a step)."""
    with (_serve if kind == "serve" else _train)(name, window):
        yield


def _serve(name, _window):
    from plr2_tpu_torch.pipeline import DenseFusionPipeline
    from plr2_tpu_torch.serving import FrameEstimator

    if name == "stale":
        real, first = FrameEstimator._dispatch, []

        def stale(self, with_samples, args):
            if not first:
                first.append(real(self, with_samples, args))
            return first[0]
        return mock.patch.object(FrameEstimator, "_dispatch", stale)
    if name in ("half", "slot"):
        real = FrameEstimator._program

        def cut(self, with_samples, *args):
            poses = real(self, with_samples, *args)
            quat, trans, conf = poses.quat, poses.trans, poses.confidence
            if name == "half":
                h = quat.shape[0] // 2
                quat, trans, conf = (
                    torch.cat([x[:h], torch.zeros_like(x[h:])])
                    for x in (quat, trans, conf))
            else:
                order = torch.arange(quat.shape[1], device=quat.device)
                order = torch.where(order < 2, 1 - order, order)
                quat, trans, conf = (x[:, order] for x in (quat, trans, conf))
            return poses._replace(quat=quat, trans=trans, confidence=conf)
        return mock.patch.object(FrameEstimator, "_program", cut)
    if name == "pick":
        from plr2_tpu_torch import pipeline

        real = pipeline.initial_pose

        def least(pred_r, pred_t, pred_c, points):
            return real(pred_r, pred_t, -pred_c, points)
        return mock.patch.object(pipeline, "initial_pose", least)
    if name == "altered":
        real = DenseFusionPipeline.estimate

        def altered(self, *a, **k):
            est = real(self, *a, **k)
            return est._replace(trans=est.trans * 1.3)
        return mock.patch.object(DenseFusionPipeline, "estimate", altered)
    raise ValueError(f"no serve fault {name!r}")


def _train(name, window):
    from plr2_tpu_torch.parallel.data_parallel import TrainStep

    if name == "unchanged":
        return mock.patch.object(torch.optim.Adam, "step",
                                 lambda self, *a, **k: None)
    if name == "half" and not window:
        real = TrainStep._batch

        def half(self, batch):
            b = real(self, batch)
            n = b["idx"].shape[0] // 2
            return {k: v[:n] for k, v in b.items()}
        return mock.patch.object(TrainStep, "_batch", half)
    if name == "half":
        real = TrainStep.program

        def half_window(self, inputs, n_sym=None, window=False):
            n = inputs["idx"].shape[0] // 2
            cut = {k: (None if v is None else
                       tuple(None if m is None else m[:n] for m in v)
                       if k == "masks" else v[:n])
                   for k, v in inputs.items()}
            loss, dis = real(self, cut, n_sym, window)
            pad = inputs["idx"].shape[0] - n
            return (torch.cat([loss, loss.new_zeros(pad)]),
                    torch.cat([dis, dis.new_zeros(pad)]))
        real_acc, seen = TrainStep.accumulate, [0]

        def half_acc(self, batch, generator=None):  # the eager window
            seen[0] += 1
            if (seen[0] - 1) % window >= window // 2:
                zero = torch.zeros((), device=self.pipe.device)
                return zero, zero
            return real_acc(self, batch, generator)
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(TrainStep, "program",
                                              half_window))
        stack.enter_context(mock.patch.object(TrainStep, "accumulate",
                                              half_acc))
        return stack
    if name == "altered":
        real = TrainStep._backward

        def altered(self, *a, **k):
            loss, dis = real(self, *a, **k)
            return loss * 1.01, dis
        return mock.patch.object(TrainStep, "_backward", altered)
    raise ValueError(f"no training fault {name!r}")
