"""The fused gradient-accumulation window, the port of
plr2_tpu/train/fused_accum.py.

In JAX the window is one `lax.scan` program per window; its semantics are
exactly N per-sample steps: the same summation order, batch-1 BatchNorm
threaded sample by sample, a dropout draw per sample, one Adam step. Here
the window is a loop over its samples through the per-sample code of
`Trainer` (`TrainStep.accumulate`, which adds each sample's gradients into
`.grad` in order), so it computes the per-sample loop's function by
construction: on the same samples the summed gradients are bit-equal
(tests/test_torch_port_trainer.py). The one difference from `Trainer` is
the canvas: `FusedTrainer` stacks the window on a shared border-list
canvas, so crops smaller than the canvas see zero padding (the batched
modes' contract).

Capturing a window in one CUDA graph (the counterpart of JAX's one
program per window) is later work, not done here.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch

from plr2_tpu_torch.parallel.data_parallel import BATCH_KEYS, TrainStep, adam


def make_fused_window_grads(pipe, sym_list: Sequence[int], w: float,
                            refine_iterations: int = 0):
    """`grads(window, generator) -> (losses (N,), dists (N,))`: the window's
    per-sample gradients summed into the stage network's `.grad` (cleared
    first), without the optimizer step. `window` maps `BATCH_KEYS` to
    tensors whose leading axis is the window's samples in order;
    `generator` draws stage 1's dropout masks, one sample after another."""
    step = TrainStep(pipe, sym_list, w, refine_iterations=refine_iterations)

    def grads(window: Mapping, generator: Optional[torch.Generator] = None):
        step.network.zero_grad(set_to_none=True)
        losses, dists = [], []
        for i in range(len(window["idx"])):
            loss, dis = step.accumulate({k: window[k][i:i + 1]
                                         for k in BATCH_KEYS}, generator)
            losses.append(loss)
            dists.append(dis)
        return torch.stack(losses), torch.stack(dists)

    grads.network = step.network
    return grads


def make_fused_accum_step(pipe, sym_list: Sequence[int], w: float,
                          lr: Optional[float] = None,
                          refine_iterations: int = 0,
                          optimizer: Optional[torch.optim.Optimizer] = None):
    """`step(window, generator) -> {"loss": (N,), "dis": (N,)}`: the
    window's summed gradients, then one step of `optimizer` (the caller's,
    or Adam at `lr` over the stage's network). With `refine_iterations > 0`
    this is the refine stage (PoseNet frozen in eval mode, the refiner
    trained)."""
    grads = make_fused_window_grads(pipe, sym_list, w, refine_iterations)
    if optimizer is None:
        optimizer = adam(grads.network, lr)

    def step(window: Mapping, generator: Optional[torch.Generator] = None):
        losses, dists = grads(window, generator)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return {"loss": losses, "dis": dists}

    step.optimizer = optimizer
    return step
