"""The fused gradient-accumulation window, the port of
plr2_tpu/train/fused_accum.py.

In JAX the window is one `lax.scan` program per window; its semantics are
exactly N per-sample steps: the same summation order, batch-1 BatchNorm
threaded sample by sample, a dropout draw per sample, one Adam step. The
port has two forms of the same function:

- on the card, by default, ONE CUDA graph per window shape
  (`train/graphs.py`): `TrainStep.program(window=True)` runs the samples
  in order at batch 1, each in the `mixed` ADD-S form (ADD and ADD-S on
  its row, then a select: one program whatever the window's symmetric
  samples are), adds their gradients into `.grad` and updates BatchNorm
  sample by sample; the dropout masks are drawn on the host first, sample
  by sample, with the calls of the per-sample loop. Adam stays eager after
  the replay (`torch.optim.Adam`, the trainer's own).
- with `graphs=False`, or on a CPU pipeline, the per-sample loop of
  `Trainer` (`TrainStep.accumulate` sample by sample, the ADD-S branch
  picked from each sample's host object id).

Both compute the per-sample loop's function: on the same samples the
summed gradients are bit-equal (tests/test_torch_port_trainer.py,
tests/test_torch_port_graphs.py). The one difference from `Trainer` is the
canvas: `FusedTrainer` stacks the window on a shared border-list canvas,
so crops smaller than the canvas see zero padding (the batched modes'
contract).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import torch

from plr2_tpu_torch.parallel.data_parallel import TrainStep, adam, window_sample
from plr2_tpu_torch.train.graphs import GradientGraphs


def make_fused_window_grads(pipe, sym_list: Sequence[int], w: float,
                            refine_iterations: int = 0,
                            graphs: Union[bool, GradientGraphs] = True):
    """`grads(window, generator) -> (losses (N,), dists (N,))`: the window's
    per-sample gradients summed into the stage network's `.grad` (replacing
    what was there), without the optimizer step. `window` maps `BATCH_KEYS`
    (and optionally `obj`, the host object ids) to tensors whose leading
    axis is the window's samples in order; `generator` draws stage 1's
    dropout masks, one sample after another. `graphs`: True runs the
    window as a CUDA graph on a CUDA pipeline (graphs kept by this
    function) and the per-sample loop on a CPU one; a `GradientGraphs`
    (the caller's, kept across calls) runs it through those; False runs
    the per-sample loop."""
    step = TrainStep(pipe, sym_list, w, refine_iterations=refine_iterations)
    if graphs is True:
        graphs = GradientGraphs() if pipe.device.type == "cuda" else None
    elif graphs is False:
        graphs = None

    def grads(window: Mapping, generator: Optional[torch.Generator] = None):
        if graphs is not None:
            return graphs.gradients(step, window, generator, window=True)
        step.network.zero_grad(set_to_none=True)
        losses, dists = [], []
        for i in range(len(window["idx"])):
            loss, dis = step.accumulate(window_sample(window, i), generator)
            losses.append(loss)
            dists.append(dis)
        return torch.stack(losses), torch.stack(dists)

    grads.network = step.network
    grads.graphs = graphs
    return grads


def make_fused_accum_step(pipe, sym_list: Sequence[int], w: float,
                          lr: Optional[float] = None,
                          refine_iterations: int = 0,
                          optimizer: Optional[torch.optim.Optimizer] = None,
                          graphs: Union[bool, GradientGraphs] = True):
    """`step(window, generator) -> {"loss": (N,), "dis": (N,)}`: the
    window's summed gradients (`make_fused_window_grads`, whose `graphs`
    this takes), then one step of `optimizer` (the caller's, or Adam at
    `lr` over the stage's network). With `refine_iterations > 0` this is
    the refine stage (PoseNet frozen in eval mode, the refiner trained).
    The per-sample loop clears the gradients after the step; the graph
    keeps its gradient tensors, which its next replay zeroes."""
    grads = make_fused_window_grads(pipe, sym_list, w, refine_iterations,
                                    graphs)
    if optimizer is None:
        optimizer = adam(grads.network, lr)

    def step(window: Mapping, generator: Optional[torch.Generator] = None):
        losses, dists = grads(window, generator)
        optimizer.step()
        if grads.graphs is None:
            optimizer.zero_grad(set_to_none=True)
        return {"loss": losses, "dis": dists}

    step.optimizer = optimizer
    return step
