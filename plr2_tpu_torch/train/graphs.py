"""The gradient program of a training step or window as one CUDA graph:
the counterpart of the JAX package's one `jit` program per batched step
and one `lax.scan` program per fused window.

`GradientGraphs` keeps one graph per key (the trainer's stage, `w`, the
ADD-S branch, and every input's shape and dtype) until `clear`. A
trainer's keys are few and bounded: between two clears (a curriculum
switch, a resume, a `cast`) its stage and `w` are fixed, so a key is a
border-list canvas (`trainer.snap_canvas`: the BORDER_LIST sizes from the
crop size up) and, for a batch, one of the four ADD-S branches (a window
has one). All graphs are captured into one memory pool, the first
graph's: replays run one at a time on one stream and `run` copies the
outputs right after each, so a graph may reuse the blocks that graphs
captured before it freed, where they fit.

The first call of a key runs the program eagerly on a side stream
(`utils/cuda_graphs.capture`), undoes that warm-up's side effects (it
added into `.grad` and updated BatchNorm's running statistics: the
statistics go back to their snapshot, and every gradient the program
writes becomes the graphs' own tensor for that parameter, one shared by
all of them), then captures the program. Every call copies its inputs into the graph's static
buffers, binds each parameter's `.grad` to the graph's gradient tensor (a
caller may have set it to None since), and replays: the program zeroes
those gradients in place and adds the batch's into them. The optimizer
step stays eager after the replay, reading `.grad` as it would after an
eager step.

A graph holds the parameters' storage, so the graphs are dropped when it
changes (`DenseFusionPipeline.cast`); the trainers drop them at a
curriculum switch and at the start of `fit` (a resume). A capture or a
replay that fails raises: there is no eager fallback.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Tuple

import torch

from plr2_tpu_torch.losses.add_loss import loss_branch
from plr2_tpu_torch.models.resnet import batchnorm_buffers
from plr2_tpu_torch.utils.cuda_graphs import (capture, clone, copy_into,
                                              weights_key)


class _Entry(NamedTuple):
    graph: Any            # utils.cuda_graphs.Graph
    grads: Tuple          # (parameter, the graph's gradient tensor) pairs


def _signature(tree) -> Any:
    """The shapes and dtypes of a tree of tensors (None where absent)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, Mapping):
        return tuple((k, _signature(v)) for k, v in sorted(tree.items()))
    return tuple(_signature(t) for t in tree)


class GradientGraphs:
    """One CUDA graph per key of a gradient program (module docstring)."""

    def __init__(self):
        self.captures = 0  # graphs captured so far (a count for callers)
        self._entries: Dict[Any, _Entry] = {}
        self._weights = None
        self._pool = None  # the shared memory pool (the first graph's)
        self._grads: Dict[int, Tuple] = {}  # id -> (parameter, its .grad)

    @property
    def held(self) -> int:
        """The number of graphs held (one per key seen since `clear`)."""
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self._pool = None
        self._grads.clear()

    def _grad(self, p: torch.Tensor) -> torch.Tensor:
        """The gradient tensor that every graph writes for parameter `p`."""
        held = self._grads.get(id(p))
        if held is None or held[0] is not p:
            held = self._grads[id(p)] = (p, torch.zeros_like(p))
        return held[1]

    def run(self, key, step, program: Callable, inputs: Mapping):
        """Replay `program(inputs)` (a `TrainStep.program` of `step`) from
        the graph of (key, the inputs' shapes and dtypes), capturing it on
        the first call; returns a copy of the program's outputs."""
        weights = weights_key(step.pipe)
        if weights != self._weights:
            self.clear()
            self._weights = weights
        key = (key, _signature(inputs))
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = self._capture(step, program, inputs)
        else:
            copy_into(entry.graph.inputs[0], inputs)
        for p, g in entry.grads:
            p.grad = g
        entry.graph.graph.replay()
        return clone(entry.graph.outputs)

    def _capture(self, step, program: Callable, inputs: Mapping) -> _Entry:
        params = list(step.network.parameters())
        stats = batchnorm_buffers(step.pipe.posenet)
        snapshot = [b.clone() for b in stats]
        for p in params:
            p.grad = None

        def after_warmup():
            with torch.no_grad():
                for b, s in zip(stats, snapshot):
                    b.copy_(s)
            for p in params:
                if p.grad is not None:
                    p.grad = self._grad(p)

        graph = capture(program, (inputs,), after_warmup, self._pool)
        if self._pool is None:
            self._pool = graph.graph.pool()
        self.captures += 1
        return _Entry(graph, tuple((p, p.grad) for p in params
                                   if p.grad is not None))

    def gradients(self, step, batch: Mapping, generator=None,
                  window: bool = False):
        """`step.program` on `batch` (a window of samples with `window`)
        through its graph: (loss, dis), 0-d for a batch, (N,) for a
        window. The dropout masks are drawn from `generator` on the host;
        the ADD-S branch (part of the key) from the batch's host object
        ids, `mixed` where it carries none; a window runs `mixed` per
        sample."""
        inputs = step.inputs(batch, generator, window)
        n_sym = None if window else step.count_symmetric(batch)
        branch = "window" if window else loss_branch(
            inputs["idx"].shape[0], n_sym, step.refine_stage, step.sym_list,
            step.sym_slots)
        key = (step.refine_iterations, step.w, step.sym_slots, branch)
        return self.run(key, step,
                        lambda inp: step.program(inp, n_sym, window), inputs)
