"""One optimizer step of DenseFusion training on one device, the port of
plr2_tpu/parallel/data_parallel.py `make_train_step` and `adam_update`
(single device: `mesh=None`, `remat=False`; the mesh and rematerialisation
wait for the parallel layer).

Two stages, as in the JAX package (reference stage semantics):

- stage 1 (`refine_iterations == 0`): PoseNet in train mode (train-mode
  BatchNorm whose running statistics are updated, the PSP channel
  dropouts drawn from the step's generator); loss = `pose_loss(refine=
  False)`; Adam on PoseNet's parameters. Reported `dis` is the batch mean
  of the best-hypothesis distance.
- refine stage (`refine_iterations > 0`): PoseNet frozen in eval mode
  under `no_grad`; `pose_loss(refine=True)` re-centres cloud and target by
  the best hypothesis; `refine_iterations` PoseRefineNet calls on the
  detached embedding; loss = the sum of the per-iteration mean `dis`;
  Adam on PoseRefineNet's parameters. Reported `dis` is the last
  iteration's mean.

Adam is `torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)` (`adam`),
optax's `adam` defaults; the two differ only in rounding. The optimizer
belongs to the caller where it passes one (a trainer keeps it in its
`TrainState`, so Adam's moments live across epochs and are rebuilt only
at a curriculum switch or a resume); otherwise the step builds its own
from `lr`. `accumulate` runs the forward and backward of one batch and
adds its gradients into the parameters' `.grad` without stepping (the
per-sample trainers sum a window's gradients this way); calling the step
is zero_grad, `accumulate`, one optimizer step. A mixed-precision
pipeline (`DenseFusionPipeline(dtype=torch.bfloat16)`) runs the networks
in bf16 over its f32 parameters. An f32 pipeline's step runs with TF32
off (`pipeline.full_f32`), whatever the caller set. Every step runs with
cuDNN restricted to deterministic algorithms (`deterministic_convs`), so
two runs of one step from one state give bit-equal gradients. The step runs on the
pipeline's device ("cuda" unless the pipeline was built with
device="cpu"); the batch is moved there.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Sequence

import torch

from plr2_tpu_torch.losses.add_loss import pose_loss
from plr2_tpu_torch.losses.refine_loss import refine_loss
from plr2_tpu_torch.pipeline import full_f32

BATCH_KEYS = ("img", "points", "choose", "target", "model_points", "idx")


@contextlib.contextmanager
def deterministic_convs():
    """Within the block cuDNN runs only deterministic algorithms (without
    the flag its heuristics may pick a weight-gradient algorithm that adds
    by atomics); the caller's flag is restored on exit."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = saved


def adam(module: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam over `module`'s parameters at optax's defaults."""
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


class TrainStep:
    """`step(batch, generator) -> {"loss": ..., "dis": ...}` (0-d tensors,
    not synchronised). `batch` is a mapping of `BATCH_KEYS` with a leading
    batch axis; `generator` draws stage 1's dropout masks. `optimizer`
    (over the stage's network: PoseNet in stage 1, PoseRefineNet in the
    refine stage) is the caller's; without one the step builds
    `adam(network, lr)`, and with neither it can only `accumulate`."""

    def __init__(self, pipe, sym_list: Sequence[int], w: float,
                 lr: Optional[float] = None, refine_iterations: int = 0,
                 optimizer: Optional[torch.optim.Optimizer] = None):
        self.pipe = pipe
        self.sym_list = tuple(sym_list)
        self.w = w
        self.refine_iterations = refine_iterations
        # a pipeline built with use_kernels=False runs every kernel's
        # plain version, the loss's match included
        self.use_kernels = pipe.posenet.use_kernels
        if optimizer is None and lr is not None:
            optimizer = adam(self.network, lr)
        # None: the step only accumulates (`accumulate`)
        self.optimizer = optimizer

    @property
    def network(self) -> torch.nn.Module:
        """The network this stage trains."""
        return self.pipe.refiner if self.refine_stage else self.pipe.posenet

    @property
    def refine_stage(self) -> bool:
        return self.refine_iterations > 0

    def _batch(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k]).to(self.pipe.device)
                for k in BATCH_KEYS}

    def _stage1_loss(self, b, generator):
        self.pipe.posenet.train()
        pred_r, pred_t, pred_c, _ = self.pipe.run_posenet(
            b["img"], b["points"], b["choose"], b["idx"], generator)
        out = pose_loss(pred_r, pred_t, pred_c, b["target"],
                        b["model_points"], b["idx"], b["points"], w=self.w,
                        refine=False, sym_list=self.sym_list,
                        use_kernels=self.use_kernels)
        return out.loss, out.dis.mean()

    def _refine_loss(self, b):
        self.pipe.posenet.eval()
        self.pipe.refiner.train()
        with torch.no_grad():
            pred_r, pred_t, pred_c, emb = self.pipe.run_posenet(
                b["img"], b["points"], b["choose"], b["idx"])
            out = pose_loss(pred_r, pred_t, pred_c, b["target"],
                            b["model_points"], b["idx"], b["points"],
                            w=self.w, refine=True, sym_list=self.sym_list,
                            use_kernels=self.use_kernels)
        new_points, new_target = out.new_points, out.new_target
        loss = 0.0
        for _ in range(self.refine_iterations):
            dr, dt = self.pipe.run_refiner(new_points, emb, b["idx"])
            ro = refine_loss(dr, dt, new_target, b["model_points"], b["idx"],
                             new_points, sym_list=self.sym_list,
                             use_kernels=self.use_kernels)
            new_points, new_target = ro.new_points, ro.new_target
            loss = loss + ro.dis.mean()
        return loss, ro.dis.mean()

    def accumulate(self, batch: Mapping,
                   generator: torch.Generator = None):
        """Forward and backward of `batch`: its gradients are ADDED into
        the network's `.grad` (no optimizer step). Returns (loss, dis),
        0-d tensors, not synchronised."""
        b = self._batch(batch)
        with full_f32(self.pipe.dtype == torch.float32), deterministic_convs():
            if self.refine_stage:
                loss, dis = self._refine_loss(b)
            else:
                loss, dis = self._stage1_loss(b, generator)
            loss.backward()
        self.pipe.posenet.eval()
        self.pipe.refiner.eval()
        return loss.detach(), dis.detach()

    def apply(self) -> None:
        """One optimizer step on the accumulated gradients, then clear them."""
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def __call__(self, batch: Mapping,
                 generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        self.optimizer.zero_grad(set_to_none=True)
        loss, dis = self.accumulate(batch, generator)
        self.optimizer.step()
        return {"loss": loss, "dis": dis}


def make_train_step(pipe, sym_list: Sequence[int], w: float,
                    lr: Optional[float] = None, refine_iterations: int = 0,
                    optimizer: Optional[torch.optim.Optimizer] = None
                    ) -> TrainStep:
    """The train step of `pipe` (a `DenseFusionPipeline`): stage 1 with
    `refine_iterations=0`, else the refine stage; Adam at `lr` unless the
    caller passes its `optimizer`."""
    return TrainStep(pipe, sym_list, w, lr, refine_iterations, optimizer)
