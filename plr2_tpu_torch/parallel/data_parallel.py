"""One optimizer step of DenseFusion training, the port of
plr2_tpu/parallel/data_parallel.py `make_train_step`, `adam_update` and
`make_inference_step`, on one device or over a mesh's `data` axis.

Two stages, as in the JAX package (reference stage semantics):

- stage 1 (`refine_iterations == 0`): PoseNet in train mode (train-mode
  BatchNorm whose running statistics are updated, the PSP channel
  dropouts drawn from the step's generator on the host before the
  forward); loss = `pose_loss(refine=False, max_sym_slots=sym_slots)`
  with the ADD-S branch picked from the batch's host object ids (`obj`,
  where the batch carries them; `mixed` where it does not), by one rule
  eagerly and in a graph: a batch with symmetric and other samples runs
  `compact` where it has at most `sym_slots` symmetric samples, else
  `mixed`, as in JAX. Adam on PoseNet's
  parameters. Reported `dis` is the batch mean of the best-hypothesis
  distance. With `remat` PoseNet's forward is rematerialised in the
  backward, stage by stage (`models/remat.py`; JAX's `jax.checkpoint`):
  the recompute leaves BatchNorm's running statistics alone, so they are
  updated once.
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

`program` is the same computation in the form a CUDA graph captures
(`train/graphs.py`): it reads tensors that are already on the device
(dropout masks included), zeroes the existing `.grad` tensors in place
rather than freeing them, picks no branch from the data, and returns its
loss and `dis` as tensors. For a window (`window=True`, the fused
trainer's) it runs the samples one after another at batch 1, each in the
`mixed` ADD-S form, so one program serves every pattern of symmetric
samples. It runs eagerly on any device, which is how the CPU tests hold
it against `accumulate`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Sequence

import torch

from plr2_tpu_torch.losses.add_loss import pose_loss
from plr2_tpu_torch.losses.refine_loss import refine_loss
from plr2_tpu_torch.models.remat import rematerialised
from plr2_tpu_torch.models.resnet import synced_statistics
from plr2_tpu_torch.parallel.mesh import shard_batch
from plr2_tpu_torch.pipeline import PoseEstimate, full_f32

BATCH_KEYS = ("img", "points", "choose", "target", "model_points", "idx")


def count_symmetric(batch: Mapping, sym_list: Sequence[int]) -> Optional[int]:
    """The batch's number of symmetric samples from its host object ids
    (`batch["obj"]`), or None where the batch does not carry them."""
    obj = batch.get("obj")
    if obj is None:
        return None
    sym = set(sym_list)
    return sum(int(o) in sym for o in obj)


def window_sample(window: Mapping, i: int) -> Dict:
    """Sample `i` of a window as a batch of 1 (with its host object id
    where the window carries them)."""
    b = {k: window[k][i:i + 1] for k in BATCH_KEYS}
    if "obj" in window:
        b["obj"] = window["obj"][i:i + 1]
    return b


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
    batch axis (and optionally `obj`, the host object ids); `generator`
    draws stage 1's dropout masks. `optimizer` (over the stage's network:
    PoseNet in stage 1, PoseRefineNet in the refine stage) is the
    caller's; without one the step builds `adam(network, lr)`, and with
    neither it can only `accumulate`. With `mesh` the batch is the global
    batch, the same on every rank (module docstring)."""

    def __init__(self, pipe, sym_list: Sequence[int], w: float,
                 lr: Optional[float] = None, refine_iterations: int = 0,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 remat: bool = False, sym_slots: Optional[int] = None,
                 mesh=None):
        self.pipe = pipe
        self.mesh = mesh
        self.data_axis = None if mesh is None else mesh.axis("data")
        self.sym_list = tuple(sym_list)
        self.w = w
        self.refine_iterations = refine_iterations
        self.remat = remat
        self.sym_slots = sym_slots
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

    def local(self, batch: Mapping) -> Mapping:
        """This rank's block of a host batch (`BATCH_KEYS` and `obj`; the
        batch itself without a mesh)."""
        if self.mesh is None:
            return batch
        keys = BATCH_KEYS + (("obj",) if "obj" in batch else ())
        return shard_batch(self.mesh, {k: batch[k] for k in keys})

    def count_symmetric(self, batch: Mapping) -> Optional[int]:
        """The symmetric samples of this rank's block of `batch`."""
        return count_symmetric(self.local(batch), self.sym_list)

    def dropout_masks(self, batch_size: int,
                      generator: Optional[torch.Generator],
                      window: bool = False):
        """Stage 1's dropout masks for `batch_size` samples, drawn from
        `generator` on the host as the forward would draw them: for a
        window, sample by sample as its per-sample steps draw them (None in
        the refine stage, whose PoseNet runs in eval mode)."""
        if self.refine_stage:
            return None
        draw = self.pipe.posenet.cnn.model.draw_dropout_masks
        if not window:
            return draw(batch_size, generator)
        each = [draw(1, generator) for _ in range(batch_size)]
        return tuple(None if ms[0] is None else torch.cat(ms)
                     for ms in zip(*each))

    def inputs(self, batch: Mapping, generator: Optional[torch.Generator] = None,
               window: bool = False) -> Dict:
        """`program`'s inputs: the batch (or window) on the pipeline's
        device and its dropout masks (`dropout_masks`), moved there."""
        b = self._batch(batch)
        masks = self.dropout_masks(b["idx"].shape[0], generator, window)
        b["masks"] = None if masks is None else tuple(
            None if m is None else m.to(self.pipe.device) for m in masks)
        if self.mesh is not None:
            if window:
                raise ValueError("a window of per-sample steps does not run "
                                 "on a mesh")
            b = shard_batch(self.mesh, b)
        return b

    def _posenet(self, b, masks):
        with rematerialised(self.pipe.posenet, self.remat):
            return self.pipe.run_posenet(b["img"], b["points"], b["choose"],
                                         b["idx"], None, masks)

    def _stage1_loss(self, b, masks, n_sym, slots):
        self.pipe.posenet.train()
        with synced_statistics(self.pipe.posenet, self.data_axis):
            pred_r, pred_t, pred_c, _ = self._posenet(b, masks)
        out = pose_loss(pred_r, pred_t, pred_c, b["target"],
                        b["model_points"], b["idx"], b["points"], w=self.w,
                        refine=False, sym_list=self.sym_list,
                        use_kernels=self.use_kernels,
                        max_sym_slots=slots, n_sym=n_sym)
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

    def _backward(self, b, masks, n_sym, slots):
        with full_f32(self.pipe.dtype == torch.float32), deterministic_convs():
            if self.refine_stage:
                loss, dis = self._refine_loss(b)
            else:
                loss, dis = self._stage1_loss(b, masks, n_sym, slots)
            loss.backward()
        self.pipe.posenet.eval()
        self.pipe.refiner.eval()
        if self.data_axis is None:
            return loss.detach(), dis.detach()
        self.reduce_gradients()
        metrics = self.data_axis.all_reduce_(
            torch.stack([loss.detach(), dis.detach()]).float())
        metrics = metrics / self.data_axis.size
        return metrics[0], metrics[1]

    def reduce_gradients(self) -> None:
        """Average the network's gradients over the mesh's `data` axis, in
        one all-reduce of one flat buffer. The gradients must hold this
        step's alone: the step zeroes them before its backward."""
        self.data_axis.all_reduce_tensors_(
            [p.grad for p in self.network.parameters() if p.grad is not None],
            mean=True)

    def accumulate(self, batch: Mapping,
                   generator: torch.Generator = None):
        """Forward and backward of `batch`: its gradients are ADDED into
        the network's `.grad` (no optimizer step). Returns (loss, dis),
        0-d tensors, not synchronised."""
        b = self.inputs(batch, generator)
        return self._backward(b, b["masks"], self.count_symmetric(batch),
                              self.sym_slots)

    def program(self, inputs: Mapping, n_sym: Optional[int] = None,
                window: bool = False):
        """The capturable gradient program (module docstring) on
        `inputs` (`TrainStep.inputs`'s: `BATCH_KEYS` and `masks` on the
        pipeline's device, each with the leading batch or window axis).
        Zeroes the network's existing gradients in place, then adds the
        batch's (or each window sample's, in order) into them. Returns
        (loss, dis): 0-d for a batch, (N,) for a window."""
        grads = [p.grad for p in self.network.parameters()
                 if p.grad is not None]
        if grads:
            torch._foreach_zero_(grads)
        masks = inputs["masks"]
        if not window:
            return self._backward(inputs, masks, n_sym, self.sym_slots)
        losses, dists = [], []
        for i in range(inputs["idx"].shape[0]):
            m = None if masks is None else tuple(
                None if x is None else x[i:i + 1] for x in masks)
            loss, dis = self._backward(window_sample(inputs, i), m, None, None)
            losses.append(loss)
            dists.append(dis)
        return torch.stack(losses), torch.stack(dists)

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
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    remat: bool = False, sym_slots: Optional[int] = None,
                    mesh=None) -> TrainStep:
    """The train step of `pipe` (a `DenseFusionPipeline`): stage 1 with
    `refine_iterations=0`, else the refine stage; Adam at `lr` unless the
    caller passes its `optimizer`. `remat` rematerialises PoseNet's
    forward in the backward; `sym_slots=K` runs the stage-1 ADD-S match of
    a mixed batch with at most K symmetric samples on K compacted slots
    (`pose_loss(max_sym_slots=K)`; exact); `mesh` splits the batch over
    its `data` axis (module docstring)."""
    return TrainStep(pipe, sym_list, w, lr, refine_iterations, optimizer,
                     remat, sym_slots, mesh)


def make_inference_step(pipe, refine_iterations: int = 2, mesh=None):
    """`infer(img, points, choose, idx) -> PoseEstimate`: `pipe.estimate`
    on the batch; with `mesh`, each rank estimates its block of the batch
    (the same global batch on every rank) and the poses are gathered back
    to every rank."""
    def infer(img, points, choose, idx) -> PoseEstimate:
        if mesh is None:
            return pipe.estimate(img, points, choose, idx, refine_iterations)
        est = pipe.estimate(*shard_batch(mesh, [img, points, choose, idx]),
                            refine_iterations=refine_iterations)
        data = mesh.axis("data")
        return PoseEstimate(*(data.gather_rows(x) for x in est))
    return infer
