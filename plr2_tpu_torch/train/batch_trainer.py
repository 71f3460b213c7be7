"""BatchTrainer, the port of plr2_tpu/train/batch_trainer.py: one optimizer
step per batch, on one device or over a process-group mesh.

Fixed-canvas batches, one optimizer step per batch (`make_train_step`).
Two deliberate differences from the per-sample Trainer, as in JAX: the
loss and gradient are the batch MEAN (the reference sums `batch_size`
per-sample gradients), and BatchNorm sees real batch statistics. The tail
batch is padded by cycling its own samples, and the test epoch is always
batched. The curriculum is `Trainer`'s. With `ModelConfig.dtype =
"bfloat16"` the pipeline trains in mixed precision.

`TrainConfig.sym_slots` sizes the stage-1 ADD-S compaction as JAX's
`_sym_slots` does (-1: twice the expected symmetric count of a batch,
0: off, K < batch: K slots), and the branch of each batch is picked from
its samples' host object ids. On the card each step's forward and
backward is one CUDA graph per (stage, canvas, dtype, `w`, branch)
(`train/graphs.py`; `graphs=False` runs them eagerly), followed by the
eager Adam step.

The mesh (`parallel/`). With `data_parallel = dp > 1` the ranks of the
process group (one a device: torchrun, or `parallel.init_distributed`)
form a `data` axis of dp ranks; with `model_parallel = mp > 1` a (dp, mp)
(`data`, `model`) mesh, as JAX builds it (`mesh=` passes one instead).
Every rank prepares the same global batch from the same seeded
generators, keeps its block of batch_size / dp samples (the batch size
must divide by dp) and averages its gradients over `data`
(`parallel/data_parallel.py`), so a step computes the single-device step
on the global batch, BatchNorm's statistics included. A `model` axis
slices the fusion trunks' and heads' column / row pairs over its ranks
(`parallel/tensor_parallel.py`), whose heads then run per-layer
`F.linear` in place of kernel 1, as JAX's tensor parallelism needs its
XLA head path. The test epoch estimates each rank's block and gathers the
distances. Only rank 0 logs and writes checkpoints; under a `model` axis
every rank first gathers the whole weights, so a checkpoint holds them,
and `restore_into` loads whole weights back into the slices. The ranks
agree on `fit`'s `stop_fn` at every batch and epoch boundary (a signal
latches on each rank at its own moment), so all of them stop at one
boundary and rank 0 saves `last`: every rank passes a stop_fn, or none
does. Graphs
capture the step's collectives, which NCCL allows and gloo does not: on a
gloo mesh on the card `graphs=True` raises (pass graphs=False).
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import List, Optional

import torch

from plr2_tpu_torch.parallel.data_parallel import TrainStep, adam
from plr2_tpu_torch.parallel.mesh import make_mesh, shard_batch
from plr2_tpu_torch.parallel.tensor_parallel import gathered, shard_pipeline
from plr2_tpu_torch.train.graphs import GradientGraphs
from plr2_tpu_torch.train.trainer import Trainer, TrainState, child_generator
from plr2_tpu_torch.utils.profiling import span


class BatchTrainer(Trainer):
    """Trainer with batched optimizer steps, each a CUDA graph on the card
    unless `graphs=False`; over a mesh when the config or `mesh` asks."""

    runs_on_mesh = True

    def __init__(self, config, pipe=None, device="cuda", graphs: bool = True,
                 mesh=None):
        super().__init__(config, pipe, device)
        dp = max(config.data_parallel, 1)
        mp = max(config.model_parallel, 1)
        if mesh is None and mp > 1:
            mesh = make_mesh(dp * mp, ("data", "model"), shape=(dp, mp))
        elif mesh is None and dp > 1:
            mesh = make_mesh(dp)
        self.mesh = mesh
        self.tensor_parallel = mesh is not None and "model" in mesh.shape
        if mesh is not None:
            if config.train.batch_size % mesh.shape["data"]:
                raise ValueError(
                    f"batch_size {config.train.batch_size} not divisible by "
                    f"data_parallel {mesh.shape['data']}")
            if self.tensor_parallel:
                shard_pipeline(mesh, self.pipe)
        if graphs and self.device.type == "cuda":
            if mesh is not None and mesh.backend != "nccl":
                raise ValueError(
                    f"a graphed mesh step captures its collectives, which "
                    f"the {mesh.backend} backend cannot: use NCCL (one card "
                    f"a rank) or pass graphs=False")
            self.graphs = GradientGraphs()

    def _sym_slots(self) -> Optional[int]:
        """JAX's rule: -1 is 2 * ceil(batch * the symmetric fraction of the
        objects), capped at the batch; a K outside (0, batch) is off."""
        s = self.cfg.train.sym_slots
        b = self.cfg.train.batch_size
        if s == -1:
            frac = len(self.sym_list) / max(self.cfg.dataset.num_objects, 1)
            s = min(b, max(1, 2 * math.ceil(b * frac)))
        return s if 0 < s < b else None

    def stage_step(self, state: TrainState) -> TrainStep:
        step = super().stage_step(state)
        step.sym_slots = self._sym_slots()
        return step

    def _step(self, step: TrainStep, batch, generator):
        """One optimizer step; the span `plr2.train.step` around it (opened
        by `TrainStep.__call__` on the eager path)."""
        if self.graphs is None:
            return step(batch, generator)
        with span("plr2.train.step"):
            loss, dis = self.graphs.gradients(step, batch, generator)
            with span("plr2.train.adam"):
                step.optimizer.step()
            return {"loss": loss, "dis": dis}

    def _batches(self, dataset, generator, seed: int):
        """Stacked fixed-canvas batches; the tail is cycle-padded (every
        real sample still contributes)."""
        bsz = self.cfg.train.batch_size
        pending: List = []
        for s in self._sample_iter(dataset, generator,
                                   add_noise=self.cfg.dataset.add_noise,
                                   shuffle=True, seed=seed):
            pending.append(s)
            if len(pending) == bsz:
                yield self._stack_eval(pending)
                pending = []
        if pending:
            n = len(pending)
            yield self._stack_eval([pending[i % n] for i in range(bsz)])

    def train_epoch(self, state: TrainState, dataset, generator):
        step = self.stage_step(state)
        losses, dists = [], []
        interrupted = False
        t0 = time.time()
        for rep in range(self.cfg.train.repeat_epoch):
            if interrupted:
                break
            g_data, g_drop = child_generator(generator), child_generator(generator)
            for batch in self._batches(dataset, g_data,
                                       seed=state.epoch * 997 + rep):
                # stop at a batch boundary: the last step is complete
                if self._stop_fn is not None and self._stop_fn():
                    interrupted = True
                    break
                m = self._step(step, batch, g_drop)
                losses.append(m["loss"])
                dists.append(m["dis"])
        return state, self._epoch_info(losses, dists, t0, interrupted)

    def test_epoch(self, state: TrainState, dataset, generator) -> float:
        """Always batched (`Trainer._test_epoch_batched`)."""
        return self._test_epoch_batched(state, dataset, generator)

    @torch.no_grad()
    def eval_dis(self, batch, refine_iterations: int = 0) -> torch.Tensor:
        """`Trainer.eval_dis` of this rank's block, gathered over `data`."""
        if self.mesh is None:
            return super().eval_dis(batch, refine_iterations)
        dis = super().eval_dis(shard_batch(self.mesh, dict(batch)),
                               refine_iterations)
        return self.mesh.axis("data").gather_rows(dis)

    # ---------- rank 0 writes; the whole weights under a model axis ----------

    def _whole_weights(self):
        """Context: the pipeline holds its whole weights (tensor parallel)."""
        if self.tensor_parallel:
            return gathered(self.mesh, self.pipe)
        return contextlib.nullcontext()

    def _on_rank0(self, fn, weights: bool):
        if fn is None or self.mesh is None:
            return fn

        def run(*args):
            with self._whole_weights() if weights else contextlib.nullcontext():
                return fn(*args) if self.mesh.rank == 0 else None
        return run

    def restore_into(self, ckpt, state: TrainState, tag: str = "best"):
        """`ckpt.restore_into(state, tag)`; under a `model` axis the whole
        weights load into this rank's slices and Adam is rebuilt over them."""
        if not self.tensor_parallel:
            return ckpt.restore_into(state, tag)
        with self._whole_weights():
            state = ckpt.restore_into(state, tag)
        net = self.pipe.refiner if state.refine_started else self.pipe.posenet
        state.optimizer = adam(net, state.lr)
        return state

    def fit(self, state: TrainState, train_ds, test_ds, generator=None,
            epochs=None, log_fn=print, checkpoint_fn=None, save_last_fn=None,
            stop_fn=None) -> TrainState:
        """`Trainer.fit`; on a mesh only rank 0 logs and saves (every rank
        gathers the whole weights first under a model axis), and every
        rank stops once `stop_fn` is True on any (module docstring)."""
        return super().fit(state, train_ds, test_ds, generator, epochs,
                           self._on_rank0(log_fn, False) or (lambda *a: None),
                           self._on_rank0(checkpoint_fn, True),
                           self._on_rank0(save_last_fn, True),
                           self._agreed(stop_fn))

    def _agreed(self, stop_fn):
        """stop_fn as the mesh's ranks agree on it: True on every rank
        once it is True on any."""
        if stop_fn is None or self.mesh is None:
            return stop_fn
        return lambda: self.mesh.any(bool(stop_fn()), self.device)
