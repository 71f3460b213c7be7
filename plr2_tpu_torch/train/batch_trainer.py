"""BatchTrainer on one device, the port of plr2_tpu/train/batch_trainer.py
with `mesh=None` (the mesh-sharded and tensor-parallel modes wait for
ROADMAP A7 and raise in `Trainer.__init__`).

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
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

from plr2_tpu_torch.parallel.data_parallel import TrainStep
from plr2_tpu_torch.train.graphs import GradientGraphs
from plr2_tpu_torch.train.trainer import Trainer, TrainState, child_generator


class BatchTrainer(Trainer):
    """Trainer with batched optimizer steps, each a CUDA graph on the card
    unless `graphs=False`."""

    def __init__(self, config, pipe=None, device="cuda", graphs: bool = True):
        super().__init__(config, pipe, device)
        if graphs and self.device.type == "cuda":
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
        if self.graphs is None:
            return step(batch, generator)
        loss, dis = self.graphs.gradients(step, batch, generator)
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
