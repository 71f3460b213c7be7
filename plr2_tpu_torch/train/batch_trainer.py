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
"""

from __future__ import annotations

import time
from typing import List

from plr2_tpu_torch.train.trainer import Trainer, TrainState, child_generator


class BatchTrainer(Trainer):
    """Trainer with batched optimizer steps."""

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
                m = step(batch, g_drop)
                losses.append(m["loss"])
                dists.append(m["dis"])
        return state, self._epoch_info(losses, dists, t0, interrupted)

    def test_epoch(self, state: TrainState, dataset, generator) -> float:
        """Always batched (`Trainer._test_epoch_batched`)."""
        return self._test_epoch_batched(state, dataset, generator)
