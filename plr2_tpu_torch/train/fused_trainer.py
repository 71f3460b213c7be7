"""FusedTrainer, the port of plr2_tpu/train/fused_trainer.py: `Trainer`'s
curriculum, checkpoints, test loop and preemption contract, with
train_epoch's inner loop in accumulation windows.

Samples are collected into windows of exactly `batch_size` (or
`batch_size // refine_iterations` in the refine stage, as in `Trainer`),
stacked on a border-list-snapped canvas, and run through
`fused_accum.make_fused_accum_step`: per-sample gradients summed, batch-1
BatchNorm updated sample by sample, one optimizer step. Tail samples that
fill no window run through the per-sample path with the optimizer step
withheld (their gradients dropped, their BN updates and metrics kept),
as `Trainer` treats its leftover window. An interrupt discards the
partial window entirely: its samples have not run, so neither gradients
nor BN updates of theirs exist.
"""

from __future__ import annotations

import time

from plr2_tpu_torch.train.fused_accum import make_fused_accum_step
from plr2_tpu_torch.train.trainer import (Trainer, TrainState, child_generator,
                                          sample_batch)


class FusedTrainer(Trainer):
    """Trainer whose accumulation window runs on a shared canvas."""

    def train_epoch(self, state: TrainState, dataset, generator):
        cfg = self.cfg.train
        accum = self._accum(state)
        step = make_fused_accum_step(self.pipe, self.sym_list, state.w,
                                     refine_iterations=self._iterations(state),
                                     optimizer=state.optimizer)
        g_data, g_drop = child_generator(generator), child_generator(generator)
        pending, losses, dists = [], [], []
        interrupted = False
        t0 = time.time()
        for rep in range(cfg.repeat_epoch):
            if interrupted:
                break
            for s in self._sample_iter(dataset, g_data,
                                       add_noise=self.cfg.dataset.add_noise,
                                       shuffle=True,
                                       seed=state.epoch * 997 + rep):
                if self._stop_fn is not None and self._stop_fn():
                    interrupted = True
                    break
                pending.append(s)
                if len(pending) == accum:
                    m = step(self._stack_eval(pending), g_drop)
                    losses.extend(m["loss"])
                    dists.extend(m["dis"])
                    pending = []
        if not interrupted and pending:
            # the tail window: per-sample gradients and BN, no optimizer step
            tail = self.stage_step(state)
            for s in pending:
                loss, dis = tail.accumulate(sample_batch(s), g_drop)
                losses.append(loss)
                dists.append(dis)
            tail.network.zero_grad(set_to_none=True)
        return state, self._epoch_info(losses, dists, t0, interrupted)
