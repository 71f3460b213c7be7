"""Curriculum trainer, the port of plr2_tpu/train/trainer.py (the
reference's tools/train.py semantics):

  * Adam on PoseNet with per-sample gradient accumulation: one optimizer
    step every `batch_size` samples, the window's gradients SUMMED (the
    reference's repeated loss.backward(); here `.grad` accumulates over
    `TrainStep.accumulate` calls)
  * when the best test distance < decay_margin: lr *= lr_rate, w *= w_rate
    (once)
  * when the best test distance < refine_margin: the optimizer moves to
    PoseRefineNet, the window shrinks by the refine iterations, and the
    refiner trains on the chained per-iteration ADD(-S) distances
    (PoseNet frozen in eval mode)
  * a per-epoch test loop drives the schedule and best-checkpoint saving.

Adam's state lives in `TrainState.optimizer` and persists across epochs;
`update_curriculum` and `CheckpointManager.restore_into` rebuild it, as
the JAX package re-inits its `opt_state`. BatchNorm runs in train mode at
batch 1 with flax's running-average update. A window cut short by the end
of the epoch drops its gradients and keeps its BatchNorm updates; one cut
short by `stop_fn` drops both (the running buffers return to their
values at the window's start).

Randomness comes from `torch.Generator`s seeded from
`TrainConfig.seed`: `fit` hands each epoch a train and a test generator
drawn from its root generator, and an epoch splits its generator into one
for the data (`preprocess.Draws`) and one for the dropout masks, so the
per-sample and fused trainers see the same samples and masks.

Each sample carries its object id on the host (`Sample.obj`), so the
loss picks its ADD-S branch without reading the device: a per-sample step
runs ADD or ADD-S alone, as JAX's `lax.switch` does at batch 1.

`workers > 0` feeds the epochs from the native data plane in that many
threads (`data/prefetch.py`; real-data decode overlaps the device), as
JAX's trainer does, but without its quiet fallback to the inline path: a
native library that does not build stops the run with the compiler's
output. Unsupported settings raise NotImplementedError: `data_parallel >
1` and `model_parallel > 1` (the mesh, ROADMAP A7). `sym_slots` sizes
`BatchTrainer`'s ADD-S compaction, as in JAX.

`FusedTrainer` and `BatchTrainer` run their gradient programs as CUDA
graphs on the card (`train/graphs.py`, their `graphs` argument); the
graphs are dropped at a curriculum switch and at the start of `fit`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from plr2_tpu_torch.config import PipelineConfig
from plr2_tpu_torch.data.bbox import BORDER_LIST
from plr2_tpu_torch.data.loader import iterate_samples, stack_samples
from plr2_tpu_torch.data.prefetch import iterate_prefetch_samples
from plr2_tpu_torch.data.preprocess import Sample
from plr2_tpu_torch.losses.add_loss import pose_loss
from plr2_tpu_torch.losses.refine_loss import refine_loss
from plr2_tpu_torch.models.resnet import batchnorm_buffers
from plr2_tpu_torch.parallel.data_parallel import (BATCH_KEYS, TrainStep, adam,
                                                   count_symmetric)
from plr2_tpu_torch.pipeline import DenseFusionPipeline, full_f32


def snap_canvas(max_dim: int) -> int:
    """Smallest border-list size holding every crop of a batch."""
    for b in BORDER_LIST:
        if b >= max_dim:
            return b
    return max_dim


def child_generator(parent: torch.Generator) -> torch.Generator:
    """A CPU generator seeded by one draw of `parent`."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=parent))
    return torch.Generator().manual_seed(seed)


def sample_batch(s: Sample) -> Dict:
    """One sample as a batch of 1 (with its host object id, where known)."""
    b = {k: getattr(s, k)[None] for k in BATCH_KEYS}
    if s.obj is not None:
        b["obj"] = (s.obj,)
    return b


def require_supported(config: PipelineConfig) -> None:
    """Raise NotImplementedError for settings this port does not run."""
    if config.data_parallel > 1 or config.model_parallel > 1:
        raise NotImplementedError(
            "data_parallel / model_parallel > 1 (the mesh trainers) are not "
            "ported: ROADMAP A7")


@dataclasses.dataclass
class TrainState:
    pipe: DenseFusionPipeline   # its networks hold the weights and BN stats
    optimizer: torch.optim.Optimizer  # Adam over the current stage's network
    lr: float
    w: float
    decay_started: bool = False
    refine_started: bool = False
    best_test: float = float("inf")
    epoch: int = 0


class Trainer:
    def __init__(self, config: PipelineConfig,
                 pipe: Optional[DenseFusionPipeline] = None, device="cuda"):
        """Builds the pipeline (seeded from `TrainConfig.seed`, on `device`;
        `ModelConfig.dtype = "bfloat16"` is mixed precision) unless `pipe`
        is given."""
        require_supported(config)
        self.cfg = config
        dtype = (torch.bfloat16 if config.model.dtype in ("bfloat16", "bf16")
                 else torch.float32)
        self.pipe = pipe or DenseFusionPipeline(
            config.model.num_points, config.model.num_objects,
            config.model.emb_dim, device=device, seed=config.train.seed,
            dtype=dtype)
        self.device = self.pipe.device
        self.sym_list = tuple(config.dataset.sym_list)
        # preemption hook (fit(stop_fn=...)), checked at sample / batch
        # boundaries (utils/interrupt.py)
        self._stop_fn = None
        # the CUDA graphs of FusedTrainer / BatchTrainer (GradientGraphs)
        self.graphs = None

    def drop_graphs(self) -> None:
        """Release the captured gradient programs (a curriculum switch, a
        resume)."""
        if self.graphs is not None:
            self.graphs.clear()

    # ---------- state ----------

    def init_state(self) -> TrainState:
        cfg = self.cfg.train
        return TrainState(pipe=self.pipe,
                          optimizer=adam(self.pipe.posenet, cfg.lr),
                          lr=cfg.lr, w=cfg.w)

    def _iterations(self, state: TrainState) -> int:
        return self.cfg.train.refine_iterations if state.refine_started else 0

    def _accum(self, state: TrainState) -> int:
        cfg = self.cfg.train
        return max(1, cfg.batch_size // (cfg.refine_iterations
                                         if state.refine_started else 1))

    def stage_step(self, state: TrainState) -> TrainStep:
        """The current stage's step over the state's optimizer."""
        return TrainStep(self.pipe, self.sym_list, state.w,
                         refine_iterations=self._iterations(state),
                         optimizer=state.optimizer)

    def bn_snapshot(self) -> List[torch.Tensor]:
        return [b.clone() for b in batchnorm_buffers(self.pipe.posenet)]

    def bn_restore(self, snapshot: List[torch.Tensor]) -> None:
        with torch.no_grad():
            for b, s in zip(batchnorm_buffers(self.pipe.posenet), snapshot):
                b.copy_(s)

    # ---------- evaluation ----------

    @torch.no_grad()
    def eval_dis(self, batch: Mapping, refine_iterations: int = 0) -> torch.Tensor:
        """Test-loop distance per sample (B,): eval-mode BN, the best
        hypothesis, then `refine_iterations` refiner steps."""
        pipe = self.pipe
        pipe.posenet.eval()
        pipe.refiner.eval()
        b = {k: torch.as_tensor(batch[k]).to(self.device) for k in BATCH_KEYS}
        kern = pipe.posenet.use_kernels
        n_sym = count_symmetric(batch, self.sym_list)
        with full_f32(pipe.dtype == torch.float32):
            pred_r, pred_t, pred_c, emb = pipe.run_posenet(
                b["img"], b["points"], b["choose"], b["idx"])
            # before the refine stage symmetric objects score ADD-S here (the
            # reference test loop's refine_start flag); this eager loop
            # matches exactly its symmetric samples (`compact` at n_sym
            # slots: `mixed`'s distances), whatever the step's `sym_slots`
            out = pose_loss(pred_r, pred_t, pred_c, b["target"],
                            b["model_points"], b["idx"], b["points"], w=0.0,
                            refine=refine_iterations > 0,
                            sym_list=self.sym_list, use_kernels=kern,
                            max_sym_slots=n_sym, n_sym=n_sym)
            dis, new_points, new_target = out.dis, out.new_points, out.new_target
            for _ in range(refine_iterations):
                dr, dt = pipe.run_refiner(new_points, emb, b["idx"])
                ro = refine_loss(dr, dt, new_target, b["model_points"],
                                 b["idx"], new_points, sym_list=self.sym_list,
                                 use_kernels=kern)
                dis, new_points, new_target = ro.dis, ro.new_points, ro.new_target
        return dis

    # ---------- epoch loops ----------

    def _sample_iter(self, dataset, generator: torch.Generator,
                     add_noise: bool, shuffle: bool, seed: int):
        """The per-sample iterator (a method, so a caller may feed other
        samples). With `TrainConfig.workers == 0`, `iterate_samples`:
        preprocessing on the pipeline's device, the choose sampling there
        too. With `workers > 0`, `iterate_prefetch_samples`: that many
        threads decode and run the native data plane (its own choose
        stream), the augmentation runs on the pipeline's device; if the
        native library cannot be built, the first sample raises (there is
        no quiet fallback to the inline path). Both draw the translation
        noise at `DatasetConfig.noise_trans`."""
        kw = dict(add_noise=add_noise, noise_trans=self.cfg.dataset.noise_trans,
                  shuffle=shuffle, seed=seed, device=self.device)
        workers = self.cfg.train.workers
        if workers > 0:
            return iterate_prefetch_samples(dataset, generator,
                                            self.cfg.model.num_points,
                                            num_workers=workers, **kw)
        return iterate_samples(dataset, generator, self.cfg.model.num_points,
                               **kw)

    @staticmethod
    def _epoch_info(losses, dists, t0: float, interrupted: bool) -> Dict:
        def mean(v):
            return float(torch.stack(v).float().mean()) if v else 0.0
        return {"train_loss": mean(losses), "train_dis": mean(dists),
                "seconds": time.time() - t0, "interrupted": interrupted,
                "losses": [float(v) for v in losses],
                "dists": [float(v) for v in dists]}

    def train_epoch(self, state: TrainState, dataset,
                    generator: torch.Generator) -> Tuple[TrainState, Dict]:
        cfg = self.cfg.train
        accum = self._accum(state)
        step = self.stage_step(state)
        g_data, g_drop = child_generator(generator), child_generator(generator)
        step.optimizer.zero_grad(set_to_none=True)
        # BN statistics at the window's start: an interrupt discards the
        # partial window's gradients AND its BN updates (its samples replay
        # on resume)
        bn_start = self.bn_snapshot()
        losses, dists = [], []
        count, interrupted = 0, False
        t0 = time.time()
        for rep in range(cfg.repeat_epoch):
            if interrupted:
                break
            for s in self._sample_iter(dataset, g_data,
                                       add_noise=self.cfg.dataset.add_noise,
                                       shuffle=True,
                                       seed=state.epoch * 997 + rep):
                if self._stop_fn is not None and self._stop_fn():
                    if count:
                        self.bn_restore(bn_start)
                    interrupted = True
                    break
                loss, dis = step.accumulate(sample_batch(s), g_drop)
                losses.append(loss)
                dists.append(dis)
                count += 1
                if count >= accum:
                    step.apply()
                    count = 0
                    bn_start = self.bn_snapshot()
        # a partial window's gradients are dropped (its BN updates stay)
        step.optimizer.zero_grad(set_to_none=True)
        return state, self._epoch_info(losses, dists, t0, interrupted)

    def test_epoch(self, state: TrainState, dataset,
                   generator: torch.Generator) -> float:
        if self.cfg.train.batched_test:
            return self._test_epoch_batched(state, dataset, generator)
        dists = [self.eval_dis(sample_batch(s), self._iterations(state)).mean()
                 for s in self._sample_iter(dataset, generator, add_noise=False,
                                            shuffle=False, seed=0)]
        return float(torch.stack(dists).mean()) if dists else float("inf")

    def _stack_eval(self, samples: List[Sample]) -> Dict[str, torch.Tensor]:
        """Samples on a shared border-list-snapped canvas (the batched
        modes' spatial contract), at least `DatasetConfig.crop_size`."""
        canvas = snap_canvas(max(max(s.img.shape[0], s.img.shape[1])
                                 for s in samples))
        b = stack_samples(samples, crop=max(canvas, self.cfg.dataset.crop_size))
        out = {k: getattr(b, k) for k in BATCH_KEYS}
        if b.obj is not None:  # the host object ids (the loss's branch)
            out["obj"] = b.obj
        return out

    def _test_epoch_batched(self, state: TrainState, dataset,
                            generator: torch.Generator) -> float:
        """One `eval_dis` call per `batch_size` samples on a shared canvas;
        the tail batch is cycle-padded and only its real samples score.
        Mean of the per-sample distances, as the per-sample loop."""
        bsz = self.cfg.train.batch_size
        dists, pending = [], []

        def flush():
            if pending:
                n = len(pending)
                d = self._stack_eval([pending[i % n] for i in range(bsz)])
                dists.append(self.eval_dis(d, self._iterations(state))[:n])
                pending.clear()

        for s in self._sample_iter(dataset, generator, add_noise=False,
                                   shuffle=False, seed=0):
            pending.append(s)
            if len(pending) == bsz:
                flush()
        flush()
        return float(torch.cat(dists).mean()) if dists else float("inf")

    def update_curriculum(self, state: TrainState, test_dis: float) -> TrainState:
        """The schedule's decay and refine switches (reference flags); each
        switch rebuilds Adam for the stage's network."""
        cfg = self.cfg.train
        if test_dis < state.best_test:
            state.best_test = test_dis
        if state.best_test < cfg.decay_margin and not state.decay_started:
            state.decay_started = True
            state.lr *= cfg.lr_rate
            state.w *= cfg.w_rate
            net = self.pipe.refiner if state.refine_started else self.pipe.posenet
            state.optimizer = adam(net, state.lr)
            self.drop_graphs()
        if state.best_test < cfg.refine_margin and not state.refine_started:
            state.refine_started = True
            state.optimizer = adam(self.pipe.refiner, state.lr)
            self.drop_graphs()
        return state

    @staticmethod
    def _sync_refine_meshes(state: TrainState, *datasets) -> None:
        """Once the refine stage starts, datasets with the upstream mesh
        switch (YCB's set_refine: 500 -> 2600 model points) score against
        the large mesh. The synthetic datasets have none."""
        for ds in datasets:
            if hasattr(ds, "set_refine"):
                ds.set_refine(state.refine_started)

    def fit(self, state: TrainState, train_ds, test_ds,
            generator: Optional[torch.Generator] = None,
            epochs: Optional[int] = None, log_fn=print, checkpoint_fn=None,
            save_last_fn=None, stop_fn=None) -> TrainState:
        """Epoch loop. `checkpoint_fn(state, test_dis)` fires when the test
        distance improves; `save_last_fn(state)` every epoch. When
        `stop_fn()` reports True the epoch is abandoned at the next sample
        or batch boundary with no partial optimizer step, the epoch counter
        goes back, `last` is saved and fit returns (a resume replays the
        epoch). `generator` defaults to one seeded by TrainConfig.seed + 1."""
        epochs = epochs or self.cfg.train.nepoch
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.train.seed + 1)
        self._stop_fn = stop_fn
        self.drop_graphs()  # the state may come from a checkpoint
        try:
            self._sync_refine_meshes(state, train_ds, test_ds)  # resume case
            for _ in range(epochs):
                state.epoch += 1
                g_train = child_generator(generator)
                g_test = child_generator(generator)
                state, info = self.train_epoch(state, train_ds, g_train)
                if info["interrupted"]:
                    state.epoch -= 1
                    if save_last_fn is not None:
                        save_last_fn(state)
                    log_fn(f"interrupt requested: stopped during epoch "
                           f"{state.epoch + 1}; state saved at epoch "
                           f"{state.epoch} (resume replays the epoch)")
                    return state
                test_dis = self.test_epoch(state, test_ds, g_test)
                improved = test_dis < state.best_test
                state = self.update_curriculum(state, test_dis)
                self._sync_refine_meshes(state, train_ds, test_ds)
                log_fn(f"epoch {state.epoch}: loss={info['train_loss']:.5f} "
                       f"train_dis={info['train_dis']:.5f} test_dis={test_dis:.5f} "
                       f"best={state.best_test:.5f} lr={state.lr:g} w={state.w:g} "
                       f"refine={state.refine_started} ({info['seconds']:.1f}s)")
                if improved and checkpoint_fn is not None:
                    checkpoint_fn(state, test_dis)
                if save_last_fn is not None:
                    save_last_fn(state)
                if stop_fn is not None and stop_fn():
                    log_fn(f"interrupt requested: stopped cleanly after epoch "
                           f"{state.epoch}")
                    return state
            return state
        finally:
            self._stop_fn = None
