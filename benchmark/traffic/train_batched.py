"""The batched training driver: the step that `BatchTrainer` runs for each
batch (its graphed gradient program over `stage_step(state)`, then its
Adam step), stage 1, on a pool of `pool_batches` batches of `batch`
samples made in set-up on the device and cycled, so no host data path
runs in the window.

Traffic parameters: `batch`, `canvas`, `pool_batches`,
`objects_per_frame`, `object_span_m`, `min_sample_pixels` (the samples:
`gen/frames.py`), `trace_seconds`. End-to-end: `train_samples_per_s`,
the samples of every step completed in the window over its wall time
(the window ends in a synchronise). Set-up, window and judge:
`benchmark/trainloop.py`.
"""

from __future__ import annotations

from benchmark import trainloop
from benchmark.gen.frames import stack, train_pool


def build(r):
    """BatchTrainer over the seed's weights, its state and stage-1 step:
    (trainer, step)."""
    from plr2_tpu_torch.config import (DatasetConfig, ModelConfig,
                                       PipelineConfig, TrainConfig)
    from plr2_tpu_torch.train.batch_trainer import BatchTrainer

    cfg, tr = r.config, r.traffic
    config = PipelineConfig(
        dataset=DatasetConfig(num_points=cfg["num_points"],
                              num_objects=cfg["num_objects"],
                              num_mesh_points=cfg["mesh_points"],
                              sym_list=tuple(cfg["symmetric"]),
                              crop_size=tr["canvas"]),
        model=ModelConfig(num_points=cfg["num_points"],
                          num_objects=cfg["num_objects"],
                          emb_dim=cfg["emb_dim"]),
        train=TrainConfig(batch_size=tr["batch"], lr=cfg["lr"], w=cfg["w"],
                          sym_slots=-1))
    trainer = BatchTrainer(config, pipe=trainloop.pipeline(r))
    state = trainer.init_state()
    return trainer, state, trainer.stage_step(state)


def setup(r):
    """(pool, the window's call, the trained network, its optimizer): no
    reference to the program outlives these, so `trainloop` can free it
    before the reference runs."""
    tr = r.traffic
    trainer, state, step = build(r)
    samples = train_pool(r.config, tr, r.seed, tr["batch"] * tr["pool_batches"])
    b = tr["batch"]
    pool = [trainloop.to_device(stack(samples[i:i + b]), r.device)
            for i in range(0, len(samples), b)]
    gen = trainloop.drop_generator(r.seed)

    def step_fn(batch):
        return trainer._step(step, batch, gen)["loss"]

    return pool, step_fn, step.network, state.optimizer


def run(r):
    b = r.traffic["batch"]
    return trainloop.run_training(r, *setup(r), samples_per_step=b,
                                  window=False, forward_batch=b,
                                  forwards_per_step=1,
                                  rate="train_samples_per_s")


def control(r, prec_name: str):
    """The control on this cell's first batches (`trainloop.control`)."""
    tr = r.traffic
    n = tr["batch"]
    samples = train_pool(r.config, tr, r.seed, n * trainloop.CHECKED_STEPS)
    pool = [trainloop.to_device(stack(samples[i:i + n]), r.device)
            for i in range(0, len(samples), n)]
    return trainloop.control(r, pool, False, prec_name)
