"""The fused-window training driver: `train/fused_accum.
make_fused_accum_step`, one graphed program a window of `window` batch-1
samples whose gradients are summed, then Adam (upstream's recipe:
`batch_size` 8 accumulated one sample at a time), stage 1, on a pool of
`pool_windows` windows made in set-up on the device and cycled.

Traffic parameters: `window`, `canvas`, `pool_windows`,
`objects_per_frame`, `object_span_m`, `min_sample_pixels`,
`trace_seconds`. End-to-end: `window_samples_per_s`, the samples of
every window completed in the run's window over its wall time (a metric
of its own: this cell's spread is several times the batched cell's).
Set-up, window and judge: `benchmark/trainloop.py`.
"""

from __future__ import annotations

from benchmark import trainloop
from benchmark.gen.frames import stack, train_pool


def setup(r):
    """(pool, the window's call, the trained network, its optimizer): no
    reference to the program outlives these, so `trainloop` can free it
    before the reference runs."""
    from plr2_tpu_torch.train.fused_accum import make_fused_accum_step

    cfg, tr = r.config, r.traffic
    pipe = trainloop.pipeline(r)
    step = make_fused_accum_step(pipe, tuple(cfg["symmetric"]), cfg["w"],
                                 lr=cfg["lr"])
    n = tr["window"]
    samples = train_pool(cfg, tr, r.seed, n * tr["pool_windows"])
    pool = [trainloop.to_device(stack(samples[i:i + n]), r.device)
            for i in range(0, len(samples), n)]
    gen = trainloop.drop_generator(r.seed)

    def step_fn(window):
        return step(window, gen)["loss"]

    return pool, step_fn, pipe.posenet, step.optimizer


def run(r):
    n = r.traffic["window"]
    return trainloop.run_training(r, *setup(r), samples_per_step=n,
                                  window=True, forward_batch=1,
                                  forwards_per_step=n,
                                  rate="window_samples_per_s")


def control(r, prec_name: str):
    """The control on this cell's first batches (`trainloop.control`)."""
    tr = r.traffic
    n = tr["window"]
    samples = train_pool(r.config, tr, r.seed, n * trainloop.CHECKED_STEPS)
    pool = [trainloop.to_device(stack(samples[i:i + n]), r.device)
            for i in range(0, len(samples), n)]
    return trainloop.control(r, pool, True, prec_name)
