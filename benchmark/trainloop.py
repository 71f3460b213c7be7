"""What the two training drivers share: the set-up of one training object
driven from the seed through its first steps, the window, and the judge.

Set-up builds the program's training step once (the pipeline with the
seed's weights, its Adam, its dropout generator) and drives it through
every batch of the pool with the window's own call: step 1 is snapshot
(the first gradient, as Adam's first moment / 0.1), steps 1-3 give their
losses, and the parameters after step 3 give each leaf's change. Every
graph the pool needs is captured by then. The window hands the same
object on and cycles the pool. After the window the program is freed
and the reference (`reference/train.py`) follows the first three steps
from the same weights, batches and dropout draws.

Numbers (each against its limit in `workloads/<cell>.json`):
- `loss_gap`: the worst relative gap of a step's loss (every sample's
  for a window);
- `grad_gap`: the worst leaf's gap between the first gradient's norms
  (`reference.train.leaf_gaps`);
- `change_gap`: the same for the parameters' change over three steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (a leaf with none moves by round-off under Adam).
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from benchmark import counts
from benchmark.gen.weights import make_weights
from benchmark.reference import train as ref
from benchmark.reference.model import posenet_shapes
from benchmark.reference.precision import tf32_flags
from benchmark.run import Outcome

CHECKED_STEPS = 3
BETA1 = 0.9


def to_device(batch: Dict, device) -> Dict:
    out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()
           if k != "obj"}
    out["obj"] = batch["obj"]
    return out


def pipeline(r):
    from plr2_tpu_torch.pipeline import DenseFusionPipeline

    cfg = r.config
    pipe = DenseFusionPipeline(cfg["num_points"], cfg["num_objects"],
                               cfg["emb_dim"], device=r.device, seed=None)
    w = make_weights(cfg["num_objects"], cfg["emb_dim"], r.seed, r.device)
    pipe.posenet.load_state_dict(w["posenet"], strict=True)
    pipe.refiner.load_state_dict(w["refiner"], strict=True)
    return pipe


def drop_generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed) + 1)


def run_training(r, pool: List[Dict], step_fn: Callable, network,
                 optimizer, samples_per_step: int, window: bool,
                 forward_batch: int, forwards_per_step: int,
                 rate: str) -> Outcome:
    """Set-up steps, the window and the judge (module docstring).
    `step_fn(batch) -> losses` is the window's own call; `rate` names the
    cell's samples/s metric."""
    cfg, tr, wl = r.config, r.traffic, r.workload
    t_steps = time.perf_counter()
    names = [n for n, _ in network.named_parameters()]
    params = [p for _, p in network.named_parameters()]
    p0 = [p.detach().clone() for p in params]
    prog_losses, grad_norm, change_norm = [], {}, {}
    for s, batch in enumerate(pool, start=1):  # every graph key, in order
        with torch.profiler.record_function("bench.step"):
            losses = step_fn(batch)
        if s <= CHECKED_STEPS:
            prog_losses.append([float(x) for x in torch.atleast_1d(losses)])
        if s == 1:
            for n, p in zip(names, params):
                m = optimizer.state[p].get("exp_avg")  # None: never stepped
                grad_norm[n] = 0.0 if m is None else float(
                    (m / (1 - BETA1)).norm())
        if s == CHECKED_STEPS:
            for n, p, a in zip(names, params, p0):
                change_norm[n] = float((p.detach() - a).norm())
    del p0
    sync = (lambda: torch.cuda.synchronize(r.device)) \
        if r.device.type == "cuda" else (lambda: None)
    sync()
    trace = None
    t_first = time.perf_counter()
    print(f"info: set-up imports, program and samples "
          f"{t_steps - r.t_start:.2f} s, {len(pool)} steps and their "
          f"graphs {t_first - t_steps:.2f} s", file=sys.stderr)

    def loop(seconds):
        n, i = 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with torch.profiler.record_function("bench.step"):
                step_fn(pool[i])
            i = (i + 1) % len(pool)
            n += 1
        sync()
        return n, time.perf_counter() - t0

    if r.trace:
        from benchmark.trace import traced
        got = {}
        with traced(got):
            n, wall = loop(min(r.seconds, tr["trace_seconds"]))
        trace = got["trace"]
        wall = trace.window_s
    else:
        n, wall = loop(r.seconds)
    setup_s = t_first - r.t_start
    peak = (torch.cuda.max_memory_allocated(r.device)
            if r.device.type == "cuda" else 0)
    fwd = counts.posenet_flops(tr["canvas"], cfg["num_points"],
                               cfg["num_objects"])
    kernel = counts.forward_kernel_work(forward_batch, tr["canvas"],
                                        cfg["num_points"], cfg["num_objects"],
                                        "float32")
    cnt = dict(dtype="float32", window_s=wall,
               model_flops=3 * fwd * n * samples_per_step,
               kernel_bound_s={k: n * forwards_per_step * v
                               for k, v in kernel.items()})
    del step_fn, network, optimizer, params
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
        print(f"info: held after the program was freed "
              f"{torch.cuda.memory_allocated(r.device)} bytes (the pool)",
              file=sys.stderr)
    numbers = judge(r, pool[:CHECKED_STEPS], window, prog_losses, grad_norm,
                    change_norm)
    checks = {k: (numbers[k], wl["limits"][k])
              for k in ("loss_gap", "grad_gap", "change_gap")}
    e2e = {rate: n * samples_per_step / wall, "setup_s": setup_s}
    return Outcome(e2e, cnt, trace, checks, attempted=n, failed=0,
                   memory_peak_bytes=peak)


def reference_run(r, batches, window: bool, prec_name: str = "float32"):
    """The reference's first steps: (losses, first-gradient norms,
    change norms) by leaf name."""
    from benchmark.reference.precision import precision

    cfg = r.config
    state = make_weights(cfg["num_objects"], cfg["emb_dim"], r.seed,
                         r.device)["posenet"]
    names = ref.trainable(posenet_shapes(cfg["num_objects"], cfg["emb_dim"]))
    gen = drop_generator(r.seed)
    masks = []
    for b in batches:
        size = b["idx"].shape[0]
        if window:  # sample by sample, as a window's per-sample steps draw
            each = [ref.dropout_masks(gen, 1) for _ in range(size)]
            masks.append([torch.cat(x).to(r.device) for x in zip(*each)])
        else:
            masks.append([x.to(r.device) for x in ref.dropout_masks(gen, size)])
    with tf32_flags(prec_name):
        losses, first, final = ref.train(
            state, names, batches, masks, cfg["num_objects"], cfg["w"],
            cfg["lr"], cfg["symmetric"], window, precision(prec_name))
    grad = {n: float(first[n].norm()) for n in names}
    change = {n: float((final[n] - state[n]).norm()) for n in names}
    return losses, grad, change


def judge(r, batches, window, prog_losses, grad_norm, change_norm):
    """The three numbers of the program's first steps against the
    reference's."""
    losses, grad, change = reference_run(r, batches, window)
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for pa, pb in zip(prog_losses, losses)
                   for a, b in zip(pa, pb))
    med = float(np.median(list(grad.values())))
    skip = {n for n, v in grad.items() if v < 1e-3 * med}
    return dict(loss_gap=loss_gap, grad_gap=ref.leaf_gaps(grad_norm, grad),
                change_gap=ref.leaf_gaps(change_norm, change, skip))


def control(r, pool: List[Dict], window: bool, prec_name: str):
    """The control: the reference's first steps computed in `prec_name`,
    judged against the float32 reference's as the program's are."""
    losses, grad, change = reference_run(r, pool[:CHECKED_STEPS], window,
                                         prec_name)
    return judge(r, pool[:CHECKED_STEPS], window, losses, grad, change)
