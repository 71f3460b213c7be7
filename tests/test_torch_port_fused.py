"""The port's fused accumulation window: equal to N per-sample steps of the
port's Trainer on the same stacked samples (bit for bit: both run the same
per-sample code in the same order), held to JAX's
`make_fused_window_grads` on the same window, and FusedTrainer's epoch,
whose tail window takes no optimizer step."""

import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import pytest
import torch

from plr2_tpu.pipeline import DenseFusionPipeline as JPipeline
from plr2_tpu.train.fused_accum import make_fused_window_grads as j_window_grads
from plr2_tpu_torch.models import posenet_state_dict
from plr2_tpu_torch.parallel.data_parallel import BATCH_KEYS, TrainStep
from plr2_tpu_torch.train import (FusedTrainer, Trainer, make_fused_accum_step,
                                  make_fused_window_grads)
from test_torch_port_trainer import (LR, N, NUM_OBJ, SYM, TRAIN_SEED, W,
                                     configs, jax_variables, no_dropout,
                                     port_pipe, samples)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def window():
    """The four training samples of test_torch_port_trainer.py stacked on
    their shared 120 px canvas, in both packages' forms."""
    jpipe, variables = jax_variables()
    js, ts = samples(TRAIN_SEED, 5)
    _, tcfg = configs()
    tr = Trainer(tcfg, pipe=port_pipe(variables))
    win = tr._stack_eval(ts)
    return jpipe, variables, tr, win


def _grads(net):
    return {n: p.grad.clone() for n, p in net.named_parameters()}


def test_fused_window_equals_per_sample_steps_bit_for_bit(window):
    """The window (its samples in order, one dropout generator) against a
    per-sample loop of the Trainer's own step on the same stacked samples,
    with dropout ON: summed gradients, per-sample loss and dis, and the BN
    statistics are bit-equal (not only within 1e-6 relative)."""
    _, variables, tr, win = window
    runs = []
    for fused in (True, False):
        pipe = port_pipe(variables)
        pipe.posenet.cnn.model.dropout_rates = (0.3, 0.15, 0.15)
        gen = torch.Generator().manual_seed(7)
        if fused:
            grads_fn = make_fused_window_grads(pipe, SYM, W)
            losses, dists = grads_fn(win, gen)
        else:
            tr2 = Trainer(tr.cfg, pipe=pipe)
            step = tr2.stage_step(tr2.init_state())
            out = [step.accumulate({k: win[k][i:i + 1] for k in BATCH_KEYS}, gen)
                   for i in range(len(win["idx"]))]
            losses = torch.stack([o[0] for o in out])
            dists = torch.stack([o[1] for o in out])
        runs.append((_grads(pipe.posenet), losses, dists,
                     {k: v.clone() for k, v in pipe.posenet.state_dict().items()
                      if "running" in k}))
    (gf, lf, df, bf), (gs, ls, ds, bs) = runs
    assert torch.equal(lf, ls) and torch.equal(df, ds)
    for n in gf:
        assert torch.equal(gf[n], gs[n]), n
    for n in bf:
        assert torch.equal(bf[n], bs[n]), n


def test_fused_window_matches_jax_window_grads_in_float64(window):
    """The port's window against JAX's `make_fused_window_grads` (one
    `lax.scan` over the window) from the same weights and window, dropout
    off, a window of the first two samples, both networks in float64 (the
    losses' metric math stays f32 on both sides, as both packages cast
    it): per-sample loss and dis within 1e-4 relative, BN statistics within
    1e-9 relative, and the summed gradients within 1e-4 in relative L2,
    each tensor and all of PoseNet (measured 2.5e-7 and 1.0e-8).
    In f32 that bound does not hold for reasons outside the window: the
    colour encoder's gradients are ill-conditioned (`_grad_tol`), and a
    ReLU unit whose pre-activation is within f32 noise of 0 (this window's
    first head layers hold ones of 4.4e-7 and 1.7e-6, at a median of 0.67)
    opens on one side only; measured in f32, the whole gradient differs by
    7.2e-4 in relative L2. The f32 window equals the per-sample Trainer bit
    for bit (above), which test_torch_port_trainer.py holds to JAX's
    Trainer in f32."""
    _, variables, _, win = window
    win = {k: v[:2] for k, v in win.items()}  # a window of two (f64 is slow)
    with jax.enable_x64(True):
        jpipe = JPipeline(num_points=N, num_objects=NUM_OBJ, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        jwin = {k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64
                               else v.numpy().astype(np.float64))
                for k, v in win.items()}
        fn = j_window_grads(jpipe, SYM, W, 0)
        with fnn.intercept_methods(no_dropout):
            jg, jbs, jl, jd = jax.jit(fn)(v64, jwin,
                                           jax.random.split(jax.random.key(0), 2))
        want = posenet_state_dict(jax.device_get({"params": jg,
                                                  "batch_stats": jbs}))
    win64 = {k: v.double() if v.is_floating_point() else v for k, v in win.items()}
    for form in ("loop", "program"):
        pipe = port_pipe(variables).cast(torch.float64)
        if form == "loop":
            losses, dists = make_fused_window_grads(pipe, SYM, W)(win64, None)
        else:
            step = TrainStep(pipe, SYM, W)
            losses, dists = step.program(step.inputs(win64, None, window=True),
                                         window=True)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-4)
        np.testing.assert_allclose(dists.numpy(), np.asarray(jd), rtol=1e-4)
        got = _grads(pipe.posenet)
        num = den = 0.0
        for n, g in got.items():
            ref = want[n].double()
            err = float((g - ref).norm() / ref.norm().clamp(min=1e-300))
            assert err <= 1e-4, (form, n, err)
            num += float((g - ref).pow(2).sum())
            den += float(ref.pow(2).sum())
        assert (num / den) ** 0.5 <= 1e-4, form
        state = pipe.posenet.state_dict()
        for n, ref in want.items():
            if "running" in n:
                np.testing.assert_allclose(state[n].numpy(), ref.numpy(),
                                           rtol=1e-9, atol=1e-12,
                                           err_msg=f"{form} {n}")


def test_fused_accum_step_takes_one_adam_step(window):
    _, variables, tr, win = window
    pipe = port_pipe(variables)
    before = {n: p.detach().clone() for n, p in pipe.posenet.named_parameters()}
    step = make_fused_accum_step(pipe, SYM, W, lr=LR)
    m = step(win, None)
    assert m["loss"].shape == (4,) and m["dis"].shape == (4,)
    st = step.optimizer.state
    assert {int(st[p]["step"]) for p in pipe.posenet.parameters()} == {1}
    assert all(p.grad is None for p in pipe.posenet.parameters())
    assert any(not torch.equal(p, before[n])
               for n, p in pipe.posenet.named_parameters())


def test_fused_trainer_epoch_withholds_the_tail_step(window):
    """Five samples, window 2: two fused windows (two Adam steps), then the
    fifth sample per-sample with no step: its BN update is kept, its
    gradients dropped."""
    _, variables, tr, _ = window
    _, ts = samples(TRAIN_SEED, 5)
    ts = ts + ts[:1]  # five samples
    _, tcfg = configs()
    ftr = FusedTrainer(tcfg, pipe=port_pipe(variables))
    ftr._sample_iter = lambda *a, **k: iter(ts[:5])
    state = ftr.init_state()
    state, info = ftr.train_epoch(state, None, torch.Generator().manual_seed(0))
    assert len(info["losses"]) == 5 and not info["interrupted"]
    opt = state.optimizer.state
    assert {int(opt[p]["step"]) for p in ftr.pipe.posenet.parameters()} == {2}
    assert all(p.grad is None for p in ftr.pipe.posenet.parameters())
    tracked = {int(v) for k, v in ftr.pipe.posenet.state_dict().items()
               if k.endswith("num_batches_tracked")}
    assert tracked == {5}
