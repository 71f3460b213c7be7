"""`make_train_step(remat=True, sym_slots=K)` of the port: rematerialising
PoseNet's forward in the backward, stage by stage, changes no gradient
(f32 and mixed precision) and updates BatchNorm's running statistics once
(the recompute leaves them alone),
against the port without remat and against JAX's `make_train_step(remat=
True)` (after tests/test_parallel.py:83); `sym_slots` reaches the loss and
changes nothing but the work; `BatchTrainer._sym_slots()` is JAX's rule
(after tests/test_parallel.py:213). The memory it saves is measured on the
card (chip_smoke.py's `train graphs` phase)."""

import dataclasses

import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import pytest
import torch

from plr2_tpu import config as j_config
from plr2_tpu.parallel.data_parallel import make_train_step as j_make_train_step
from plr2_tpu.pipeline import DenseFusionPipeline as JPipeline
from plr2_tpu.train import BatchTrainer as JBatchTrainer
from plr2_tpu_torch import DenseFusionPipeline
from plr2_tpu_torch import config as t_config
from plr2_tpu_torch.models import posenet_state_dict
from plr2_tpu_torch.models.resnet import batchnorm_buffers
from plr2_tpu_torch.parallel import make_train_step
from plr2_tpu_torch.train import BatchTrainer
from test_torch_port_pipeline import _numpy_variables

torch.set_num_threads(2)

NUM_OBJ, N, HW, M, B = 4, 32, 48, 16, 4
SYM, W, LR = (1,), 0.015, 1e-4


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    mp = rng.normal(size=(B, M, 3)) * 0.05
    b = dict(img=rng.normal(size=(B, HW, HW, 3)),
             points=rng.normal(size=(B, N, 3)) * 0.1,
             choose=rng.integers(0, HW * HW, size=(B, N)),
             target=mp + rng.normal(size=(B, 1, 3)) * 0.05, model_points=mp,
             idx=np.array([1, 0, 2, 3]))  # one ADD-S sample of four
    return {k: v.astype(np.int32 if v.dtype.kind == "i" else np.float32)
            for k, v in b.items()}


@pytest.fixture(scope="module")
def variables():
    jpipe = JPipeline(num_points=N, num_objects=NUM_OBJ)
    shapes = jax.eval_shape(lambda k: jpipe.init(k, crop_hw=HW, batch=1),
                            jax.random.key(0))
    return jpipe, _numpy_variables(np.random.default_rng(3), shapes)


def _port_step(variables, dropout, dtype=torch.float32, **kw):
    pipe = DenseFusionPipeline(N, NUM_OBJ, device="cpu", seed=None, dtype=dtype)
    pipe.load_jax_variables(variables)
    if not dropout:
        pipe.posenet.cnn.model.dropout_rates = (0.0, 0.0, 0.0)
    step = make_train_step(pipe, SYM, W, LR, **kw)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    batch["obj"] = tuple(int(i) for i in batch["idx"])
    met = step(batch, torch.Generator().manual_seed(4))
    net = pipe.posenet
    return dict(met=met, pipe=pipe, step=step,
                grads={n: step.optimizer.state[p]["exp_avg"].clone()
                       for n, p in net.named_parameters()},
                params={n: p.detach().clone() for n, p in net.named_parameters()},
                bn=[b.clone() for b in batchnorm_buffers(net)])


@pytest.mark.parametrize("dtype,kw", [
    (torch.float32, dict(remat=True)), (torch.float32, dict(sym_slots=2)),
    (torch.float32, dict(remat=True, sym_slots=2)),
    (torch.bfloat16, dict(remat=True))],
    ids=["remat", "sym_slots", "both", "remat_mixed"])
def test_remat_and_sym_slots_change_no_gradient(variables, dtype, kw):
    """Dropout on (masks drawn before the forward, so the recompute sees
    the same ones): loss, dis, Adam's moments (0.1 g), the updated
    parameters and BN statistics bit-equal to the plain step; BN's
    counters say one update per layer. Under mixed precision each stage
    is recomputed with the call's bf16 casts of the parameters."""
    _, v = variables
    plain = _port_step(v, True, dtype)
    got = _port_step(v, True, dtype, **kw)
    for k in ("loss", "dis"):
        assert torch.equal(got["met"][k], plain["met"][k]), k
    for part in ("grads", "params"):
        for n, t in plain[part].items():
            assert torch.equal(got[part][n], t), (part, n)
    for x, y in zip(got["bn"], plain["bn"]):
        assert torch.equal(x, y)
    tracked = {int(t) for n, t in got["pipe"].posenet.state_dict().items()
               if n.endswith("num_batches_tracked")}
    assert tracked == {1}


def test_remat_step_matches_jax_remat_step(variables):
    """Against JAX's step with remat=True and sym_slots=2 (the compact
    branch) from the same weights and batch, dropout off on both sides,
    both networks in float64 (in f32 these inputs' gradients are
    ill-conditioned with or without remat: tests/test_torch_port_train.py
    `_grad_error`); the losses' metric math stays f32 on both sides. Loss
    and dis 1e-5 relative; each gradient (Adam's first moment) and all of
    PoseNet's within 1e-4 in relative L2, BN statistics 1e-9 relative (the
    bounds of tests/test_torch_port_fused.py's float64 window)."""
    jpipe, v = variables

    def no_dropout(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout):
            return args[0]
        return next_fun(*args, **kwargs)
    batch = _batch()
    with jax.enable_x64(True):
        jp64 = JPipeline(num_points=N, num_objects=NUM_OBJ, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        init_fn, jstep = j_make_train_step(jp64, SYM, W, LR, remat=True,
                                           sym_slots=2)
        with fnn.intercept_methods(no_dropout):
            jvars, jopt, jmet = jstep(
                v64, init_fn(v64),
                {k: jnp.asarray(x.astype(np.float64) if x.dtype.kind == "f"
                                else x) for k, x in batch.items()},
                jax.random.key(1))
        jvars = jax.device_get(jvars)
        jgrad = posenet_state_dict({"params": jax.device_get(jopt[0].mu),
                                    "batch_stats": jvars["posenet"]["batch_stats"]})
    pipe = DenseFusionPipeline(N, NUM_OBJ, device="cpu", seed=None)
    pipe.load_jax_variables(v)
    pipe.cast(torch.float64).posenet.cnn.model.dropout_rates = (0.0, 0.0, 0.0)
    step = make_train_step(pipe, SYM, W, LR, remat=True, sym_slots=2)
    tb = {k: torch.from_numpy(x.astype(np.float64) if x.dtype.kind == "f" else x)
          for k, x in batch.items()}
    tb["obj"] = tuple(int(i) for i in batch["idx"])
    met = step(tb, None)
    np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(met["dis"].item(), float(jmet["dis"]), rtol=1e-5)
    num = den = 0.0
    for n, p in pipe.posenet.named_parameters():
        g, ref = step.optimizer.state[p]["exp_avg"], jgrad[n].double()
        err = float((g - ref).norm() / ref.norm().clamp(min=1e-300))
        assert err <= 1e-4, (n, err)
        num += float((g - ref).pow(2).sum())
        den += float(ref.pow(2).sum())
    assert (num / den) ** 0.5 <= 1e-4
    state = pipe.posenet.state_dict()
    for n, ref in posenet_state_dict(jvars["posenet"]).items():
        if "running" in n:
            np.testing.assert_allclose(state[n].numpy(), ref.numpy(),
                                       rtol=1e-9, atol=1e-12, err_msg=n)


@pytest.mark.parametrize("slots,want", [(-1, 8), (0, None), (4, 4), (16, None)])
def test_batch_trainer_sym_slots_is_jax_rule(slots, want):
    """YCB (5 of 21 objects symmetric) at batch 16: auto is
    2 * ceil(16 * 5 / 21) = 8; 0 and K >= batch are off."""
    cfgs = []
    for m in (j_config, t_config):
        cfg = m.get_preset("ycb_train")
        cfgs.append(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, sym_slots=slots, batch_size=16)))
    port = BatchTrainer(cfgs[1], pipe=DenseFusionPipeline(8, 2, device="cpu"))
    assert JBatchTrainer(cfgs[0])._sym_slots() == port._sym_slots() == want
    assert port.stage_step(port.init_state()).sym_slots == want
