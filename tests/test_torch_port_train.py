"""plr2_tpu_torch training against the JAX package: the autograd Functions
around the kernels (`mlp_head`, `upconv3x3_prelu`) against `jax.grad` of
the Pallas kernels in interpret mode, train-mode BatchNorm against flax,
the PSP channel dropout, and one stage-1 step and one refine-stage step of
`make_train_step` against the JAX `make_train_step` from the same weights
and batch.

In the two steps dropout is off on both sides (flax's `nn.Dropout` is
intercepted to return its input; the port's rates are set to 0), so the
steps compute one function. The JAX side runs `use_pallas=False`, which is
the same function with a cheaper compile (tests/test_models.py pins the
shared parameter tree; the kernel-level tests below hold the Pallas VJPs).
"""

import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import pytest
import torch

from plr2_tpu.ops.pallas_fusion import fused_mlp_head
from plr2_tpu.ops.pallas_upsample import fused_upconv3x3_prelu
from plr2_tpu.parallel.data_parallel import make_train_step as j_make_train_step
from plr2_tpu.pipeline import DenseFusionPipeline as JPipeline
from plr2_tpu_torch import DenseFusionPipeline
from plr2_tpu_torch.models import posenet_state_dict, refinenet_state_dict
from plr2_tpu_torch.models.pspnet import channel_dropout
from plr2_tpu_torch.models.resnet import BatchNorm2d
from plr2_tpu_torch.ops import mlp_head, upconv
from plr2_tpu_torch.parallel import make_train_step
from test_torch_port_pipeline import (_numpy_variables, _set_tf32, _tf32_flags,
                                      record_tf32_in_first_conv)

torch.set_num_threads(2)

NUM_OBJ, N, HW, M, B = 5, 64, 80, 32, 2
SYM, W, LR, ITERS = (4,), 0.015, 1e-4, 2
BETA1 = 0.9


# ---------------- kernel Functions ----------------


def test_mlp_head_backward_matches_jax_grad_of_pallas_kernel():
    rng = np.random.default_rng(0)
    dims = [48, 40, 24, 16, 10]
    ws = [(rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [(rng.normal(size=(o,)) * 0.1).astype(np.float32) for o in dims[1:]]
    x = rng.normal(size=(37, dims[0])).astype(np.float32)
    cot = rng.normal(size=(37, dims[-1])).astype(np.float32)

    def jloss(x, params):
        return jnp.sum(fused_mlp_head(x, params, True) * cot)
    jx, jp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in zip(ws, bs)))

    tx = torch.from_numpy(x).requires_grad_(True)
    tp = [(torch.from_numpy(w.T.copy()).requires_grad_(True),
           torch.from_numpy(b).requires_grad_(True)) for w, b in zip(ws, bs)]
    (mlp_head.mlp_head(tx, tp) * torch.from_numpy(cot)).sum().backward()
    # f32 products summed in another order (test_pallas.py's tolerance)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx), **tol)
    for (w, b), (jw, jb) in zip(tp, jp):
        np.testing.assert_allclose(w.grad.numpy().T, np.asarray(jw), **tol)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(jb), **tol)


def test_upconv_backward_matches_jax_grad_of_pallas_kernel():
    """Odd H != W: the clamped upsample edges and the conv's zero padding."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 8, 16)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(16,)) * 0.1).astype(np.float32)
    alpha = np.float32(0.25)
    cot = rng.normal(size=(2, 10, 6, 16)).astype(np.float32)

    def jloss(x, w, b, a):
        return jnp.sum(fused_upconv3x3_prelu(x, w, b, a, True) * cot)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), jnp.asarray(alpha))

    leaves = [torch.from_numpy(v).requires_grad_(True)
              for v in (x, w, bias, np.array([alpha]))]
    (upconv.upconv3x3_prelu(*leaves) * torch.from_numpy(cot)).sum().backward()
    for leaf, jg, name in zip(leaves, want, ("x", "w", "bias", "alpha")):
        np.testing.assert_allclose(leaf.grad.numpy().reshape(np.shape(jg)),
                                   np.asarray(jg), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


# ---------------- BatchNorm and dropout ----------------


def test_train_mode_batchnorm_matches_flax():
    """Output, gradients and running statistics after two train-mode calls
    (flax: momentum 0.9 on the BIASED variance; n = 2*5*7 = 70 values per
    channel, where torch's own unbiased update would be 1.4% off)."""
    rng = np.random.default_rng(2)
    xs = [(rng.normal(size=(2, 5, 7, 6)) * 2.0 + 0.5).astype(np.float32)
          for _ in range(2)]
    scale = rng.uniform(0.5, 1.5, size=6).astype(np.float32)
    shift = rng.normal(size=6).astype(np.float32)
    mean0 = rng.normal(size=6).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, size=6).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": shift},
                 "batch_stats": {"mean": mean0, "var": var0}}
    tbn = BatchNorm2d(6).train()
    with torch.no_grad():
        for t, v in ((tbn.weight, scale), (tbn.bias, shift),
                     (tbn.running_mean, mean0), (tbn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    for x in xs:
        cot = rng.normal(size=x.shape).astype(np.float32)

        def jloss(params, x):
            y, upd = bn.apply({"params": params,
                               "batch_stats": variables["batch_stats"]}, x,
                              mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, upd)
        (_, (want, upd)), jg = jax.value_and_grad(jloss, has_aux=True)(
            variables["params"], x)
        variables["batch_stats"] = upd["batch_stats"]
        tx = torch.from_numpy(x).permute(0, 3, 1, 2)
        y = tbn(tx)
        (y * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
        np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(variables["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(variables["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    # gradients of the last call (torch accumulated both calls' grads)
    assert tbn.weight.grad is not None and tbn.num_batches_tracked.item() == 2
    tbn.eval()
    y = tbn(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    ref = ((xs[0] - tbn.running_mean.numpy()) / np.sqrt(tbn.running_var.numpy() + 1e-5)
           * scale + shift)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


def test_channel_dropout_rate_scale_and_seed():
    x = torch.ones((64, 3, 2, 256))
    y = channel_dropout(x, 0.3, torch.Generator().manual_seed(7))
    # one draw per (sample, channel), broadcast over H and W
    assert torch.equal(y, y[:, :1, :1].expand_as(y))
    kept = y[:, 0, 0] != 0
    torch.testing.assert_close(y[:, 0, 0][kept],
                               torch.full((int(kept.sum()),), 1 / 0.7))
    # 16384 Bernoulli(0.3) draws: 5 sigma is 0.018
    assert abs(1 - kept.float().mean().item() - 0.3) < 0.018
    again = channel_dropout(x, 0.3, torch.Generator().manual_seed(7))
    other = channel_dropout(x, 0.3, torch.Generator().manual_seed(8))
    assert torch.equal(y, again) and not torch.equal(y, other)
    assert channel_dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        channel_dropout(x, 0.15, None)


def test_train_mode_forward_draws_dropout_from_the_generator():
    pipe = DenseFusionPipeline(16, 3, device="cpu", seed=3)
    g = torch.Generator().manual_seed(0)
    args = (torch.randn((2, 48, 48, 3), generator=g),
            torch.randn((2, 16, 3), generator=g) * 0.1,
            torch.randint(0, 48 * 48, (2, 16), generator=g), torch.tensor([0, 2]))
    net = pipe.posenet.train()
    with torch.no_grad():
        a = net(*args, torch.Generator().manual_seed(5))[3]
        b = net(*args, torch.Generator().manual_seed(5))[3]
        c = net(*args, torch.Generator().manual_seed(6))[3]
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------- one step of each stage against JAX ----------------


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture(scope="module")
def steps():
    """JAX stage-1 and refine-stage steps (one compile each) and the
    port's, from the same weights and batch."""
    rng = np.random.default_rng(4)
    jpipe = JPipeline(num_points=N, num_objects=NUM_OBJ)
    shapes = jax.eval_shape(lambda k: jpipe.init(k, crop_hw=HW, batch=1),
                            jax.random.key(0))
    variables = _numpy_variables(rng, shapes)
    mp = rng.normal(size=(B, M, 3)) * 0.05
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w_, x_, y_, z_ = q.T
    rot = np.stack([
        np.stack([1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - w_ * z_), 2 * (x_ * z_ + w_ * y_)], -1),
        np.stack([2 * (x_ * y_ + w_ * z_), 1 - 2 * (x_ * x_ + z_ * z_), 2 * (y_ * z_ - w_ * x_)], -1),
        np.stack([2 * (x_ * z_ - w_ * y_), 2 * (y_ * z_ + w_ * x_), 1 - 2 * (x_ * x_ + y_ * y_)], -1),
    ], -2)
    target = np.einsum("bmk,blk->bml", mp, rot) + rng.normal(size=(B, 1, 3)) * 0.05
    batch = dict(img=rng.normal(size=(B, HW, HW, 3)),
                 points=rng.normal(size=(B, N, 3)) * 0.1,
                 choose=rng.integers(0, HW * HW, size=(B, N)),
                 target=target, model_points=mp,
                 idx=np.array([1, 4]))  # one ADD, one ADD-S sample
    batch = {k: v.astype(np.int32 if v.dtype.kind == "i" else np.float32)
             for k, v in batch.items()}
    out = {}
    for iters in (0, ITERS):
        init_fn, jstep = j_make_train_step(jpipe, SYM, W, LR,
                                           refine_iterations=iters)
        with fnn.intercept_methods(_no_dropout):
            jvars, jopt, jmet = jstep(
                variables, init_fn(variables),
                {k: jnp.asarray(v) for k, v in batch.items()},
                jax.random.key(1))
        pipe = DenseFusionPipeline(N, NUM_OBJ, device="cpu", seed=None)
        pipe.load_jax_variables(variables)
        pipe.posenet.cnn.model.dropout_rates = (0.0, 0.0, 0.0)
        step = make_train_step(pipe, SYM, W, LR, refine_iterations=iters)
        met = step({k: torch.from_numpy(v) for k, v in batch.items()},
                   torch.Generator().manual_seed(0))
        out[iters] = dict(variables=variables, jvars=jax.device_get(jvars),
                          jmu=jax.device_get(jopt[0].mu), jmet=jmet,
                          pipe=pipe, step=step, met=met)
    return out


def _grad_error(name: str, g_port, g_jax, refine: bool) -> None:
    """Stage 1's colour-encoder gradients (ResNet, PSP, decoder: `cnn.*`)
    are ill-conditioned in f32 at these sizes: in float64 the port and JAX
    agree on them to 1e-6 (tests/test_torch_port_train_f64.py), but the
    port's own f32 gradients differ from its float64 ones by up to 6e-2
    of a tensor's largest entry, and port and JAX in f32 by up to ~20% on
    a few entries, while the direction holds (cosine > 0.9997). So they are held in relative L2 norm, 5e-2 (measured up to
    2e-2). Every other stage-1 tensor: 1e-4 of its largest entry (measured
    1.6e-6). The refiner's e_conv1 gradient sums a log-softmax embedding
    (values near -ln 32, small spread) times its cotangent over the points
    and cancels: measured up to 3e-4 of its largest entry on other inputs,
    so the refine stage gets 1e-3."""
    err = g_port - g_jax
    if not refine and name.startswith("cnn."):
        rel = float(err.norm() / g_jax.norm().clamp(min=1e-300))
        assert rel <= 5e-2, (name, rel)
    else:
        rel = float(err.abs().max() / g_jax.abs().max().clamp(min=1e-300))
        assert rel <= (1e-3 if refine else 1e-4), (name, rel)


def _check_step(run, refine: bool):
    jm, met = run["jmet"], run["met"]
    np.testing.assert_allclose(met["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(met["dis"].item(), float(jm["dis"]), rtol=1e-5)
    key, to_sd = ("refiner", refinenet_state_dict) if refine else (
        "posenet", posenet_state_dict)
    module = run["pipe"].refiner if refine else run["pipe"].posenet
    before = to_sd(run["variables"][key])
    want = to_sd(run["jvars"][key])
    extra = {"batch_stats": run["jvars"][key]["batch_stats"]} if not refine else {}
    jgrad = to_sd({"params": run["jmu"], **extra})
    got = module.state_dict()
    params = dict(module.named_parameters())
    assert set(params) <= set(want)
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        if name not in params:
            # BN running statistics: flax's update on the biased variance
            np.testing.assert_allclose(got[name].numpy(), ref.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
            continue
        # gradients, from Adam's first moment m = (1 - beta1) g
        g_jax = jgrad[name].double() / (1 - BETA1)
        g_port = run["step"].optimizer.state[params[name]]["exp_avg"].double() / (1 - BETA1)
        _grad_error(name, g_port, g_jax, refine)
        # the updates are Adam's for these gradients: at step 1 the update
        # is lr g / (|g| + eps), so with |g_port - g_jax| <= d it differs by
        # at most lr d / (|g| - d) where |g| > d, and never by more than 2 lr
        d = float((g_port - g_jax).abs().max())
        margin = (g_jax.abs() - d).clamp(min=0)
        bound = torch.where(margin > 0, LR * d / margin.clamp(min=1e-300),
                            torch.full_like(margin, 2 * LR)).clamp(max=2 * LR)
        b0 = before[name].double()
        d_port, d_jax = got[name].double() - b0, ref.double() - b0
        # plus an f32 rounding of each updated parameter
        slack = 1e-7 + 2.4e-7 * b0.abs()
        assert bool(((d_port - d_jax).abs() <= bound + slack).all()), name
        assert bool((d_port != 0).any()) or bool((g_jax == 0).all()), name


def test_stage1_step_matches_jax(steps):
    run = steps[0]
    _check_step(run, refine=False)
    # the refiner is untouched, and the launch-free CPU path ran
    for name, t in run["pipe"].refiner.state_dict().items():
        np.testing.assert_array_equal(
            t.numpy(), refinenet_state_dict(run["variables"]["refiner"])[name].numpy())


def test_refine_step_matches_jax(steps):
    run = steps[ITERS]
    _check_step(run, refine=True)
    # PoseNet is frozen: parameters and BN statistics unchanged
    before = posenet_state_dict(run["variables"]["posenet"])
    for name, t in run["pipe"].posenet.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(t.numpy(), before[name].numpy(), err_msg=name)


@pytest.mark.parametrize("iters", [0, ITERS], ids=["stage1", "refine"])
def test_f32_train_step_turns_tf32_off_and_restores_the_flags(iters):
    saved = _tf32_flags()
    pipe = DenseFusionPipeline(16, 3, device="cpu", seed=3)
    seen = record_tf32_in_first_conv(pipe.posenet)
    g = torch.Generator().manual_seed(0)
    batch = dict(img=torch.randn((2, 48, 48, 3), generator=g),
                 points=torch.randn((2, 16, 3), generator=g) * 0.1,
                 choose=torch.randint(0, 48 * 48, (2, 16), generator=g),
                 target=torch.randn((2, 8, 3), generator=g) * 0.05,
                 model_points=torch.randn((2, 8, 3), generator=g) * 0.05,
                 idx=torch.tensor([0, 2]))
    step = make_train_step(pipe, (2,), W, LR, refine_iterations=iters)
    try:
        _set_tf32(True, True)
        met = step(batch, torch.Generator().manual_seed(1))
        # stage 1 records the conv's forward and backward, the refine stage
        # its (no-grad) forward
        assert len(seen) == (1 if iters else 2), seen
        assert all(s == (False, False) for s in seen), seen
        assert _tf32_flags() == (True, True)
        assert torch.isfinite(met["loss"])
    finally:
        _set_tf32(*saved)


def test_train_step_defaults_to_cuda_and_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card, so the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(DenseFusionPipeline(16, 3), SYM, W, LR)
