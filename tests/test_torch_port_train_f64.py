"""Train-mode PoseNet's backward against the JAX package in float64.

In f32 the colour encoder's gradients are ill-conditioned at the tests'
sizes (tests/test_torch_port_train.py `_grad_error`), so the one-step
comparison there holds them loosely. Here both sides run in float64, where
that ill-conditioning costs nothing, and every gradient must agree: this
is what shows that port and JAX compute one function.
"""

import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from plr2_tpu.models.posenet import PoseNet as JPoseNet
from plr2_tpu_torch.models import PoseNet, posenet_state_dict
from test_torch_port_pipeline import _numpy_variables
from test_torch_port_train import NUM_OBJ, _no_dropout

torch.set_num_threads(2)


def test_posenet_train_backward_matches_jax_in_float64():
    """Train-mode PoseNet (BatchNorm on batch statistics, dropout off) in
    float64 on both sides: every parameter gradient and running statistic
    agrees, the ResNet's included: the two compute one function. The JAX
    PSP builds its pooling and resize matrices in f32 (pspnet.py:38,67), so
    weights such as 1/3 carry f32 rounding: measured 2.3e-8 of a tensor's
    largest entry; the bound is 1e-6. (In f32 the ResNet gradients differ
    by up to ~20% of the largest entry: see `_grad_error`.)"""
    rng = np.random.default_rng(6)
    b, n, hw = 2, 16, 48
    jnet = JPoseNet(num_points=n, num_objects=NUM_OBJ, dtype=jnp.float64)
    img = rng.normal(size=(b, hw, hw, 3))
    cloud = rng.normal(size=(b, n, 3)) * 0.1
    choose = rng.integers(0, hw * hw, size=(b, n)).astype(np.int32)
    obj = np.array([1, 4], np.int32)
    cots = [rng.normal(size=(b, n, d)) for d in (4, 3, 1)]
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda k: jnet.init(k, img, cloud, choose, obj),
                                jax.random.key(0))
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), _numpy_variables(rng, shapes))

        def f(params):
            (r, t, c, _), upd = jnet.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                img, cloud, choose, obj, train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.key(0)})
            return sum(jnp.sum(o * k) for o, k in zip((r, t, c), cots)), upd

        with fnn.intercept_methods(_no_dropout):
            jgrad, upd = jax.jit(jax.grad(f, has_aux=True))(variables["params"])
        want = posenet_state_dict(jax.device_get(
            {"params": jgrad, "batch_stats": upd["batch_stats"]}))
    net = PoseNet(n, NUM_OBJ).double()
    net.load_state_dict(posenet_state_dict(variables))
    net.train().cnn.model.dropout_rates = (0.0, 0.0, 0.0)
    outs = net(*(torch.from_numpy(v) for v in (img, cloud, choose, obj)))
    sum((o * torch.from_numpy(k)).sum() for o, k in zip(outs[:3], cots)).backward()
    for name, p in net.named_parameters():
        ref = want[name].double()
        err = float((p.grad - ref).abs().max() / ref.abs().max())
        assert err <= 1e-6, (name, err)
    for name, t in net.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       rtol=1e-9, atol=1e-12, err_msg=name)
