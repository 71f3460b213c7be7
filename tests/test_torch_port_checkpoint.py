"""plr2_tpu_torch.DenseFusionPipeline against the JAX pipeline on trained
weights: the committed `trained_models/synthetic_e2e/best.msgpack` (4
objects), read here with flax and fed to `load_jax_variables` as it is
(the port itself never reads a checkpoint).

f32 is held to the pipeline tolerance. bf16 is held where the two pick the
same best hypothesis: both round PoseNet's bf16 activations at other places
(XLA on the CPU may keep excess precision inside a fusion; torch rounds
after every op), so confidences differ by a few bf16 ulps and near-ties may
pick another point. On the frames that agree, the pose arithmetic runs in
the dtypes JAX uses: a bf16 quaternion, an f32 translation.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.serialization import msgpack_restore

from plr2_tpu.pipeline import DenseFusionPipeline as JPipeline
from plr2_tpu_torch import DenseFusionPipeline

torch.set_num_threads(2)

CKPT = Path(__file__).resolve().parents[1] / "trained_models/synthetic_e2e/best.msgpack"
NUM_OBJ, N, HW, B = 4, 500, 80, 16
# bf16, port vs JAX on the frames that pick the same hypothesis: measured
# 1.3e-2 in q and 8.8e-3 in t (16 frames, 8 agreeing); a bf16 ulp is
# 3.9e-3 in [0.5, 1), and each side's PoseNet outputs, normalisation and
# two compositions round in their own places
BF16_POSE_TOL = {"quat": 3e-2, "trans": 2e-2}


@pytest.fixture(scope="module")
def case():
    variables = msgpack_restore(CKPT.read_bytes())["variables"]
    rng = np.random.default_rng(0)
    img = rng.normal(size=(B, HW, HW, 3)).astype(np.float32)
    cloud = (rng.normal(size=(B, N, 3)) * 0.1).astype(np.float32)
    choose = rng.integers(0, HW * HW, size=(B, N)).astype(np.int32)
    obj = (np.arange(B) % NUM_OBJ).astype(np.int32)
    return variables, (img, cloud, choose, obj)


def _run(variables, inputs, jdtype, tdtype):
    """(JAX estimate, JAX best index, port estimate, port best index)."""
    jpipe = JPipeline(N, NUM_OBJ, dtype=jdtype)
    jvars = (variables if jdtype == jnp.float32
             else JPipeline.cast_variables(variables, jdtype))
    jin = [jnp.asarray(a) for a in inputs]
    want = jpipe.estimate(jvars, *jin, refine_iterations=2)
    jconf = jax.jit(lambda v, *a: jpipe.posenet.apply(v["posenet"], *a)[2])(
        jvars, *jin)
    pipe = DenseFusionPipeline(N, NUM_OBJ, device="cpu", seed=None)
    pipe.load_jax_variables(variables)
    if tdtype != torch.float32:
        pipe.cast(tdtype)
    tin = [torch.from_numpy(a) for a in inputs]
    got = pipe.estimate(*tin, refine_iterations=2)
    with torch.no_grad():
        tconf = pipe.posenet(*tin)[2]
    jwhich = np.asarray(jconf[..., 0].astype(jnp.float32)).argmax(-1)
    twhich = tconf[..., 0].float().numpy().argmax(-1)
    return want, jwhich, got, twhich


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


def test_f32_estimate_matches_jax_on_trained_weights(case):
    want, jwhich, got, twhich = _run(*case, jnp.float32, torch.float32)
    np.testing.assert_array_equal(twhich, jwhich)
    # measured 1.1e-6 (q) and 5.2e-7 (t): f32 sums in another order
    np.testing.assert_allclose(_f32(got.quat), _f32(want.quat), atol=2e-3)
    np.testing.assert_allclose(_f32(got.trans), _f32(want.trans), atol=2e-3)
    np.testing.assert_allclose(_f32(got.confidence), _f32(want.confidence),
                               atol=2e-4)


def test_bf16_estimate_matches_jax_on_trained_weights(case):
    want, jwhich, got, twhich = _run(*case, jnp.bfloat16, torch.bfloat16)
    # the dtypes of JAX's bf16 estimate
    assert want.quat.dtype == jnp.bfloat16 and got.quat.dtype == torch.bfloat16
    assert want.trans.dtype == jnp.float32 and got.trans.dtype == torch.float32
    assert got.confidence.dtype == torch.bfloat16
    same = twhich == jwhich
    assert same.sum() >= 2, f"only {same.sum()} of {B} frames pick the same point"
    dq = np.abs(_f32(got.quat) - _f32(want.quat))[same].max()
    dt = np.abs(_f32(got.trans) - _f32(want.trans))[same].max()
    assert dq <= BF16_POSE_TOL["quat"], (dq, same.sum())
    assert dt <= BF16_POSE_TOL["trans"], (dt, same.sum())
