"""plr2_tpu_torch models against the JAX package: PSPNet (the gathered
embedding), PoseNet with the kernel configuration (`use_pallas=True` in
JAX; on the CPU the port's wrappers run their plain versions) and
PoseRefineNet, with flax-initialised weights whose BN statistics are
randomised, converted by plr2_tpu_torch.models.weights and strict-loaded.
Tolerances as tests/test_torch_parity.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plr2_tpu.models.posenet import PoseNet as JPoseNet
from plr2_tpu.models.posenet import PoseRefineNet as JPoseRefineNet
from plr2_tpu_torch.models import (PoseNet, PoseRefineNet, posenet_state_dict,
                                   refinenet_state_dict)
from plr2_tpu_torch.models.posenet import select_obj

torch.set_num_threads(2)

NUM_OBJ, N, HW = 5, 64, 80


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _randomize_bn_stats(rng, variables):
    """Random means and positive variances in place of the init (0, 1)."""
    def stat(path, x):
        r = rng.normal(size=x.shape).astype(np.float32)
        if any("var" in str(p) for p in path):
            return np.abs(r) * 0.5 + 0.3
        return r * 0.3

    out = dict(variables)
    out["batch_stats"] = jax.tree_util.tree_map_with_path(
        stat, variables["batch_stats"])
    return out


@pytest.fixture(scope="module")
def posenet_case():
    rng = np.random.default_rng(7)
    img = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    cloud = (rng.normal(size=(2, N, 3)) * 0.1).astype(np.float32)
    choose = rng.integers(0, HW * HW, size=(2, N)).astype(np.int32)
    obj = np.array([1, 4], dtype=np.int32)
    jargs = tuple(map(jnp.asarray, (img, cloud, choose, obj)))
    # the XLA and Pallas configurations share one parameter tree
    # (tests/test_models.py pins it); init through the cheaper one
    init = jax.jit(JPoseNet(num_points=N, num_objects=NUM_OBJ).init)
    variables = _randomize_bn_stats(
        rng, _to_numpy(init(jax.random.key(0), *jargs)))
    jmodel = JPoseNet(num_points=N, num_objects=NUM_OBJ, use_pallas=True)
    want = [np.asarray(o) for o in jax.jit(jmodel.apply)(variables, *jargs)]

    model = PoseNet(N, NUM_OBJ).eval()
    model.load_state_dict(posenet_state_dict(variables), strict=True)
    with torch.no_grad():
        got = [o.numpy() for o in model(
            torch.from_numpy(img), torch.from_numpy(cloud),
            torch.from_numpy(choose), torch.from_numpy(obj))]
    return want, got, variables


def test_posenet_weights_load_strict(posenet_case):
    _, _, variables = posenet_case
    sd = posenet_state_dict(variables)
    model = PoseNet(N, NUM_OBJ)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    # HWIO -> OIHW for the decoder stages, (in, out) -> (out, in, 1) heads
    k = variables["params"]["cnn"]["up_1"]["conv"]["kernel"]
    np.testing.assert_array_equal(
        model.cnn.model.up_1.conv[1].weight.detach().numpy(),
        k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        model.conv4_r.weight.detach().numpy()[..., 0],
        variables["params"]["conv4_r"]["kernel"].T)
    mean = variables["batch_stats"]["cnn"]["feats"]["bn1"]["mean"]
    np.testing.assert_array_equal(
        model.cnn.model.feats.bn1.running_mean.numpy(), mean)


def test_pspnet_embedding_matches_jax(posenet_case):
    (_, _, _, jemb), (_, _, _, temb), _ = posenet_case
    assert temb.shape == (2, N, 32)
    np.testing.assert_allclose(temb, jemb, atol=2e-4)


@pytest.mark.parametrize("head,atol", [(0, 2e-3), (1, 2e-3), (2, 2e-4)],
                         ids=["r", "t", "c"])
def test_posenet_heads_match_jax_pallas_path(posenet_case, head, atol):
    want, got, _ = posenet_case
    assert got[head].shape == want[head].shape
    np.testing.assert_allclose(got[head], want[head], atol=atol)


def test_select_obj_picks_each_frames_object():
    h = torch.arange(2 * 3 * 5 * 4, dtype=torch.float32).reshape(2, 3, 20)
    got = select_obj(h, torch.tensor([1, 4]), 5, 4)
    want = torch.stack([h[0, :, 4:8], h[1, :, 16:20]])
    assert torch.equal(got, want)


def test_refinenet_matches_jax():
    rng = np.random.default_rng(8)
    cloud = rng.normal(size=(2, N, 3)).astype(np.float32)
    emb = rng.normal(size=(2, N, 32)).astype(np.float32)
    obj = np.array([0, 3], dtype=np.int32)
    jargs = tuple(map(jnp.asarray, (cloud, emb, obj)))
    jmodel = JPoseRefineNet(num_points=N, num_objects=NUM_OBJ)
    variables = _to_numpy(jax.jit(jmodel.init)(jax.random.key(1), *jargs))
    jr, jt = jax.jit(jmodel.apply)(variables, *jargs)

    model = PoseRefineNet(N, NUM_OBJ).eval()
    model.load_state_dict(refinenet_state_dict(variables), strict=True)
    with torch.no_grad():
        tr, tt = model(*map(torch.from_numpy, (cloud, emb, obj)))
    assert tr.shape == (2, 1, 4) and tt.shape == (2, 1, 3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
