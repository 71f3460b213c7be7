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


# ---------------- PSP pooling and the choose gather (deterministic
# backward passes: products with fixed matrices, a fixed-order segment sum)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_psp_module_forward_and_gradient_match_jax(dt):
    """PSPModule pools and resizes by products with JAX's fixed matrices:
    the pool in f32, the upscale in the activations' dtype. Forward and
    gradients (input and a bin's convolution) against JAX's PSPModule, on
    a 10 x 13 map (not square, so both matrices matter)."""
    from plr2_tpu.models.pspnet import PSPModule as JPSP
    from plr2_tpu_torch.models.pspnet import PSPModule
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 10, 13, 16)).astype(np.float32)
    ct = rng.normal(size=(2, 10, 13, 24)).astype(np.float32)
    jm = JPSP(out_features=24, dtype=jdt)
    variables = _to_numpy(jax.jit(jm.init)(jax.random.key(2), jnp.asarray(x)))

    def loss(v, xin):
        return jnp.sum(jm.apply(v, xin).astype(jnp.float32) * ct)
    xin = jnp.asarray(x).astype(jdt)
    want = np.asarray(jm.apply(variables, xin).astype(jnp.float32))
    gv, gx = jax.grad(loss, argnums=(0, 1))(variables, xin)

    p = variables["params"]
    sd = {f"stages.{i}.1.weight": torch.from_numpy(
        np.ascontiguousarray(p[f"stage{i}_conv"]["kernel"].transpose(3, 2, 0, 1)))
        for i in range(4)}
    sd["bottleneck.weight"] = torch.from_numpy(
        np.ascontiguousarray(p["bottleneck"]["kernel"].transpose(3, 2, 0, 1)))
    sd["bottleneck.bias"] = torch.from_numpy(np.array(p["bottleneck"]["bias"]))
    m = PSPModule(16, 24)
    m.load_state_dict(sd, strict=True)
    m.to(tdt)
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    out = m(xt)
    (out.permute(0, 2, 3, 1).float() * torch.from_numpy(ct)).sum().backward()
    got = out.detach().permute(0, 2, 3, 1).float().numpy()
    got_gx = xt.grad.permute(0, 2, 3, 1).float().numpy()
    got_gw = m.stages[2][1].weight.grad.float().permute(2, 3, 1, 0).numpy()
    want_gx = np.asarray(gx.astype(jnp.float32))
    want_gw = np.asarray(gv["params"]["stage2_conv"]["kernel"].astype(jnp.float32))
    # relative L2 over each tensor. f32: sums in another order (measured
    # 2.2e-7). bf16: each side rounds every product's output to bf16, XLA
    # on the CPU sometimes only after a fused chain, and the input gradient
    # adds five bf16-rounded paths, so elements land a few ulps (2^-8
    # relative) apart (measured 6.9e-3)
    tol = {"f32": 1e-5, "bf16": 2e-2}[dt]
    for a, b in ((got, want), (got_gx, want_gx), (got_gw, want_gw)):
        assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b)


def _gather_case(rng, b=2, n=40, hw=30, c=8):
    """Indices with repeats: every sample reuses its first rows (the wrap
    path of sample_choose on a mask with fewer pixels than N)."""
    y = rng.normal(size=(b, hw, c)).astype(np.float32)
    idx = rng.integers(0, hw, size=(b, n))
    idx[:, n // 2:] = idx[:, :n - n // 2]
    ct = rng.normal(size=(b, n, c)).astype(np.float32)
    return y, idx, ct


def test_gather_rows_matches_torch_gather_and_jax():
    from plr2_tpu.ops.gather import gather_rows as j_gather_rows
    from plr2_tpu_torch.ops.gather import gather_rows
    y, idx, ct = _gather_case(np.random.default_rng(13))
    yt = torch.from_numpy(y).requires_grad_()
    out = gather_rows(yt, torch.from_numpy(idx))
    (out * torch.from_numpy(ct)).sum().backward()
    yr = torch.from_numpy(y).requires_grad_()
    ref = torch.gather(yr, 1, torch.from_numpy(idx)[..., None].expand(-1, -1, 8))
    (ref * torch.from_numpy(ct)).sum().backward()
    assert torch.equal(out, ref)
    np.testing.assert_allclose(yt.grad.numpy(), yr.grad.numpy(), atol=1e-6)
    jy, ji = jnp.asarray(y), jnp.asarray(idx, jnp.int32)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(j_gather_rows(jy, ji)))
    np.testing.assert_array_equal(
        out.detach().numpy(),
        np.asarray(jnp.take_along_axis(jy, ji[..., None], axis=1)))
    jgrad = jax.grad(lambda v: jnp.sum(j_gather_rows(v, ji) * ct))(jy)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(jgrad), atol=1e-6)


def test_gather_rows_backward_sums_each_segment_in_order():
    """The plain version (the kernel's twin, bit for bit) adds each row's
    gradients in ascending n in f32: a sequential sum, rows no index
    points at are zero, and bf16 rounds once at the end."""
    from plr2_tpu_torch.ops import launch_counts
    from plr2_tpu_torch.ops.gather import gather_rows_backward
    y, idx, ct = _gather_case(np.random.default_rng(14))
    before = launch_counts()
    got = gather_rows_backward(torch.from_numpy(ct), torch.from_numpy(idx), 30)
    assert launch_counts() == before
    for b in range(2):
        for h in range(30):
            acc = np.zeros(8, np.float32)
            for n in np.flatnonzero(idx[b] == h):
                acc = acc + ct[b, n]
            np.testing.assert_array_equal(got[b, h].numpy(), acc)
    bf = gather_rows_backward(torch.from_numpy(ct).bfloat16(),
                              torch.from_numpy(idx), 30)
    assert bf.dtype == torch.bfloat16
    f32 = gather_rows_backward(torch.from_numpy(ct).bfloat16().float(),
                               torch.from_numpy(idx), 30)
    assert torch.equal(bf, f32.bfloat16())


def test_gather_rows_backward_raises_off_cpu_without_cuda():
    from plr2_tpu_torch.ops.gather import gather_rows_backward
    with pytest.raises(ValueError, match="CUDA"):
        gather_rows_backward(torch.empty((2, 5, 8), device="meta"),
                             torch.empty((2, 5), dtype=torch.long,
                                         device="meta"), 30)
