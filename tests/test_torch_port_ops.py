"""plr2_tpu_torch kernel modules and geometry against the JAX package.

On the CPU the kernel wrappers run their plain PyTorch versions (the CUDA
kernels are built and held against those plain versions on the card by
chip_smoke.py). Here the plain versions are held against the JAX Pallas
kernels in interpret mode and against their XLA compositions, on the same
numpy inputs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plr2_tpu.geometry import pointcloud as jpc
from plr2_tpu.geometry import quaternion as jq
from plr2_tpu.ops.pallas_fusion import fused_mlp_head
from plr2_tpu.ops.pallas_upsample import (fused_upconv3x3_prelu,
                                          upconv3x3_prelu_xla)
from plr2_tpu_torch.geometry import (compose_pose, normalize_quaternion,
                                     quat_multiply, quat_to_matrix_df,
                                     recenter_points)
from plr2_tpu_torch.ops import _build, launch_counts, mlp_head, upconv

torch.set_num_threads(2)


def _ladder(rng, dims):
    """JAX-layout (in, out) layers and the port's (out, in) layout."""
    jax_params, port_params = [], []
    for cin, cout in zip(dims[:-1], dims[1:]):
        w = (rng.normal(size=(cin, cout)) / np.sqrt(cin)).astype(np.float32)
        b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
        jax_params.append((jnp.asarray(w), jnp.asarray(b)))
        port_params.append((torch.from_numpy(w.T.copy()), torch.from_numpy(b)))
    return tuple(jax_params), port_params


def test_mlp_head_plain_matches_pallas_kernel(rng):
    jp, tp = _ladder(rng, [1408, 640, 256, 128, 84])
    x = rng.normal(size=(300, 1408)).astype(np.float32)
    want = np.asarray(fused_mlp_head(jnp.asarray(x), jp, True))
    got = mlp_head.mlp_head(torch.from_numpy(x), tp)
    assert got.shape == (300, 84) and got.dtype == torch.float32
    # f32 sums in another order (test_pallas.py's tolerance)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_mlp_head_bf16_ladder_matches_pallas_kernel(rng):
    """bf16: f32 accumulation, f32 bias, activations rounded to bf16
    between layers, as `_mlp_kernel` does."""
    jp, tp = _ladder(rng, [256, 128, 64, 32, 12])
    x = rng.normal(size=(96, 256)).astype(np.float32)
    jp16 = tuple((w.astype(jnp.bfloat16), b.astype(jnp.bfloat16)) for w, b in jp)
    want = fused_mlp_head(jnp.asarray(x, jnp.bfloat16), jp16, True)
    assert want.dtype == jnp.bfloat16
    tp16 = [(w.bfloat16(), b.bfloat16()) for w, b in tp]
    got = mlp_head.mlp_head(torch.from_numpy(x).bfloat16(), tp16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    # both round the same f32 sums to bf16; a sum within one ulp (2^-8
    # relative) of a rounding boundary may round the other way in one of
    # them, and the later layers carry such flips on
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    # skipping the inter-layer rounding would be a different function:
    # the rounded ladder is measurably closer to the JAX kernel
    unrounded = mlp_head.mlp_head_plain(torch.from_numpy(x).bfloat16().float(),
                                        [(w.float(), b.float()) for w, b in tp16])
    assert np.abs(got - want).mean() < np.abs(unrounded.numpy() - want).mean()


def _upconv_case(rng, b, h, w, cin, cout):
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return x, wk, bias, np.float32(0.25)


@pytest.mark.parametrize("shape", [(2, 5, 6, 16, 32), (1, 7, 3, 8, 24)])
def test_upconv_plain_matches_pallas_kernel_and_xla(rng, shape):
    """Odd H != W: the border rows and columns are where the clamped
    upsample and the conv's zero padding meet."""
    x, wk, bias, alpha = _upconv_case(rng, *shape)
    jargs = (jnp.asarray(x), jnp.asarray(wk), jnp.asarray(bias),
             jnp.asarray(alpha))
    want_pallas = np.asarray(fused_upconv3x3_prelu(*jargs, True))
    want_xla = np.asarray(upconv3x3_prelu_xla(*jargs))
    got = upconv.upconv3x3_prelu(
        torch.from_numpy(x), torch.from_numpy(wk), torch.from_numpy(bias),
        torch.tensor([alpha]))
    b, h, w, _, cout = shape
    assert got.shape == (b, 2 * h, 2 * w, cout)
    for want in (want_pallas, want_xla):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_upsample2x_matches_jax_resize(rng):
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 10, 14, 3), method="linear")
    got = upconv.upsample2x_bilinear(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_wrappers_run_plain_on_cpu_without_counting(rng):
    x = torch.from_numpy(rng.normal(size=(1, 3, 4, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 8, 16)).astype(np.float32))
    b, a = torch.zeros(16), torch.tensor([0.25])
    before = launch_counts()
    assert torch.equal(upconv.upconv3x3_prelu(x, w, b, a),
                       upconv.upconv3x3_prelu_plain(x, w, b, a))
    _, tp = _ladder(rng, [8, 6, 5, 4, 3])
    xh = torch.from_numpy(rng.normal(size=(10, 8)).astype(np.float32))
    assert torch.equal(mlp_head.mlp_head(xh, tp), mlp_head.mlp_head_plain(xh, tp))
    assert launch_counts() == before


def test_wrappers_raise_off_cpu_without_cuda():
    """A tensor that is not on the CPU goes to the kernel or raises: there
    is no fallback to the plain version."""
    x = torch.empty((1, 3, 4, 8), device="meta")
    w = torch.empty((3, 3, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        upconv.upconv3x3_prelu(x, w, torch.empty(16, device="meta"),
                               torch.empty(1, device="meta"))
    params = [(torch.empty((o, i), device="meta"), torch.empty(o, device="meta"))
              for i, o in ((8, 6), (6, 5), (5, 4), (4, 3))]
    with pytest.raises(ValueError, match="CUDA"):
        mlp_head.mlp_head(torch.empty((10, 8), device="meta"), params)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("CUDA_PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    if (_build.Path("/usr/local/cuda") / "bin" / "nvcc").is_file():
        pytest.skip("this host has nvcc at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "_build").exists()


def test_build_path_depends_on_sources(monkeypatch, tmp_path):
    path = _build.library_path()
    assert path.parent.parent == _build.BUILD_DIR
    assert path == _build.library_path()
    for src in _build.CSRC_DIR.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    assert _build.library_path() == path
    (tmp_path / "upconv.cu").write_text("// changed\n")
    assert _build.library_path() != path


# ---------------- geometry ----------------


def _quats(rng, n=16):
    return rng.normal(size=(n, 4)).astype(np.float32)


def test_normalize_and_matrix_match_jax(rng):
    q = _quats(rng)
    q[0] = 0.0  # degenerate: eps keeps it finite
    qn = normalize_quaternion(torch.from_numpy(q))
    np.testing.assert_allclose(qn.numpy(),
                               np.asarray(jq.normalize_quaternion(q)), atol=1e-6)
    np.testing.assert_allclose(
        quat_to_matrix_df(qn).numpy(),
        np.asarray(jq.quat_to_matrix_df(jnp.asarray(qn.numpy()))), atol=1e-6)


def test_quat_multiply_matches_jax(rng):
    a, b = _quats(rng), _quats(rng)
    np.testing.assert_allclose(
        quat_multiply(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jq.quat_multiply(a, b)), atol=1e-6)


def test_compose_and_recenter_match_jax(rng):
    qo = np.array(jq.normalize_quaternion(_quats(rng, 3)))
    qi = np.array(jq.normalize_quaternion(_quats(rng, 3)))
    to, ti = (rng.normal(size=(3, 3)).astype(np.float32) for _ in range(2))
    pts = rng.normal(size=(3, 50, 3)).astype(np.float32)
    q, t = compose_pose(*(torch.from_numpy(v) for v in (qo, to, qi, ti)))
    jqq, jt = jpc.compose_pose(qo, to, qi, ti)
    np.testing.assert_allclose(q.numpy(), np.asarray(jqq), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5)
    got = recenter_points(torch.from_numpy(pts), torch.from_numpy(qo),
                          torch.from_numpy(to))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jpc.recenter_points(pts, qo, to)),
                               atol=1e-5)
