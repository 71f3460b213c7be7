"""plr2_tpu_torch.DenseFusionPipeline against the JAX pipeline in its
`use_pallas=True` configuration, plus the port's package rules: it imports
no JAX and no plr2_tpu module, and runs on the CPU only when asked to."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plr2_tpu.pipeline import DenseFusionPipeline as JPipeline
from plr2_tpu.refine.iterative import initial_pose as j_initial_pose
from plr2_tpu_torch import DenseFusionPipeline
from plr2_tpu_torch.refine import initial_pose

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
NUM_OBJ, N, HW = 5, 64, 80


def _numpy_variables(rng, shapes):
    """Seeded numpy weights for the JAX variable tree `shapes`:
    LeCun-normal kernels, small biases, random BN statistics."""
    def fill(path, s):
        name = str(path[-1])
        if "var" in name:
            return (np.abs(rng.normal(size=s.shape)) * 0.5 + 0.3).astype(np.float32)
        if "mean" in name:
            return (rng.normal(size=s.shape) * 0.3).astype(np.float32)
        if "scale" in name:
            return np.ones(s.shape, np.float32)
        if "prelu_alpha" in name:
            return np.full(s.shape, 0.25, np.float32)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_estimate_matches_jax_pallas_pipeline():
    rng = np.random.default_rng(11)
    img = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    cloud = (rng.normal(size=(2, N, 3)) * 0.1).astype(np.float32)
    choose = rng.integers(0, HW * HW, size=(2, N)).astype(np.int32)
    obj = np.array([2, 4], dtype=np.int32)

    jpipe = JPipeline(num_points=N, num_objects=NUM_OBJ, use_pallas=True)
    shapes = jax.eval_shape(lambda k: jpipe.init(k, crop_hw=HW, batch=1),
                            jax.random.key(0))
    variables = _numpy_variables(rng, shapes)
    want = jpipe.estimate(variables, *map(jnp.asarray, (img, cloud, choose, obj)),
                          refine_iterations=2)

    pipe = DenseFusionPipeline(N, NUM_OBJ, device="cpu", seed=None)
    pipe.load_jax_variables(variables)
    got = pipe.estimate(*map(torch.from_numpy, (img, cloud, choose, obj)),
                        refine_iterations=2)
    assert got.quat.shape == (2, 4) and got.trans.shape == (2, 3)
    # PoseNet's outputs agree to 2e-3 (tests/test_torch_parity.py), the
    # best hypothesis is the same point in both, and two refiner steps of
    # f32 arithmetic in another order keep the pose within that tolerance
    np.testing.assert_allclose(got.quat.numpy(), np.asarray(want.quat), atol=2e-3)
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans), atol=2e-3)
    np.testing.assert_allclose(got.confidence.numpy(),
                               np.asarray(want.confidence), atol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(got.quat.numpy(), axis=-1), 1.0,
                               atol=1e-6)


def test_estimate_bf16_mode_runs_on_cpu():
    pipe = DenseFusionPipeline(16, 3, device="cpu", seed=3).cast(torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    img = torch.randn((2, 48, 48, 3), generator=g)
    cloud = torch.randn((2, 16, 3), generator=g) * 0.1
    choose = torch.randint(0, 48 * 48, (2, 16), generator=g)
    est = pipe.estimate(img, cloud, choose, torch.tensor([0, 2]))
    assert pipe.posenet.conv1_r.weight.dtype == torch.bfloat16
    # the dtypes of JAX's bf16 estimate: quaternion normalised and composed
    # in bf16, translation f32 (f32 cloud + bf16 offsets)
    assert est.quat.dtype == torch.bfloat16 and est.trans.dtype == torch.float32
    assert torch.isfinite(est.quat).all() and torch.isfinite(est.trans).all()
    # a bf16 unit quaternion after two bf16 compositions (not renormalised,
    # as in JAX): each component carries a few bf16 ulps (3.9e-3 in [0.5, 1))
    torch.testing.assert_close(est.quat.float().norm(dim=-1), torch.ones(2),
                               atol=3e-2, rtol=0)


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _set_tf32(cudnn, matmul):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


def record_tf32_in_first_conv(module):
    """Record both TF32 flags at every forward (and backward) of the first
    Conv2d of `module`; returns the list the hooks append to."""
    conv = next(m for m in module.modules() if isinstance(m, torch.nn.Conv2d))
    seen = []
    conv.register_forward_pre_hook(lambda m, a: seen.append(_tf32_flags()))
    conv.register_full_backward_pre_hook(lambda m, g: seen.append(_tf32_flags()))
    return seen


def test_f32_estimate_turns_tf32_off_and_restores_the_flags():
    saved = _tf32_flags()
    pipe = DenseFusionPipeline(16, 3, device="cpu", seed=3)
    seen = record_tf32_in_first_conv(pipe.posenet)
    g = torch.Generator().manual_seed(0)
    args = (torch.randn((2, 48, 48, 3), generator=g),
            torch.randn((2, 16, 3), generator=g) * 0.1,
            torch.randint(0, 48 * 48, (2, 16), generator=g), torch.tensor([0, 2]))
    try:
        _set_tf32(True, True)
        pipe.estimate(*args)
        assert seen and all(s == (False, False) for s in seen), seen
        assert _tf32_flags() == (True, True)
        # bf16 leaves the flags as the caller set them
        seen.clear()
        pipe.cast(torch.bfloat16).estimate(*args)
        assert seen and all(s == (True, True) for s in seen), seen
    finally:
        _set_tf32(*saved)


def test_seeded_weights_are_reproducible():
    a = DenseFusionPipeline(16, 3, device="cpu", seed=5)
    b = DenseFusionPipeline(16, 3, device="cpu", seed=5)
    c = DenseFusionPipeline(16, 3, device="cpu", seed=6)
    for (name, ta), tb, tc in zip(a.posenet.state_dict().items(),
                                  b.posenet.state_dict().values(),
                                  c.posenet.state_dict().values()):
        assert torch.equal(ta, tb), name
    assert not torch.equal(a.posenet.conv1_r.weight, c.posenet.conv1_r.weight)


def test_initial_pose_first_index_wins_ties():
    rng = np.random.default_rng(3)
    pred_r = rng.normal(size=(2, 6, 4)).astype(np.float32)
    pred_t = rng.normal(size=(2, 6, 3)).astype(np.float32)
    points = rng.normal(size=(2, 6, 3)).astype(np.float32)
    pred_c = np.full((2, 6, 1), 0.2, np.float32)
    pred_c[0, [1, 4]] = 0.9   # tie: index 1 wins
    pred_c[1, :] = 0.5        # all tied: index 0 wins
    q, t = initial_pose(*map(torch.from_numpy, (pred_r, pred_t, pred_c, points)))
    jq, jt = j_initial_pose(pred_r, pred_t, pred_c, points)
    np.testing.assert_allclose(t.numpy(), points[[0, 1], [1, 0]] +
                               pred_t[[0, 1], [1, 0]], atol=1e-6)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-6)


def test_import_hygiene_no_jax_no_reference_package():
    """The port (every module of it, the eval modules, CLIs, the
    real-data loaders, the segmentation slice and the parallel layer
    included), chip_smoke.py and the mesh tests' rank programs
    (tests/torch_parallel_ranks.py) import neither jax nor
    flax nor any plr2_tpu module, nor PIL or PyYAML (the card's host has
    neither),
    read no .msgpack checkpoint, and leave matplotlib unimported (the card's
    host has none; the report imports it inside the plotting function)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'plr2_tpu', 'PIL', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, plr2_tpu_torch, chip_smoke\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_parallel_ranks\n"
        "for m in pkgutil.walk_packages(plr2_tpu_torch.__path__, 'plr2_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'plr2_tpu', 'PIL', 'yaml') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "for m in ('ops.quant', 'ops.gather', 'eval', 'eval.metrics',\n"
        "          'eval.evaluator', 'eval.report', 'tools.eval_linemod',\n"
        "          'tools.infer', 'tools.eval_precision_modes',\n"
        "          'tools.plot_accuracy', 'native', 'data.codecs',\n"
        "          'data.frame_cache', 'data.linemod', 'data.ycb',\n"
        "          'data.posecnn', 'data.prefetch', 'models.segnet',\n"
        "          'train.seg_trainer', 'eval.segment', 'eval.full_pipeline',\n"
        "          'tools.train_segmentation', 'tools.segment_linemod',\n"
        "          'tools.eval_ycb', 'tools.journey_config5',\n"
        "          'parallel.mesh', 'parallel.tensor_parallel',\n"
        "          'parallel.point_parallel', 'parallel.pipeline_parallel',\n"
        "          'parallel.launch'):\n"
        "    assert 'plr2_tpu_torch.' + m in sys.modules, m\n"
        "assert 'matplotlib' not in sys.modules\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    sources = list((ROOT / "plr2_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    for path in sources:
        text = path.read_text()
        assert "msgpack" not in text, path
        assert "import jax" not in text and "from jax" not in text, path
        for mod in ("PIL", "yaml"):
            assert f"import {mod}" not in text and f"from {mod} " not in text, path
        assert "plr2_tpu." not in text.replace("plr2_tpu_torch", ""), path


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card, so the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DenseFusionPipeline(16, 3)
