"""The port's mesh and data parallelism against the JAX package and against
its own single-device step: `plr2_tpu_torch/parallel/mesh.py`,
`make_train_step(mesh=)`, `make_inference_step(mesh=)`, `BatchTrainer`
with data_parallel = 2, `FrameEstimator(mesh=).run_frames`, and the
training CLI under torchrun.

The port's side runs on 2 spawned gloo CPU ranks (one launch for the whole
file: `tests/torch_parallel_ranks.py` `dp_world`); the JAX side on 2 of
the 8 virtual CPU devices of tests/conftest.py. Both take the same numpy
weights and batch; dropout is off on both sides (flax's Dropout
intercepted, the port's rates 0), as in tests/test_torch_port_train.py.

Tolerances:
- port mesh vs port single device (one function; only the sums over the
  ranks reassociate): loss and dis 1e-5 relative (JAX's own mesh test
  holds 1e-4, tests/test_parallel.py:51-54); BatchNorm statistics 1e-5;
  gradients as tests/test_torch_port_train.py `_grad_error` holds port
  against JAX (the colour encoder's f32 gradients are ill-conditioned at
  these sizes: 5e-2 in relative L2, every other tensor 1e-4 of its largest
  entry, the refine stage 1e-3); parameters after Adam within 2 lr + 1e-6
  (a near-zero gradient whose sum flips sign moves a weight by 2 lr:
  JAX's 2.5e-4 at lr 1e-4, tests/test_parallel.py:176-184);
- port mesh vs JAX mesh: the same as port vs JAX in
  tests/test_torch_port_train.py;
- inference: 1e-5 (tests/test_tensor_parallel.py:118-121) between the
  port's mesh and single-device estimates; 2e-3 against JAX (the
  estimate's port-vs-JAX gate, PERF.md section 2);
- run_frames over the mesh and unsharded: 5e-5 (a PoseNet batch of F / 2
  frames against one of F, as tests/test_torch_port_serving.py holds
  run_frames against single runs); valid / oversized equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plr2_tpu.parallel import batch_sharding as j_batch_sharding
from plr2_tpu.parallel import make_inference_step as j_make_inference_step
from plr2_tpu.parallel import make_mesh as j_make_mesh
from plr2_tpu.parallel import make_train_step as j_make_train_step
from plr2_tpu.parallel import shard_batch as j_shard_batch
from plr2_tpu.pipeline import DenseFusionPipeline as JPipeline
from plr2_tpu_torch.models import posenet_state_dict, refinenet_state_dict
from plr2_tpu_torch.parallel.launch import spawn_ranks
from test_torch_port_pipeline import _numpy_variables
from test_torch_port_train import _grad_error, _no_dropout
import torch_parallel_ranks as ranks

ROOT = Path(__file__).resolve().parents[1]
NUM_OBJ, N, HW, M, B = 4, 32, 48, 16, 4
SYM, W, LR, ITERS = ranks.SYM, ranks.W, ranks.LR, ranks.ITERS


def make_batch(seed=1, idx=(1, 0, 2, 1)):
    rng = np.random.default_rng(seed)
    mp = rng.normal(size=(B, M, 3)) * 0.05
    batch = dict(img=rng.normal(size=(B, HW, HW, 3)),
                 points=rng.normal(size=(B, N, 3)) * 0.1,
                 choose=rng.integers(0, HW * HW, size=(B, N)),
                 target=mp + rng.normal(size=(B, 1, 3)) * 0.05,
                 model_points=mp, idx=np.array(idx))
    batch = {k: v.astype(np.int32 if v.dtype.kind == "i" else np.float32)
             for k, v in batch.items()}
    batch["obj"] = tuple(int(i) for i in idx)
    return batch


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(4)
    jpipe = JPipeline(num_points=N, num_objects=NUM_OBJ)
    shapes = jax.eval_shape(lambda k: jpipe.init(k, crop_hw=HW, batch=1),
                            jax.random.key(0))
    variables = jax.tree_util.tree_map(np.asarray, _numpy_variables(rng, shapes))
    batch = make_batch()
    outs = spawn_ranks(ranks.dp_world, 2,
                       (variables, batch, N, NUM_OBJ,
                        str(tmp_path_factory.mktemp("dp"))))
    return dict(jpipe=jpipe, variables=variables, batch=batch, outs=outs)


@pytest.fixture(scope="module")
def jax_mesh_steps(world):
    """JAX's make_train_step(mesh=make_mesh(2)) of each stage."""
    mesh = j_make_mesh(2)
    jb = {k: jnp.asarray(v) for k, v in world["batch"].items() if k != "obj"}
    out = {}
    for iters in (0, ITERS):
        init_fn, step = j_make_train_step(world["jpipe"], SYM, W, LR,
                                          refine_iterations=iters, mesh=mesh)
        with fnn.intercept_methods(_no_dropout):
            v, o, m = step(world["variables"], init_fn(world["variables"]),
                           j_shard_batch(mesh, jb), jax.random.key(1))
        out[iters] = dict(vars=jax.device_get(v), mu=jax.device_get(o[0].mu),
                          met={k: float(x) for k, x in m.items()})
    return out


# ---------------- the mesh ----------------


def test_mesh_layout_and_batch_blocks_match_jax(world):
    jmesh = j_make_mesh(2)
    ids = [d.id for d in jmesh.devices.reshape(-1)]
    x = jnp.arange(8)
    shards = {s.device.id: s.index[0] for s in
              jax.device_put(x, j_batch_sharding(jmesh)).addressable_shards}
    for out in world["outs"]:
        r = out["rank"]
        assert out["axis"] == ((0, 1), ids.index(r), 2)
        want = list(range(8))[shards[ids[r]]]
        assert out["block"] == want, (r, out["block"], want)


def test_replicated_and_exact_gather(world):
    for out in world["outs"]:
        assert out["replicated"] == [1.0, 1.0, 1.0]
        assert out["gather"] == [[-0.0, 0.0], [-0.0, 1.0]]
        assert np.signbit(out["gather"][0][0])
        assert out["gather_bits"]
        assert out["collectives"]["all_reduce"] > 0
        assert out["collectives"]["all_gather"] > 0
        assert out["collectives"]["broadcast"] == 1


# ---------------- the data-parallel step ----------------


def _close_steps(got, ref, refine):
    """`got` against `ref` (step_result dicts): loss, dis, gradients, BN
    statistics, parameters after Adam (module docstring)."""
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["dis"], ref["dis"], rtol=1e-5)
    for name, g in ref["grads"].items():
        _grad_error(name, torch.from_numpy(got["grads"][name]).double(),
                    torch.from_numpy(g).double(), refine)
    net = "refiner" if refine else "posenet"
    for name, t in ref[net].items():
        if name.endswith("num_batches_tracked"):
            assert got[net][name] == t
        elif name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[net][name], t, rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(got[net][name], t, rtol=0,
                                       atol=2 * LR + 1e-6, err_msg=name)


@pytest.mark.parametrize("iters", [0, ITERS], ids=["stage1", "refine"])
def test_mesh_step_matches_single_device_step(world, iters):
    single = world["outs"][0]["single_steps"][iters]
    for out in world["outs"]:
        _close_steps(out["steps"][iters], single, refine=iters > 0)
    # every rank holds the same state after the step
    a, b = (o["steps"][iters] for o in world["outs"])
    for net in ("posenet", "refiner"):
        for name, t in a[net].items():
            np.testing.assert_array_equal(b[net][name], t, err_msg=name)


def test_synced_batchnorm_is_the_single_device_function_in_float64(world):
    """In float64, where the colour encoder's gradients are well
    conditioned, the BatchNorm statistics summed over 2 ranks give the
    single-device gradients and running statistics to 1e-10 of each
    tensor's largest entry (measured 2e-14 on the CPU): the f32 gap of
    `_grad_error` is rounding, not the mesh."""
    single = world["outs"][0]["single_bn_f64"]
    for out in world["outs"]:
        got = out["bn_f64"]
        for kind in ("grads", "stats"):
            for name, ref in single[kind].items():
                err = np.abs(got[kind][name] - ref).max() / max(np.abs(ref).max(), 1e-300)
                assert err <= 1e-10, (kind, name, err)


def test_compact_branch_on_a_mesh_matches_the_mixed_one(world):
    """sym_slots=1: each rank's block (idx 1, 0 | 2, 1) holds one symmetric
    sample, so both compact; the loss is the mixed branch's."""
    for out in world["outs"]:
        _close_steps(out["steps_compact"], out["steps"][0], refine=False)


@pytest.mark.parametrize("iters", [0, ITERS], ids=["stage1", "refine"])
def test_mesh_step_matches_jax_mesh_step(world, jax_mesh_steps, iters):
    j = jax_mesh_steps[iters]
    refine = iters > 0
    key, to_sd = (("refiner", refinenet_state_dict) if refine
                  else ("posenet", posenet_state_dict))
    extra = ({} if refine else
             {"batch_stats": j["vars"][key]["batch_stats"]})
    jgrads = to_sd({"params": j["mu"], **extra})
    want = to_sd(j["vars"][key])
    got = world["outs"][0]["steps"][iters]
    np.testing.assert_allclose(got["loss"], j["met"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["dis"], j["met"]["dis"], rtol=1e-5)
    for name, g in got["grads"].items():
        _grad_error(name, torch.from_numpy(g).double(),
                    jgrads[name].double() / (1 - ranks.BETA1), refine)
    for name, t in want.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key][name], t.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_mesh_inference_matches_jax_and_single_device(world):
    jmesh = j_make_mesh(2)
    b = world["batch"]
    infer = j_make_inference_step(world["jpipe"], refine_iterations=ITERS,
                                  mesh=jmesh)
    jest = infer(world["variables"],
                 *(jax.device_put(jnp.asarray(b[k]), j_batch_sharding(jmesh))
                   for k in ("img", "points", "choose", "idx")))
    single = world["outs"][0]["single_estimate"]
    for out in world["outs"]:
        est = out["estimate"]
        for k in ("quat", "trans", "confidence"):
            np.testing.assert_allclose(est[k], single[k], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(est["quat"], np.asarray(jest.quat), atol=2e-3)
        np.testing.assert_allclose(est["trans"], np.asarray(jest.trans), atol=2e-3)


# ---------------- BatchTrainer, serving ----------------


def test_batch_trainer_dp2_epoch_matches_dp1(world):
    """tests/test_parallel.py:150-184: one epoch, train loss 2e-4 relative,
    parameters 2.5e-4."""
    single = world["outs"][0]["single_trainer"]
    for out in world["outs"]:
        t = out["trainer"]
        np.testing.assert_allclose(t["train_loss"], single["train_loss"],
                                   rtol=2e-4)
        for name, v in single["posenet"].items():
            np.testing.assert_allclose(t["posenet"][name], v, atol=2.5e-4,
                                       err_msg=name)


def test_batch_trainer_mesh_fit_writes_and_logs_on_rank0_only(world):
    r0, r1 = (o["trainer"] for o in world["outs"])
    assert r0["epoch"] == r1["epoch"] == 1
    assert np.isfinite(r0["best"]) and r0["best"] == r1["best"]
    assert r0["saves"] == 1 and r1["saves"] == 0
    assert r0["logs"] >= 1 and r1["logs"] == 0
    assert r0["restored_equal"] and r1["restored_equal"]


def test_batch_trainer_mesh_stops_every_rank_together(world):
    """Only rank 1's stop_fn turns True, at the batch boundary after the
    first step: both ranks stop there (neither is left in a collective),
    the epoch goes back, and rank 0 writes `last`."""
    r0, r1 = (o["stop"] for o in world["outs"])
    assert r0["calls"] == [False, False] and r1["calls"] == [False, True]
    assert r0["epoch"] == r1["epoch"] == 0
    assert r0["last_epoch"] == r1["last_epoch"] == 0
    assert len(r0["logs"]) == 1 and "interrupt requested" in r0["logs"][0]
    assert r1["logs"] == []


def test_run_frames_over_a_mesh_matches_the_unsharded_call(world):
    for out in world["outs"]:
        got, want = out["serve"]["mesh"], out["serve"]["whole"]
        assert got["quat"].shape == (2, 2, 4)
        np.testing.assert_array_equal(got["valid"], want["valid"])
        np.testing.assert_array_equal(got["oversized"], want["oversized"])
        assert want["valid"].all()
        for k in ("quat", "trans", "confidence"):
            np.testing.assert_allclose(got[k], want[k], atol=5e-5, err_msg=k)


# ---------------- the CLI under torchrun ----------------

CLI = ["-m", "plr2_tpu_torch.tools.train", "--synthetic", "--cpu",
       "--nepoch", "1", "--num_points", "48", "--mesh_points", "32",
       "--synthetic_frames", "2", "--batch_size", "4"]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    return env


def test_train_cli_under_torchrun_data_parallel(tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", *CLI, "--data_parallel", "2",
         "--outf", str(out), "--log_dir", str(tmp_path / "logs")],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (out / "linemod" / "last.pt").is_file()
    log = (tmp_path / "logs" / "train_linemod.log").read_text()
    assert "data_parallel=2" in log and log.count("epoch 1:") == 1


def test_train_cli_refuses_a_world_that_does_not_match(tmp_path):
    proc = subprocess.run(
        [sys.executable, *CLI, "--data_parallel", "2", "--outf",
         str(tmp_path / "o"), "--log_dir", str(tmp_path / "l")],
        capture_output=True, text=True, timeout=120, env=_env(), cwd=tmp_path)
    assert proc.returncode != 0
    assert "torchrun" in proc.stderr and "the world size is 1" in proc.stderr
