"""The port's tensor, point and pipeline parallelism against the JAX package
and against the port's single-device functions:
`plr2_tpu_torch/parallel/{tensor,point,pipeline}_parallel.py` and
`BatchTrainer` with model_parallel = 2.

The layout functions (`tp_spec`, `tp_shardings`, `shard_variables`,
`sharded_param_count`) are pure and run here against JAX's on the 8
virtual CPU devices of tests/conftest.py. The steps run on 4 spawned gloo
CPU ranks (one launch for the file: `tests/torch_parallel_ranks.py`
`mesh_world`), as a (data, model) = (2, 2) mesh, a points axis of 4 (and
(data, points) = (2, 2)), and (pipe, unused) / (batch, pipe) = (2, 2)
meshes; every rank compares its mesh step with the single-device step
itself and returns the errors. Dropout is off on both sides, as in
tests/test_torch_port_train.py.

Tolerances:
- mesh step vs single-device step (the same function; the sums over the
  ranks reassociate): loss and dis 1e-5 relative; gradients as
  tests/test_torch_port_train.py `_grad_error` holds port against JAX
  (the colour encoder's f32 gradients 5e-2 in relative L2, every other
  tensor 1e-4 of its largest entry, the refine stage 1e-3); BatchNorm
  statistics |d| <= 1e-5 + 1e-5 |ref|; parameters after Adam 2 lr + 1e-6
  (JAX's 2.5e-4, tests/test_tensor_parallel.py:84-88). JAX's point test
  holds the loss to 1e-6 (tests/test_point_parallel.py:93-96): the port's
  point means sum over 4 ranks in f32 where JAX's pmean runs in one
  program, so 1e-5 here.
- point-parallel train steps vs JAX's single-device step: as port vs JAX
  in tests/test_torch_port_train.py, except the refine stage's gradients,
  held in relative L2 to 1e-3: on this batch the port's single-device
  refine step already differs from JAX's by up to 3.8e-3 of the largest
  entry of the refiner trunk's conv5 gradient (7.3e-4 in relative L2;
  f32 rounding through the chained iterations), which is not the mesh's.
- sp_chamfer: matched coordinates bit-equal to `nn_match` on the whole
  target; distances 1e-6 relative against JAX's sp_chamfer and the port's
  `nn_distance` (tests/test_point_parallel.py:53-55), gradients rtol 1e-5,
  atol 1e-6 (:62-64).
- estimates: the mesh's vs the port's single device, rtol 1e-4, atol 1e-5
  (tests/test_point_parallel.py:164-172; the tensor-parallel one 1e-5,
  tests/test_tensor_parallel.py:118-121; the pipelined one 1e-5,
  tests/test_pipeline_parallel.py:42-48); against JAX's estimate 2e-3,
  the port-vs-JAX estimate gate (PERF.md section 2).
- BatchTrainer (2, 2) vs one device over an epoch: loss 2e-4 relative,
  parameters 2.5e-4 (tests/test_tensor_parallel.py:150-155).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plr2_tpu.ops.knn import chamfer_min_distance as j_chamfer
from plr2_tpu.parallel import make_mesh as j_make_mesh
from plr2_tpu.parallel import make_train_step as j_make_train_step
from plr2_tpu.parallel import shard_variables as j_shard_variables
from plr2_tpu.parallel import sharded_param_count as j_sharded_param_count
from plr2_tpu.parallel.point_parallel import sp_chamfer as j_sp_chamfer
from plr2_tpu.parallel.tensor_parallel import tp_spec as j_tp_spec
from plr2_tpu.pipeline import DenseFusionPipeline as JPipeline
from plr2_tpu_torch.models import posenet_state_dict, refinenet_state_dict
from plr2_tpu_torch.parallel import (shard_variables, sharded_param_count,
                                     tp_shardings, tp_spec)
from plr2_tpu_torch.parallel.launch import spawn_ranks
from plr2_tpu_torch.parallel.mesh import Axis, Mesh
from test_torch_port_pipeline import _numpy_variables
from test_torch_port_train import _grad_error, _no_dropout
from test_torch_port_parallel import make_batch
import torch_parallel_ranks as ranks

NUM_OBJ, N, HW = 4, 32, 48
SYM, W, LR, ITERS = ranks.SYM, ranks.W, ranks.LR, ranks.ITERS


def chamfer_inputs():
    """pred (4, 96, 3) against 53 targets (padded to 56) and 64; exact ties
    across the 4 blocks: a query at the origin has targets at distance 1 in
    blocks 0, 2 and 3 (the first must win, its -0.0 kept), and a query on
    a target repeated in every block."""
    rng = np.random.default_rng(0)
    out = {f"m2_{m}": (rng.normal(size=(4, 96, 3)).astype(np.float32),
                       rng.normal(size=(m, 3)).astype(np.float32))
           for m in (53, 64)}
    t = (rng.normal(size=(8, 3)) * 5 + 10).astype(np.float32)
    t[1], t[5], t[6] = (1.0, -0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0)
    t[3] = t[7] = t[0]
    p = np.zeros((1, 4, 3), np.float32)
    p[0, 1:] = t[0]
    out["ties"] = (p, t)
    return out


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(4)
    jpipe = JPipeline(num_points=N, num_objects=NUM_OBJ)
    shapes = jax.eval_shape(lambda k: jpipe.init(k, crop_hw=HW, batch=1),
                            jax.random.key(0))
    variables = jax.tree_util.tree_map(np.asarray, _numpy_variables(rng, shapes))
    return dict(jpipe=jpipe, variables=variables, batch=make_batch(2))


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    outs = spawn_ranks(ranks.mesh_world, 4,
                       (setup["variables"], setup["batch"], N, NUM_OBJ,
                        chamfer_inputs(), str(tmp_path_factory.mktemp("mesh"))),
                       timeout=900)
    return outs


@pytest.fixture(scope="module")
def jax_single(setup):
    """JAX's single-device steps of each stage and its estimate."""
    b = {k: jnp.asarray(v) for k, v in setup["batch"].items() if k != "obj"}
    out = {}
    for iters in (0, ITERS):
        init_fn, step = j_make_train_step(setup["jpipe"], SYM, W, LR,
                                          refine_iterations=iters)
        with fnn.intercept_methods(_no_dropout):
            v, o, m = step(setup["variables"], init_fn(setup["variables"]), b,
                           jax.random.key(1))
        out[iters] = dict(vars=jax.device_get(v), mu=jax.device_get(o[0].mu),
                          met={k: float(x) for k, x in m.items()})
    est = setup["jpipe"].estimate(setup["variables"], b["img"], b["points"],
                                  b["choose"], b["idx"], refine_iterations=ITERS)
    out["estimate"] = jax.device_get(est._asdict())
    return out


# ---------------- tensor-parallel layout: pure, against JAX ----------------


def _mesh(model_index, size=2):
    """A (data, model) mesh seen from one rank, with no process group: the
    layout functions read only the model axis's size and index."""
    ax = Axis("model", list(range(size)), model_index, None)
    return Mesh(("data", "model"), (2, size), model_index, {"model": ax}, "gloo")


class _Key:
    def __init__(self, key):
        self.key = key


def _jspec(*names):
    return tuple(j_tp_spec(tuple(_Key(n) for n in names)))


def _to_torch_spec(jspec, kernel):
    """JAX's spec over a kernel (in, out) in torch's (out, in) layout,
    trailing replicated dimensions dropped."""
    s = list(jspec)
    if kernel:
        s = (s + [None, None])[:2][::-1]
    while s and s[-1] is None:
        s.pop()
    return tuple(s)


TABLE = [  # (JAX path, the port's name), tests/test_tensor_parallel.py:41-59
    (("posenet", "params", "conv1_r", "kernel"), "posenet.conv1_r.weight"),
    (("posenet", "params", "conv1_r", "bias"), "posenet.conv1_r.bias"),
    (("posenet", "params", "conv3_c", "kernel"), "posenet.conv3_c.weight"),
    (("posenet", "params", "feat", "conv5", "kernel"), "posenet.feat.conv5.weight"),
    (("refiner", "params", "conv1_t", "kernel"), "refiner.conv1_t.weight"),
    (("posenet", "params", "conv2_t", "kernel"), "posenet.conv2_t.weight"),
    (("posenet", "params", "conv2_t", "bias"), "posenet.conv2_t.bias"),
    (("posenet", "params", "conv4_r", "kernel"), "posenet.conv4_r.weight"),
    (("posenet", "params", "feat", "conv6", "kernel"), "posenet.feat.conv6.weight"),
    (("refiner", "params", "conv2_r", "kernel"), "refiner.conv2_r.weight"),
    (("posenet", "params", "cnn", "feats", "conv1", "kernel"),
     "posenet.cnn.model.feats.conv1.weight"),
    (("posenet", "params", "feat", "conv1", "kernel"), "posenet.feat.conv1.weight"),
    (("refiner", "params", "conv3_r", "kernel"), "refiner.conv3_r.weight"),
    (("posenet", "batch_stats", "cnn", "bn1", "mean"),
     "posenet.cnn.model.feats.bn1.running_mean"),
]


@pytest.mark.parametrize("jpath,name", TABLE, ids=[n for _, n in TABLE])
def test_tp_spec_table_matches_jax(jpath, name):
    assert tp_spec(name) == _to_torch_spec(_jspec(*jpath),
                                           jpath[-1] == "kernel")


def test_tp_divisibility_guard():
    bad = {"posenet": {"conv1_r.weight": torch.zeros(10, 6, 1)}}
    with pytest.raises(ValueError, match="not divisible"):
        tp_shardings(_mesh(0, 4), bad)
    assert tp_shardings(_mesh(0, 2), bad)["posenet"]["conv1_r.weight"] == ("model",)


def _port_tree(variables):
    return {"posenet": posenet_state_dict(variables["posenet"]),
            "refiner": refinenet_state_dict(variables["refiner"])}


def test_sharded_param_count_matches_jax(setup):
    want = j_sharded_param_count(setup["variables"])
    assert want > 1_000_000
    assert sharded_param_count(_port_tree(setup["variables"])) == want


def test_shard_variables_keeps_jax_slices(setup):
    """Each model rank's slices equal the shards JAX's shard_variables puts
    on that mesh column, converted to upstream names and layouts."""
    variables = setup["variables"]
    jmesh = j_make_mesh(4, ("data", "model"), shape=(2, 2))
    placed = j_shard_variables(jmesh, variables)
    whole = _port_tree(variables)
    for j in range(2):
        dev = jmesh.devices[0, j]

        def local(leaf):
            return next(np.asarray(s.data) for s in leaf.addressable_shards
                        if s.device == dev)
        shards = jax.tree_util.tree_map(local, placed)
        want = _port_tree(shards)
        got = shard_variables(_mesh(j), whole)
        for net in ("posenet", "refiner"):
            assert set(got[net]) == set(want[net])
            for name, t in want[net].items():
                assert torch.equal(got[net][name], t), (net, name, j)


# ---------------- the mesh steps ----------------


def _check_errors(errs, refine, tol=1e-5):
    loss, ref = errs["loss"]
    np.testing.assert_allclose(loss, ref, rtol=tol)
    dis, ref = errs["dis"]
    np.testing.assert_allclose(dis, ref, rtol=tol)
    for name, (max_rel, rel_l2, _, _) in errs["grads"].items():
        if not refine and name.startswith("cnn."):
            assert rel_l2 <= 5e-2, (name, rel_l2)
        else:
            assert max_rel <= (1e-3 if refine else 1e-4), (name, max_rel)
    for name, (_, _, max_abs, worst) in errs["state"].items():
        if name.endswith(("running_mean", "running_var")):
            assert worst <= 1e-5, (name, worst)
        elif not name.endswith("num_batches_tracked"):
            assert max_abs <= 2 * LR + 1e-6, (name, max_abs)


@pytest.mark.parametrize("iters", [0, ITERS], ids=["stage1", "refine"])
def test_tensor_parallel_step_matches_single_device(world, iters):
    for out in world:
        _check_errors(out["tp"][f"step{iters}"], refine=iters > 0)
    # the data ranks of one model column hold one state
    for a, b in ((0, 2), (1, 3)):
        assert (world[a]["tp"][f"step{iters}"]["digest"]
                == world[b]["tp"][f"step{iters}"]["digest"])


def test_tensor_parallel_mesh_layout_matches_jax(world):
    jmesh = j_make_mesh(4, ("data", "model"), shape=(2, 2))
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r, out in enumerate(world):
        i, j = np.argwhere(ids == r)[0]
        assert out["tp"]["coords"] == {"data": i, "model": j}
        assert out["tp"]["axes"] == {"data": tuple(ids[:, j]),
                                     "model": tuple(ids[i])}
        assert out["tp"]["heads_kernel_free"]
        assert "not divisible by model axis size 2" in out["tp"]["guard"]


def test_tensor_parallel_inference_matches_single_device(world, jax_single):
    for out in world:
        got, single = out["tp"]["estimate"]
        for k in ("quat", "trans", "confidence"):
            np.testing.assert_allclose(got[k], single[k], atol=1e-5, err_msg=k)
            np.testing.assert_allclose(got[k], jax_single["estimate"][k],
                                       atol=2e-3, err_msg=k)


@pytest.mark.parametrize("iters", [0, ITERS], ids=["stage1", "refine"])
def test_point_parallel_step_matches_single_device(world, iters):
    for out in world:
        _check_errors(out["sp"][f"step{iters}"], refine=iters > 0)
    assert len({out["sp"][f"step{iters}"]["digest"] for out in world}) == 1


def test_point_and_data_parallel_step_matches_single_device(world):
    for out in world:
        _check_errors(out["sp"]["composed"], refine=False)
    assert len({out["sp"]["composed"]["digest"] for out in world}) == 1


@pytest.mark.parametrize("iters", [0, ITERS], ids=["stage1", "refine"])
def test_point_parallel_step_matches_jax(world, jax_single, iters):
    j = jax_single[iters]
    refine = iters > 0
    key, to_sd = (("refiner", refinenet_state_dict) if refine
                  else ("posenet", posenet_state_dict))
    extra = {} if refine else {"batch_stats": j["vars"][key]["batch_stats"]}
    jgrads = to_sd({"params": j["mu"], **extra})
    got = world[0]["sp"][f"step{iters}"]["result"]
    np.testing.assert_allclose(got["loss"], j["met"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["dis"], j["met"]["dis"], rtol=1e-5)
    for name, g in got["grads"].items():
        g_port = torch.from_numpy(g).double()
        g_jax = jgrads[name].double() / (1 - ranks.BETA1)
        if refine:
            rel = float((g_port - g_jax).norm() / g_jax.norm().clamp(min=1e-300))
            assert rel <= 1e-3, (name, rel)
        else:
            _grad_error(name, g_port, g_jax, refine)


def test_point_parallel_inference_matches(world, jax_single):
    for out in world:
        got, single = out["sp"]["estimate"]
        for k in ("quat", "trans", "confidence"):
            np.testing.assert_allclose(got[k], single[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
            np.testing.assert_allclose(got[k], jax_single["estimate"][k],
                                       atol=2e-3, err_msg=k)


@pytest.mark.parametrize("key", ["m2_53", "m2_64", "ties"])
def test_sp_chamfer_matches_nn_match_and_jax(world, key):
    pred, target = chamfer_inputs()[key]
    jmesh = j_make_mesh(4, ("points",))
    jp, jt = jnp.asarray(pred), jnp.asarray(target)
    j_dis = np.asarray(j_sp_chamfer(jmesh, jp, jt))
    j_grad = np.asarray(jax.grad(lambda p: jnp.sum(j_chamfer(p, jt)))(jp))
    for out in world:
        c = out["sp"]["chamfer"][key]
        assert c["matched_equal"]
        np.testing.assert_allclose(c["dis"], c["single"], rtol=1e-6, atol=0)
        np.testing.assert_allclose(c["dis"], j_dis, rtol=1e-6, atol=0)
        np.testing.assert_allclose(c["grad"], c["single_grad"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(c["grad"], j_grad, rtol=1e-5, atol=1e-6)
        assert c["target_grad"] is None or not c["target_grad"].any()
        assert np.isfinite(c["grad"]).all()
        if key == "ties":
            np.testing.assert_array_equal(c["dis"], [[1.0, 0.0, 0.0, 0.0]])


# ---------------- pipeline parallelism ----------------


@pytest.mark.parametrize("case", ["micro1", "micro2", "micro4", "composed"])
def test_pp_estimate_matches_single_device(world, jax_single, case):
    for out in world:
        got, single = out["pp"][case], out["pp"]["single"]
        for k in ("quat", "trans"):
            np.testing.assert_allclose(got[k], single[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
            np.testing.assert_allclose(got[k], jax_single["estimate"][k],
                                       atol=2e-3, err_msg=k)
        np.testing.assert_allclose(got["confidence"], single["confidence"],
                                   rtol=1e-6, atol=1e-7)


def test_pp_refine_two_stages_of_two_iterations(world):
    for out in world:
        got, ref = out["pp"]["four"]["got"], out["pp"]["four"]["ref"]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


# ---------------- BatchTrainer over (data, model) ----------------


def test_batch_trainer_tensor_parallel_epoch_matches_single_device(world):
    single = world[0]["single_trainer"]
    for out in world:
        t = out["trainer"]
        np.testing.assert_allclose(t["train_loss"], single["train_loss"],
                                   rtol=2e-4)
        for name, v in single["posenet"].items():
            np.testing.assert_allclose(t["posenet"][name], v, atol=2.5e-4,
                                       err_msg=name)


def test_batch_trainer_tensor_parallel_checkpoints_whole_weights(world):
    r0 = world[0]["trainer"]
    assert r0["saves"] == 1 and r0["logs"] >= 1
    assert all(o["trainer"]["saves"] == 0 and o["trainer"]["logs"] == 0
               for o in world[1:])
    # the restore put the whole weights back into every rank's slices
    assert all(o["trainer"]["restored_equal"] for o in world)
    # Adam was rebuilt over the slices
    sizes = {o["trainer"]["optimizer_params"] for o in world}
    assert len(sizes) == 1
    assert sizes.pop() < sum(v.size for v in single_posenet(world).values())


def single_posenet(world):
    return {k: v for k, v in world[0]["single_trainer"]["posenet"].items()
            if "running" not in k and "num_batches" not in k}


def test_collectives_were_counted(world):
    for out in world:
        assert out["collectives"]["all_reduce"] > 50
