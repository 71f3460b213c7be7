"""Rank programs of the port's mesh tests (tests/test_torch_port_parallel*.py).

`plr2_tpu_torch.parallel.launch.spawn_ranks` runs one of the `*_world`
functions below in each spawned rank, on gloo CPU process groups; each
runs every case of its test file and returns numpy results, which the
test file holds against JAX (computed in the pytest process) and against
the port's single-device functions. This module imports no jax: a rank
process must not start it.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from plr2_tpu_torch import DenseFusionPipeline
from plr2_tpu_torch.parallel import (batch_sharding, make_inference_step,
                                     make_mesh, make_train_step, replicated)
from plr2_tpu_torch.parallel import mesh as mesh_mod

SYM, W, LR, ITERS = (1,), 0.015, 1e-4, 2
BETA1 = 0.9


def numpy_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(numpy_tree(v) for v in x)
    return x


def pipeline(variables, n, num_obj):
    """The port's pipeline on the CPU with the JAX variables, dropout off."""
    pipe = DenseFusionPipeline(n, num_obj, device="cpu", seed=None)
    pipe.load_jax_variables(variables)
    pipe.posenet.cnn.model.dropout_rates = (0.0, 0.0, 0.0)
    return pipe


def tensors(batch):
    return {k: v if k == "obj" else torch.from_numpy(np.asarray(v))
            for k, v in batch.items()}


def step_result(step, met):
    """Loss, dis, each parameter's gradient (Adam's first moment / (1 -
    beta1)), the network's state after the step, and the other network's."""
    net = step.network
    grads = {n: step.optimizer.state[p]["exp_avg"] / (1 - BETA1)
             for n, p in net.named_parameters()}
    pipe = step.pipe
    return numpy_tree({"loss": float(met["loss"]), "dis": float(met["dis"]),
                       "grads": grads,
                       "posenet": pipe.posenet.state_dict(),
                       "refiner": pipe.refiner.state_dict()})


def train_steps(variables, batch, n, num_obj, mesh, sym_slots=None):
    """One stage-1 and one refine-stage step from the same weights."""
    out = {}
    for iters in (0, ITERS):
        pipe = pipeline(variables, n, num_obj)
        step = make_train_step(pipe, SYM, W, LR, refine_iterations=iters,
                               mesh=mesh, sym_slots=sym_slots)
        met = step(tensors(batch), torch.Generator().manual_seed(0))
        out[iters] = step_result(step, met)
    return out


def estimate(pipe, batch, mesh=None):
    est = make_inference_step(pipe, ITERS, mesh)(
        *(torch.from_numpy(np.asarray(batch[k]))
          for k in ("img", "points", "choose", "idx")))
    return numpy_tree(est._asdict())


# ---------------- data parallelism (2 ranks) ----------------


def _trainer_cfg(dp, mp=1, batch_size=8):
    from plr2_tpu_torch.config import (DatasetConfig, ModelConfig,
                                       PipelineConfig, TrainConfig)
    return PipelineConfig(
        dataset=DatasetConfig(name="synthetic", num_points=64, num_objects=2,
                              num_mesh_points=64, sym_list=(1,), crop_size=48),
        model=ModelConfig(num_points=64, num_objects=2),
        train=TrainConfig(batch_size=batch_size, nepoch=1),
        data_parallel=dp, model_parallel=mp)


def trainer_epoch(dp, mp=1, tmp=None):
    """One BatchTrainer epoch (tests/test_parallel.py:150-184's setup) and,
    on a mesh, one `fit` epoch with checkpoints (whose files only rank 0
    may write) and a restore of the best one."""
    from plr2_tpu_torch.data import SyntheticPoseDataset
    from plr2_tpu_torch.train import BatchTrainer, CheckpointManager

    ds = SyntheticPoseDataset(num_frames=2, num_objects=2, model_points=64,
                              num_points=64, seed=9)
    tr = BatchTrainer(_trainer_cfg(dp, mp), device="cpu")
    state = tr.init_state()
    state, info = tr.train_epoch(state, ds, torch.Generator().manual_seed(1))
    out = {"train_loss": info["train_loss"], "posenet": _whole_state(tr)}
    if tmp is None:
        return out
    logs, saves = [], []
    ckpt = CheckpointManager(os.path.join(tmp, "ckpt"))

    def save(s, d):
        saves.append(d)
        ckpt.save(s, d)
    state = tr.fit(state, ds, ds, torch.Generator().manual_seed(2), epochs=1,
                   log_fn=logs.append, checkpoint_fn=save)
    out.update(logs=len(logs), saves=len(saves), epoch=state.epoch,
               best=state.best_test)
    # every rank restores the best checkpoint into its own pipeline
    before = _whole_state(tr)
    torch.distributed.barrier()
    tr.restore_into(ckpt, state, "best")
    out["restored_equal"] = all(np.array_equal(before[k], v)
                                for k, v in _whole_state(tr).items())
    out["optimizer_params"] = sum(
        p.numel() for g in state.optimizer.param_groups for p in g["params"])
    return out


def trainer_stop(tmp):
    """`fit` over 2 epochs of 2 batches where only rank 1's stop_fn turns
    True, at its second call (the boundary after the first step)."""
    from plr2_tpu_torch.data import SyntheticPoseDataset
    from plr2_tpu_torch.train import BatchTrainer, CheckpointManager

    ds = SyntheticPoseDataset(num_frames=2, num_objects=2, model_points=64,
                              num_points=64, seed=9)
    tr = BatchTrainer(_trainer_cfg(2, batch_size=2), device="cpu")
    rank = torch.distributed.get_rank()
    calls, logs = [], []

    def stop():
        calls.append(rank == 1 and len(calls) >= 1)
        return calls[-1]
    ckpt = CheckpointManager(os.path.join(tmp, "stop"))
    state = tr.fit(tr.init_state(), ds, ds, torch.Generator().manual_seed(2),
                   epochs=2, log_fn=logs.append,
                   save_last_fn=lambda s: ckpt.save(s, s.best_test, tag="last"),
                   stop_fn=stop)
    torch.distributed.barrier()
    last = ckpt.restore("last")
    return {"epoch": state.epoch, "calls": calls, "logs": logs,
            "last_epoch": None if last is None else last["meta"]["epoch"]}


def _whole_state(tr):
    """The trainer's PoseNet state as numpy, whole under a model axis."""
    with tr._whole_weights():
        return numpy_tree(tr.pipe.posenet.state_dict())


def serve_frames(mesh, n_frames):
    """run_frames over the mesh and unsharded, on F make_scene crops."""
    from plr2_tpu_torch.data.synthetic import make_scene
    from plr2_tpu_torch.serving import FrameEstimator
    frames = []
    for seed in range(n_frames):
        frame, models = make_scene(num_objects=2, model_points=64, seed=seed)
        intr = dict(frame.intrinsics)
        intr["cx"] -= 160
        intr["cy"] -= 120
        ids = np.array([1, 2])
        frames.append((
            np.ascontiguousarray(frame.color[120:360, 160:480]),
            frame.depth[120:360, 160:480].astype(np.float32),
            frame.label[120:360, 160:480].astype(np.int32), ids,
            np.stack([models[i] for i in ids]).astype(np.float32),
            np.array([intr[k] for k in ("cx", "cy", "fx", "fy", "cam_scale")],
                     np.float32)))
    stacked = [np.stack(x) for x in zip(*frames)]
    seeds = np.arange(n_frames) + 5
    pipe = DenseFusionPipeline(64, 2, device="cpu", seed=0)
    kw = dict(canvas=120, img_h=240, img_w=320, refine_iterations=1)
    sharded = FrameEstimator(pipe, mesh=mesh, **kw).run_frames(*stacked, seeds)
    whole = FrameEstimator(pipe, **kw).run_frames(*stacked, seeds)
    return numpy_tree({"mesh": sharded._asdict(), "whole": whole._asdict()})


def synced_bn_f64(mesh):
    """Train-mode PoseNet in float64 on a batch of 4 (dropout off): each
    parameter's gradient of a fixed cotangent, summed over the ranks, and
    the BatchNorm statistics, with the batch split over `mesh`'s data axis
    (statistics summed over it) or whole (mesh None)."""
    from plr2_tpu_torch.models import PoseNet
    from plr2_tpu_torch.models.resnet import synced_statistics
    from plr2_tpu_torch.models.weights import init_random_
    g = torch.Generator().manual_seed(0)
    b, n, hw = 4, 16, 48
    img = torch.randn((b, hw, hw, 3), generator=g, dtype=torch.float64)
    cloud = torch.randn((b, n, 3), generator=g, dtype=torch.float64) * 0.1
    choose = torch.randint(0, hw * hw, (b, n), generator=g)
    obj = torch.tensor([0, 2, 1, 3])
    cots = [torch.randn((b, n, d), generator=g, dtype=torch.float64)
            for d in (4, 3, 1)]
    net = PoseNet(n, 4)
    init_random_(net, torch.Generator().manual_seed(1))
    net = net.double().train()
    net.cnn.model.dropout_rates = (0.0, 0.0, 0.0)
    ax = None if mesh is None else mesh.axis("data")
    if ax is not None:
        rows = ax.block(b)
        img, cloud, choose, obj = img[rows], cloud[rows], choose[rows], obj[rows]
        cots = [c[rows] for c in cots]
    with synced_statistics(net, ax):
        outs = net(img, cloud, choose, obj)
    sum((o * c).sum() for o, c in zip(outs[:3], cots)).backward()
    grads = [p.grad for p in net.parameters()]
    if ax is not None:
        ax.all_reduce_tensors_(grads)
    return numpy_tree({"grads": dict(zip([k for k, _ in net.named_parameters()],
                                         grads)),
                       "stats": {k: v for k, v in net.state_dict().items()
                                 if "running" in k}})


def dp_world(variables, batch, n, num_obj, tmp):
    """Every case of tests/test_torch_port_parallel.py, on 2 ranks."""
    mesh = make_mesh(2)
    ax = mesh.axis("data")
    rank = mesh.rank
    x = torch.full((3,), float(rank + 1))
    out = {"rank": rank, "axis": (ax.ranks, ax.index, ax.size),
           "block": batch_sharding(mesh)(torch.arange(8)).tolist(),
           "replicated": replicated(mesh)(x).tolist(),
           "gather": ax.all_gather(torch.tensor([-0.0, float(rank)])).tolist()}
    # exactness of the gather: -0.0 and NaN keep their bits in every slot
    probe = torch.tensor([-0.0, float("nan"), 1e-45, -3.5])
    got = ax.all_gather(probe)
    out["gather_bits"] = bool(torch.equal(
        got.view(torch.int32), probe.view(torch.int32).expand(2, -1)))
    out["bn_f64"] = synced_bn_f64(mesh)
    out["steps"] = train_steps(variables, batch, n, num_obj, mesh)
    out["steps_compact"] = train_steps(variables, batch, n, num_obj, mesh,
                                       sym_slots=1)[0]
    pipe = pipeline(variables, n, num_obj)
    out["estimate"] = estimate(pipe, batch, mesh)
    counts = dict(mesh_mod.launches)
    out["trainer"] = trainer_epoch(2, tmp=tmp)
    out["stop"] = trainer_stop(tmp)
    out["serve"] = serve_frames(mesh, 2)
    out["collectives"] = counts
    if rank == 0:  # the single-device twins, on the global batch
        out["single_bn_f64"] = synced_bn_f64(None)
        out["single_steps"] = train_steps(variables, batch, n, num_obj, None)
        out["single_estimate"] = estimate(pipe, batch)
        out["single_trainer"] = trainer_epoch(1)
    return out


# ---------------- tensor, point and pipeline parallelism (4 ranks) ----------


def _digest(module) -> str:
    """A hash of a module's state (equal state, equal digest)."""
    import hashlib
    h = hashlib.sha1()
    for v in module.state_dict().values():
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _errors(got, ref):
    """Per tensor: (max |d| / max |ref|, |d| / |ref| in L2, max |d|,
    max(|d| - 1e-5 |ref|)), d = got - ref, in float64."""
    out = {}
    for name, r in ref.items():
        r = torch.as_tensor(r).double()
        d = torch.as_tensor(got[name]).double() - r
        scale = float(r.abs().max()) if r.numel() else 0.0
        out[name] = (float(d.abs().max()) / max(scale, 1e-300),
                     float(d.norm()) / max(float(r.norm()), 1e-300),
                     float(d.abs().max()), float((d.abs() - 1e-5 * r.abs()).max()))
    return out


def _whole_grads(step, mesh):
    """The network's gradients, with the tensor-parallel slices gathered
    into whole tensors (every rank must call)."""
    from plr2_tpu_torch.parallel.tensor_parallel import tp_spec
    net_name = "refiner" if step.refine_iterations else "posenet"
    out = {}
    for name, p in step.network.named_parameters():
        g = step.optimizer.state[p]["exp_avg"] / (1 - BETA1)
        spec = tp_spec(f"{net_name}.{name}")
        if "model" in spec:
            g = torch.cat(list(mesh.axis("model").all_gather(g)),
                          dim=spec.index("model"))
        out[name] = g
    return out


def _step_errors(mesh, step, met, single, whole=None):
    """A mesh step against its single-device twin's step_result `single`."""
    from plr2_tpu_torch.parallel.tensor_parallel import gathered
    grads = _whole_grads(step, mesh) if whole else {
        n: step.optimizer.state[p]["exp_avg"] / (1 - BETA1)
        for n, p in step.network.named_parameters()}
    with gathered(mesh, step.pipe) if whole else contextlib.nullcontext():
        state = {"posenet": step.pipe.posenet.state_dict(),
                 "refiner": step.pipe.refiner.state_dict()}
        net = "refiner" if step.refine_iterations else "posenet"
        errs = {"grads": _errors(grads, single["grads"]),
                "state": _errors({k: v.float() for k, v in state[net].items()},
                                 {k: v.astype(np.float32) for k, v in
                                  single[net].items()}),
                "digest": _digest(getattr(step.pipe, net))}
    errs.update(loss=(float(met["loss"]), single["loss"]),
                dis=(float(met["dis"]), single["dis"]))
    return errs


def tp_cases(variables, batch, n, num_obj):
    """(data, model) = (2, 2): the train steps, inference, BatchTrainer."""
    from plr2_tpu_torch.parallel import shard_pipeline
    mesh = make_mesh(4, ("data", "model"), shape=(2, 2))
    single = train_steps(variables, batch, n, num_obj, None)
    out = {"coords": mesh.coords,
           "axes": {a: mesh.axis(a).ranks for a in ("data", "model")}}
    for iters in (0, ITERS):
        pipe = shard_pipeline(mesh, pipeline(variables, n, num_obj))
        step = make_train_step(pipe, SYM, W, LR, refine_iterations=iters,
                               mesh=mesh)
        met = step(tensors(batch), torch.Generator().manual_seed(0))
        out[f"step{iters}"] = _step_errors(mesh, step, met, single[iters],
                                           whole=True)
    pipe = shard_pipeline(mesh, pipeline(variables, n, num_obj))
    out["heads_kernel_free"] = pipe.posenet.model_axis is not None
    out["estimate"] = (estimate(pipe, batch, mesh),
                       estimate(pipeline(variables, n, num_obj), batch))
    try:
        from plr2_tpu_torch.parallel import tp_shardings
        tp_shardings(mesh, {"posenet": {"conv1_r.weight": torch.zeros(5, 10, 1)}})
        out["guard"] = None
    except ValueError as e:
        out["guard"] = str(e)
    return out


def sp_cases(variables, batch, n, num_obj, chamfer):
    """points = 4 (and data x points = 2 x 2): sp_chamfer, the inference and
    train steps."""
    from plr2_tpu_torch.ops.knn import nn_match, nn_distance
    from plr2_tpu_torch.parallel import (make_sp_inference_step,
                                         make_sp_train_step, sp_chamfer)
    from plr2_tpu_torch.parallel.point_parallel import sp_match
    mesh = make_mesh(4, ("points",))
    out = {"chamfer": {}}
    for key, (pred, target) in chamfer.items():
        p = torch.from_numpy(pred).requires_grad_(True)
        t = torch.from_numpy(target).requires_grad_(True)
        dis = sp_chamfer(mesh, p, t)
        dis.sum().backward()
        q = p.detach().reshape(-1, 3)
        matched = sp_match(mesh, q, t.detach())
        whole = nn_match(q, t.detach())
        p2 = p.detach().clone().requires_grad_(True)
        nn_distance(p2, t.detach()).sum().backward()
        out["chamfer"][key] = numpy_tree(dict(
            dis=dis, grad=p.grad, target_grad=t.grad,
            matched_equal=bool(torch.equal(matched.view(torch.int32),
                                           whole.view(torch.int32))),
            single=nn_distance(p.detach(), t.detach()), single_grad=p2.grad))
    pipe = pipeline(variables, n, num_obj)
    b = tensors(batch)
    est = make_sp_inference_step(pipe, mesh, ITERS)(
        b["img"], b["points"], b["choose"], b["idx"])
    out["estimate"] = (numpy_tree(est._asdict()), estimate(pipe, batch))
    single = train_steps(variables, batch, n, num_obj, None)
    for iters in (0, ITERS):
        pipe = pipeline(variables, n, num_obj)
        step = make_sp_train_step(pipe, mesh, SYM, W, LR,
                                  refine_iterations=iters)
        met = step(tensors(batch), torch.Generator().manual_seed(0))
        out[f"step{iters}"] = _step_errors(mesh, step, met, single[iters])
        if mesh.rank == 0:  # for the comparison with JAX
            out[f"step{iters}"]["result"] = step_result(step, met)
    composed = make_mesh(4, ("data", "points"), shape=(2, 2))
    pipe = pipeline(variables, n, num_obj)
    step = make_sp_train_step(pipe, composed, SYM, W, LR, data_axis="data")
    met = step(tensors(batch), torch.Generator().manual_seed(0))
    out["composed"] = _step_errors(composed, step, met, single[0])
    return out


def pp_cases(variables, batch, n, num_obj):
    """pipe = 2 on (pipe, unused) = (2, 2) and (batch, pipe) = (2, 2)."""
    from plr2_tpu_torch.parallel import make_pp_estimate_step, make_pp_refine
    from plr2_tpu_torch.refine.iterative import initial_pose, iterative_refine
    pipe = pipeline(variables, n, num_obj)
    b = tensors(batch)
    args = [b[k] for k in ("img", "points", "choose", "idx")]
    ring = make_mesh(4, ("pipe", "unused"), shape=(2, 2))
    out = {"single": estimate(pipe, batch)}
    for micro in (1, 2, 4):
        est = make_pp_estimate_step(pipe, ring, num_micro=micro)(*args)
        out[f"micro{micro}"] = numpy_tree(est._asdict())
    composed = make_mesh(4, ("batch", "pipe"), shape=(2, 2))
    est = make_pp_estimate_step(pipe, composed, num_micro=2,
                                batch_axis="batch")(*args)
    out["composed"] = numpy_tree(est._asdict())
    # 2 stages x 2 iterations = the 4-iteration protocol
    with torch.no_grad():
        pred_r, pred_t, pred_c, emb = pipe.run_posenet(*args)
        q0, t0 = initial_pose(pred_r, pred_t, pred_c, b["points"])
        ref = iterative_refine(pipe.run_refiner, b["points"], emb, b["idx"],
                               q0, t0, 4)
        split = [x.reshape((2, -1) + tuple(x.shape[1:]))
                 for x in (b["points"], emb, b["idx"], q0, t0)]
        got = make_pp_refine(pipe.run_refiner, ring, 2, iters_per_stage=2)(*split)
    out["four"] = numpy_tree({"got": [g.reshape((-1,) + tuple(g.shape[2:]))
                                      for g in got], "ref": list(ref)})
    return out


def mesh_world(variables, batch, n, num_obj, chamfer, tmp):
    """Every case of tests/test_torch_port_parallel_axes.py, on 4 ranks."""
    out = {"tp": tp_cases(variables, batch, n, num_obj),
           "sp": sp_cases(variables, batch, n, num_obj, chamfer),
           "pp": pp_cases(variables, batch, n, num_obj),
           "trainer": trainer_epoch(2, 2, tmp=tmp)}
    if torch.distributed.get_rank() == 0:
        out["single_trainer"] = trainer_epoch(1)
    out["collectives"] = dict(mesh_mod.launches)
    return out
