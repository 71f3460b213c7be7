"""The port's curriculum Trainer against the JAX package's Trainer: one
stage-1 epoch and one refine-stage epoch from the same weights and the
same samples (JAX's `iterate_samples`, converted to torch, fed to both
trainers through `_sample_iter`), the curriculum switches through `fit`,
and the per-sample and batched test epochs.

Dropout is off on both sides (flax's `nn.Dropout` intercepted to return
its input; the port's rates set to 0), and the samples carry no noise, so
both trainers compute one function. The JAX trainer runs
`use_pallas=False` with the dense decoder (tests/test_models.py pins the
shared parameter tree). The fixture's frames are chosen so that every
crop snaps to 120 x 120, so each JAX function compiles once.
"""

import dataclasses

import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from plr2_tpu import config as j_config
from plr2_tpu.data import loader as j_loader
from plr2_tpu.pipeline import DenseFusionPipeline as JPipeline
from plr2_tpu.train import trainer as j_trainer
from plr2_tpu_torch import DenseFusionPipeline
from plr2_tpu_torch import config as t_config
from plr2_tpu_torch.data.preprocess import Sample
from plr2_tpu_torch.models import posenet_state_dict, refinenet_state_dict
from plr2_tpu_torch.parallel import adam
from plr2_tpu_torch.train import Trainer
from test_torch_port_pipeline import _numpy_variables

torch.set_num_threads(2)

N, NUM_OBJ, MESH, CROP = 96, 4, 128, 120
SYM, LR, W = (1,), 1e-4, 0.015
TRAIN_SEED, TEST_SEED = 0, 2  # every crop of these frames snaps to 120 x 120


def configs(**train):
    """The same configuration in both packages' dataclasses."""
    out = []
    for m in (j_config, t_config):
        out.append(m.PipelineConfig(
            dataset=m.DatasetConfig(name="synthetic", num_points=N,
                                    num_objects=NUM_OBJ, num_mesh_points=MESH,
                                    sym_list=SYM, add_noise=False,
                                    crop_size=CROP),
            model=m.ModelConfig(num_points=N, num_objects=NUM_OBJ),
            train=m.TrainConfig(**{"batch_size": 2, "refine_iterations": 2,
                                   "lr": LR, "w": W, **train})))
    return out


def no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def to_torch(s) -> Sample:
    return Sample(points=torch.from_numpy(np.array(s.points)),
                  choose=torch.from_numpy(np.array(s.choose)).long(),
                  img=torch.from_numpy(np.array(s.img)),
                  target=torch.from_numpy(np.array(s.target)),
                  model_points=torch.from_numpy(np.array(s.model_points)),
                  idx=torch.tensor(int(s.idx)))


def samples(seed, key):
    ds = j_loader.SyntheticPoseDataset(num_frames=2, num_objects=2,
                                       model_points=MESH, num_points=N,
                                       seed=seed)
    js = list(j_loader.iterate_samples(ds, jax.random.key(key), N))
    assert all(s.img.shape[:2] == (CROP, CROP) for s in js)
    return js, [to_torch(s) for s in js]


def jax_variables():
    jpipe = JPipeline(num_points=N, num_objects=NUM_OBJ)
    shapes = jax.eval_shape(lambda k: jpipe.init(k, crop_hw=CROP, batch=1),
                            jax.random.key(0))
    return jpipe, _numpy_variables(np.random.default_rng(9), shapes)


def port_pipe(variables):
    pipe = DenseFusionPipeline(N, NUM_OBJ, device="cpu", seed=None)
    pipe.load_jax_variables(variables)
    pipe.posenet.cnn.model.dropout_rates = (0.0, 0.0, 0.0)
    return pipe


class RecordingTrainer(Trainer):
    """The port's Trainer, recording each window's summed gradients and its
    parameters before and after the optimizer step. With `forced` (JAX's
    parameters at each window's start, as state dicts), each window after
    the first starts from JAX's parameters: Adam amplifies the f32 noise
    of the colour encoder's ill-conditioned gradients (see `_grad_tol`),
    so without this the two trainers drift apart by ~1e-4 after one step,
    and a later window would test that drift instead of its own
    computation."""

    forced = None

    def stage_step(self, state):
        step = super().stage_step(state)
        apply = step.apply
        self.windows = []

        def recorded():
            net = step.network
            grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
            before = {n: p.detach().clone() for n, p in net.named_parameters()}
            apply()
            after = {n: p.detach().clone() for n, p in net.named_parameters()}
            self.windows.append((grads, before, after))
            k = len(self.windows)
            if self.forced is not None and k < len(self.forced):
                with torch.no_grad():
                    for n, p in net.named_parameters():
                        p.copy_(self.forced[k][n])
        step.apply = recorded
        return step


def run_jax_epoch(jtr, variables, js, refine):
    """One JAX train_epoch; returns (state, per-sample (loss, dis), window
    gradient sums, the parameters at each window's start)."""
    grads, params, per_sample = [], [], []

    def recording(tx):
        def update(g, s, p=None):
            grads.append(jax.device_get(g))
            params.append(jax.device_get(p))
            return tx.update(g, s, p)
        return optax.GradientTransformation(tx.init, update)

    jtr._make_opt = lambda lr: recording(optax.adam(lr))
    name = "refine_grads" if refine else "posenet_grads"
    orig = getattr(jtr, name)

    def grads_fn(*a, **k):
        out = orig(*a, **k)
        per_sample.append((float(out[2]), float(out[3])))
        return out
    setattr(jtr, name, grads_fn)
    jtr._sample_iter = lambda *a, **k: iter(js)
    target = "refiner" if refine else "posenet"
    state = j_trainer.TrainState(
        variables=jax.tree_util.tree_map(jnp.asarray, variables),
        opt_state=optax.adam(LR).init(variables[target]["params"]),
        lr=LR, w=W, refine_started=refine)
    with fnn.intercept_methods(no_dropout):
        state, _ = jtr.train_epoch(state, None, jax.random.key(3))
    return state, per_sample, grads, params


def as_state_dicts(trees, refine, batch_stats):
    if refine:
        return [refinenet_state_dict({"params": t}) for t in trees]
    return [posenet_state_dict({"params": t, "batch_stats": batch_stats})
            for t in trees]


@pytest.fixture(scope="module")
def epochs():
    jpipe, variables = jax_variables()
    js, ts = samples(TRAIN_SEED, 5)
    jcfg, tcfg = configs()
    out = {"variables": variables, "samples": ts}
    for refine in (False, True):
        jtr = j_trainer.Trainer(jcfg, pipe=jpipe)
        jstate, jlosses, jgrads, jparams = run_jax_epoch(jtr, variables, js,
                                                         refine)
        bs = variables["posenet"]["batch_stats"]
        tr = RecordingTrainer(tcfg, pipe=port_pipe(variables))
        tr.forced = as_state_dicts(jparams, refine, bs)
        tr._sample_iter = lambda *a, **k: iter(ts)
        state = tr.init_state()
        if refine:
            state.refine_started = True
            state.optimizer = adam(tr.pipe.refiner, LR)
        state, info = tr.train_epoch(state, None, torch.Generator().manual_seed(0))
        out[refine] = dict(jstate=jstate, jlosses=jlosses,
                           jgrads=as_state_dicts(jgrads, refine, bs),
                           jparams=tr.forced,
                           trainer=tr, state=state, info=info)
    return out


def _grad_tol(name, refine):
    """(norm, tolerance) of a window's gradient against JAX's. Stage 1's
    colour-encoder gradients (`cnn.*`) are ill-conditioned in f32 at these
    sizes: relative L2 5e-2, as tests/test_torch_port_train.py
    `_grad_error` holds them (measured here up to 3.3e-2). The first head
    layer (`conv1_{r,t,c}`, 1408 -> 640 under a ReLU) takes each point's
    full feature row in its gradient, and a ReLU unit whose pre-activation
    is within f32 noise of 0 may open on one side and not the other: a
    few rows differ whole, so it is held in relative L2 at 5e-3 (measured
    8.8e-4; as a share of its largest entry up to 5.6e-3). Every other
    stage-1 tensor: 1e-4 of its largest entry (measured 5.2e-5); the refine
    stage 1e-3 (measured 1.6e-4)."""
    if refine:
        return "max", 1e-3
    if name.startswith("cnn."):
        return "l2", 5e-2
    if name.split(".")[0] in ("conv1_r", "conv1_t", "conv1_c"):
        return "l2", 5e-3
    return "max", 1e-4


def _check_grads(run, refine):
    windows = run["trainer"].windows
    assert len(run["jgrads"]) == len(windows)
    for want, (got, _, _) in zip(run["jgrads"], windows):
        for name, g in got.items():
            ref = want[name].double()
            err = g.double() - ref
            kind, tol = _grad_tol(name, refine)
            if kind == "l2":
                rel = float(err.norm() / ref.norm().clamp(min=1e-300))
            else:
                rel = float(err.abs().max() / ref.abs().max().clamp(min=1e-300))
            assert rel <= tol, (name, rel)


def _check_adam(run):
    """Adam lives across the epoch's windows: each window's step is optax's
    Adam step for the port's gradients of every window so far (one
    optimizer, its moments kept from window to window), applied to the
    parameters the window started from."""
    windows = run["trainer"].windows
    tx = optax.adam(LR)
    opt = tx.init({n: jnp.asarray(v.numpy()) for n, v in windows[0][1].items()})
    for grads, before, after in windows:
        p = {n: jnp.asarray(v.numpy()) for n, v in before.items()}
        upd, opt = tx.update({n: jnp.asarray(v.numpy()) for n, v in grads.items()},
                             opt, p)
        want = optax.apply_updates(p, upd)
        for n, v in after.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[n]),
                                       rtol=3e-7, atol=1e-8, err_msg=n)
            assert not torch.equal(v, before[n]) or bool((grads[n] == 0).all()), n
    # the first step, from the same parameters on both sides: the port's
    # update is within what Adam makes of the measured gradient gap (the
    # criterion of tests/test_torch_port_train.py); at step 1 the update is
    # lr g / (|g| + eps), so a gap d moves it by at most lr d / (|g| - d)
    # where |g| > d, and never by more than 2 lr
    grads, before, after = windows[0]
    for n, g in grads.items():
        g_jax, b0 = run["jgrads"][0][n].double(), before[n].double()
        d = float((g.double() - g_jax).abs().max())
        margin = (g_jax.abs() - d).clamp(min=0)
        bound = torch.where(margin > 0, LR * d / margin.clamp(min=1e-300),
                            torch.full_like(margin, 2 * LR)).clamp(max=2 * LR)
        d_jax = run["jparams"][1][n].double() - b0
        slack = 1e-7 + 2.4e-7 * b0.abs()
        assert bool(((after[n].double() - b0 - d_jax).abs() <= bound + slack).all()), n
    state = run["state"].optimizer.state
    net = {id(p) for g in run["state"].optimizer.param_groups for p in g["params"]}
    assert {int(state[p]["step"]) for p in state if id(p) in net} == {len(windows)}


def _check_losses(run):
    got = list(zip(run["info"]["losses"], run["info"]["dists"]))
    assert len(got) == len(run["jlosses"]) == 4
    for (tl, td), (jl, jd) in zip(got, run["jlosses"]):
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_allclose(td, jd, rtol=1e-4)


def test_stage1_epoch_losses_match_jax(epochs):
    _check_losses(epochs[False])
    assert len(epochs[False]["trainer"].windows) == 2  # 4 samples, window 2


def test_stage1_epoch_window_gradients_match_jax(epochs):
    _check_grads(epochs[False], refine=False)


def test_stage1_epoch_bn_statistics_match_jax(epochs):
    run = epochs[False]
    want = posenet_state_dict(jax.device_get(run["jstate"].variables["posenet"]))
    got = run["trainer"].pipe.posenet.state_dict()
    start = posenet_state_dict(epochs["variables"]["posenet"])
    seen = 0
    for name, ref in want.items():
        if "running" in name:
            d = (got[name] - ref).abs() - 1e-4 * ref.abs()
            assert float(d.max()) <= 1e-5, name
            seen += 1
            # batch-1 train-mode BN moved them
            assert not torch.equal(got[name], start[name]), name
    assert seen > 0


def test_stage1_epoch_adam_steps_once_per_window(epochs):
    _check_adam(epochs[False])


def test_refine_epoch_matches_jax(epochs):
    run = epochs[True]
    _check_losses(run)
    # window = batch_size // refine_iterations = 1: four optimizer steps
    assert len(run["trainer"].windows) == 4
    _check_grads(run, refine=True)
    _check_adam(run)
    # PoseNet frozen: its parameters and statistics are untouched
    before = posenet_state_dict(epochs["variables"]["posenet"])
    for name, t in run["trainer"].pipe.posenet.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(t, before[name]), name


def test_partial_window_drops_gradients_and_keeps_bn(epochs):
    """3 samples, window 2: one optimizer step; the third sample's BN
    update stays and its gradients are dropped."""
    ts = epochs["samples"][:3]
    _, tcfg = configs()
    tr = RecordingTrainer(tcfg, pipe=port_pipe(epochs["variables"]))
    tr._sample_iter = lambda *a, **k: iter(ts)
    state = tr.init_state()
    bn0 = tr.bn_snapshot()
    state, info = tr.train_epoch(state, None, torch.Generator().manual_seed(0))
    assert len(tr.windows) == 1 and len(info["losses"]) == 3
    assert all(p.grad is None for p in tr.pipe.posenet.parameters())
    counts = {int(b) for b, b0 in zip(tr.bn_snapshot(), bn0) if b.dim() == 0}
    assert counts == {3}  # num_batches_tracked: three batch-1 updates


# ---------------- curriculum ----------------


def test_curriculum_switches_match_jax():
    """fit with scripted test distances (margins forced so both switches
    fire): the same switch epochs, lr, w and best_test as JAX's fit, and
    Adam rebuilt for the right network at each switch."""
    script = [0.02, 0.018, 0.015, 0.0149, 0.012, 0.02]
    jcfg, tcfg = configs(decay_margin=0.016, refine_margin=0.013, nepoch=6)
    logs = {}
    jtr = j_trainer.Trainer(jcfg, pipe=JPipeline(num_points=8, num_objects=2))
    tr = Trainer(tcfg, pipe=DenseFusionPipeline(8, 2, device="cpu"))
    jvars = {"posenet": {"params": {"k": jnp.zeros(3)}, "batch_stats": {}},
             "refiner": {"params": {"k": jnp.zeros(2)}}}
    jstate = j_trainer.TrainState(variables=jvars,
                                  opt_state=optax.adam(LR).init(jvars["posenet"]["params"]),
                                  lr=LR, w=W)
    state = tr.init_state()
    for name, trainer, st in (("jax", jtr, jstate), ("port", tr, state)):
        dis = iter(script)
        trainer.train_epoch = lambda s, ds, k: (s, {
            "train_loss": 0.0, "train_dis": 0.0, "seconds": 0.0,
            "interrupted": False})
        trainer.test_epoch = lambda s, ds, k: next(dis)
        seen = []
        key = jax.random.key(0) if name == "jax" else None
        trainer.fit(st, None, None, key, epochs=6, log_fn=seen.append)
        logs[name] = seen
    assert logs["jax"] == logs["port"]
    assert (state.lr, state.w, state.best_test) == (jstate.lr, jstate.w,
                                                    jstate.best_test)
    assert state.decay_started and state.refine_started and state.epoch == 6
    # the decay fired at epoch 3 (0.015 < 0.016), the refine switch at 5
    assert "refine=False" in logs["port"][3] and "refine=True" in logs["port"][4]
    opt_params = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert opt_params == {id(p) for p in tr.pipe.refiner.parameters()}
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(LR * 0.3)


# ---------------- test epochs ----------------


@pytest.mark.parametrize("mode", ["per_sample", "batched"])
def test_test_epoch_matches_jax(mode, epochs):
    """Per-sample loop at stage 1 (ADD-S scored for the symmetric object)
    and the batched loop in the refine stage (2 refiner iterations, a
    cycle-padded tail: 4 samples, batch 3)."""
    refine = mode == "batched"
    jpipe, variables = jax_variables()
    js, ts = samples(TEST_SEED, 6)
    train = dict(batched_test=refine, batch_size=3 if refine else 2)
    jcfg, tcfg = configs(**train)
    jtr = j_trainer.Trainer(jcfg, pipe=jpipe)
    jtr._sample_iter = lambda *a, **k: iter(js)
    jstate = j_trainer.TrainState(variables=variables, opt_state=None, lr=LR,
                                  w=W, refine_started=refine)
    want = jtr.test_epoch(jstate, None, jax.random.key(0))
    tr = Trainer(tcfg, pipe=port_pipe(variables))
    tr._sample_iter = lambda *a, **k: iter(ts)
    state = dataclasses.replace(tr.init_state(), refine_started=refine)
    got = tr.test_epoch(state, None, torch.Generator())
    np.testing.assert_allclose(got, want, rtol=1e-4)
