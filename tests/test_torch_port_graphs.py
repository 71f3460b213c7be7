"""The port's training in the form a CUDA graph captures, on the CPU:

- `pose_loss`'s four ADD-S branches, each forced by the host's `n_sym` and
  `max_sym_slots`, against JAX's `pose_loss(max_sym_slots=K)` (values and
  gradients), and against each other bit for bit (the unselected branch's
  zero gradients change no sum);
- `refine_loss`'s select form against the gathered form it replaced;
- the dropout masks drawn on the host before the forward against the
  generator's draws inside it (the same forward, bit for bit);
- `TrainStep.program` (the capturable gradient program) run eagerly,
  against the per-sample loop, bit for bit (tests/test_torch_port_fused.py
  holds it in float64 against JAX's `make_fused_window_grads`);
- `GradientGraphs` with an eager stand-in for the capture: keys, replays,
  the warm-up's side effects undone, and a FusedTrainer / BatchTrainer
  epoch through it equal to the eager epoch.

The capture itself runs only on the card (chip_smoke.py's `train graphs`
phase). 80 px crops, 64 points, windows of 4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plr2_tpu.losses.add_loss import pose_loss as j_pose_loss
from plr2_tpu_torch import DenseFusionPipeline
from plr2_tpu_torch import config as t_config
from plr2_tpu_torch.losses import pose_loss, refine_loss
from plr2_tpu_torch.losses.add_loss import is_symmetric, loss_branch
from plr2_tpu_torch.models.resnet import batchnorm_buffers
from plr2_tpu_torch.ops.knn import nn_distance, safe_norm
from plr2_tpu_torch.parallel.data_parallel import (BATCH_KEYS, TrainStep,
                                                   window_sample)
from plr2_tpu_torch.train import BatchTrainer, FusedTrainer, graphs
from plr2_tpu_torch.train.graphs import GradientGraphs
from test_torch_port_losses import SYM as LOSS_SYM
from test_torch_port_losses import _case

torch.set_num_threads(2)

NUM_OBJ, N, HW, M, WIN = 5, 64, 80, 32, 4
SYM, W = (4,), 0.015
IDX = (1, 4, 4, 0)  # two of the window's four samples symmetric


# ---------------- the loss's branches ----------------

# batch of 4: (idx, n_sym given to the port, max_sym_slots) -> the branch
# JAX's lax.switch takes on the same batch with the same max_sym_slots
BRANCHES = {"add_all": ([0, 2, 4, 0], 0, None),
            "adds_all": ([1, 3, 1, 3], 4, None),
            "mixed": ([1, 0, 2, 3], 2, None),
            "compact": ([1, 0, 2, 0], 1, 3)}  # a slot left for a non-sym row


def _port_loss(case, idx, n_sym, slots):
    leaves = {k: torch.from_numpy(case[k]).requires_grad_(True)
              for k in ("pred_r", "pred_t", "pred_c")}
    out = pose_loss(leaves["pred_r"], leaves["pred_t"], leaves["pred_c"],
                    torch.from_numpy(case["target"]),
                    torch.from_numpy(case["model_points"]), torch.tensor(idx),
                    torch.from_numpy(case["points"]), w=W, refine=False,
                    sym_list=LOSS_SYM, max_sym_slots=slots, n_sym=n_sym)
    return out, torch.autograd.grad(out.loss, list(leaves.values()))


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_pose_loss_branch_matches_jax_and_the_mixed_form(branch):
    idx, n_sym, slots = BRANCHES[branch]
    assert loss_branch(4, n_sym, False, LOSS_SYM, slots) == branch
    case = _case(3)

    def f(pr, pt, pc):
        o = j_pose_loss(pr, pt, pc, case["target"], case["model_points"],
                        jnp.asarray(idx, jnp.int32), case["points"], w=W,
                        refine=False, sym_list=LOSS_SYM, max_sym_slots=slots)
        return o.loss, o
    (_, want), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        case["pred_r"], case["pred_t"], case["pred_c"])
    got, grads = _port_loss(case, idx, n_sym, slots)
    for name in ("loss", "dis", "new_points", "new_target"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-7)
    # the same function as the mixed form, bit for bit: the branch that a
    # row does not take contributes exact zeros to every gradient
    mixed, mgrads = _port_loss(case, idx, None, None)
    assert torch.equal(got.loss, mixed.loss) and torch.equal(got.dis, mixed.dis)
    for g, mg in zip(grads, mgrads):
        assert torch.equal(g, mg)


def test_loss_branch_is_jax_case_select():
    """JAX: 0 symmetric -> add_all, all -> adds_all, else compact when
    0 < K < B and n_sym <= K, else mixed; the refine stage is ADD only.
    The port adds n_sym=None (unknown on the host) -> mixed."""
    sym = (1,)
    assert loss_branch(8, 0, False, sym, 4) == "add_all"
    assert loss_branch(8, 8, False, sym, 4) == "adds_all"
    assert loss_branch(8, 3, False, sym, 4) == "compact"
    assert loss_branch(8, 4, False, sym, 4) == "compact"
    assert loss_branch(8, 5, False, sym, 4) == "mixed"
    assert loss_branch(8, 3, False, sym, 8) == "mixed"  # K = B: off
    assert loss_branch(8, 3, False, sym, None) == "mixed"
    assert loss_branch(8, None, False, sym, 4) == "mixed"
    assert loss_branch(8, None, True, sym, 4) == "add_all"
    assert loss_branch(8, None, False, (), 4) == "add_all"
    assert loss_branch(1, 1, False, sym, None) == "adds_all"


def test_refine_loss_select_form_equals_the_gathered_form():
    """`refine_loss` now computes ADD-S on every row and selects; the form
    it replaced gathered the symmetric rows (`nonzero`) and copied their
    ADD-S back. Values and gradients are bit-equal."""
    case = _case(9)
    idx = torch.tensor([1, 0, 2, 3])
    args = [torch.from_numpy(case[k]) for k in ("target", "model_points")]

    def leaves():
        return (torch.from_numpy(case["pred_r"][:, :1].copy()).requires_grad_(True),
                torch.from_numpy(case["pred_t"][:, :1].copy()).requires_grad_(True))

    pr, pt = leaves()
    new = refine_loss(pr, pt, *args, idx, torch.from_numpy(case["points"]),
                      sym_list=LOSS_SYM)
    g_new = torch.autograd.grad(new.dis.sum(), [pr, pt])

    pr, pt = leaves()
    out = refine_loss(pr, pt, *args, idx, torch.from_numpy(case["points"]),
                      sym_list=())  # ADD on every row, and the same pred
    target, mp = args
    from plr2_tpu_torch.geometry.quaternion import (normalize_quaternion,
                                                    quat_to_matrix_df)
    from plr2_tpu_torch.losses.add_loss import rotate_rows
    rot = quat_to_matrix_df(normalize_quaternion(pr[:, 0]))
    pred = rotate_rows(mp, rot.transpose(-1, -2)) + pt[:, 0][:, None, :]
    dis = safe_norm(pred - target).mean(-1)
    rows = torch.nonzero(is_symmetric(idx, LOSS_SYM)).flatten()
    adds = nn_distance(pred[rows][:, None], target[rows]).mean((-2, -1))
    old = dis.index_copy(0, rows, adds)
    g_old = torch.autograd.grad(old.sum(), [pr, pt])
    assert torch.equal(new.dis, old)
    assert not torch.equal(out.dis, old)  # the symmetric rows changed
    for a, b in zip(g_new, g_old):
        assert torch.equal(a, b)


# ---------------- dropout masks drawn on the host ----------------


def _pipe():
    return DenseFusionPipeline(N, NUM_OBJ, device="cpu", seed=3)


def _window(seed=0, n=WIN):
    """A window of n samples (numpy-made), two of the first four
    symmetric."""
    rng = np.random.default_rng(seed)
    mp = rng.normal(size=(WIN, M, 3)) * 0.05
    w = dict(img=rng.normal(size=(WIN, HW, HW, 3)),
             points=rng.normal(size=(WIN, N, 3)) * 0.1,
             # repeated pixels, as a small mask's wrap-padding gives
             choose=rng.integers(0, HW * HW // 8, size=(WIN, N)),
             target=mp + rng.normal(size=(WIN, 1, 3)) * 0.05,
             model_points=mp, idx=np.array(IDX))
    out = {k: torch.from_numpy(v.astype(np.int64 if v.dtype.kind == "i"
                                        else np.float32))
           for k, v in w.items()}
    out["obj"] = IDX
    return {k: v[:n] for k, v in out.items()}


def test_host_drawn_masks_give_the_generators_forward():
    """`draw_dropout_masks` draws with the forward's calls (drop_1, drop_2a,
    drop_2b, one (B, 1, 1, C) draw each): PoseNet's train-mode forward on
    the masks equals the forward that draws from the generator, and a
    window's masks (sample by sample) equal its per-sample draws."""
    pipe = _pipe()
    net = pipe.posenet.train()
    win = _window()
    args = [win[k] for k in ("img", "points", "choose", "idx")]
    with torch.no_grad():
        a = net(*args, torch.Generator().manual_seed(5))
        masks = net.cnn.model.draw_dropout_masks(WIN, torch.Generator().manual_seed(5))
        b = net(*args, None, masks)
    assert [m.shape for m in masks] == [(WIN, 1, 1, c) for c in (1024, 256, 64)]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    step = TrainStep(pipe, SYM, W)
    gen = torch.Generator().manual_seed(6)
    each = [step.dropout_masks(1, gen) for _ in range(WIN)]
    window = step.dropout_masks(WIN, torch.Generator().manual_seed(6), window=True)
    for layer, m in enumerate(window):
        assert torch.equal(m, torch.cat([e[layer] for e in each]))
    assert TrainStep(pipe, SYM, W, refine_iterations=2).dropout_masks(WIN, gen) is None


# ---------------- the capturable program, run eagerly ----------------


def _state(pipe, net):
    return ({n: p.grad.clone() for n, p in net.named_parameters()
             if p.grad is not None},
            [b.clone() for b in batchnorm_buffers(pipe.posenet)])


def _assert_same(a, b):
    (ga, bna), (gb, bnb) = a, b
    assert ga.keys() == gb.keys()
    for n in ga:
        assert torch.equal(ga[n], gb[n]), n
    for x, y in zip(bna, bnb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("iters", [0, 2], ids=["stage1", "refine"])
def test_window_program_equals_the_per_sample_loop_bit_for_bit(iters):
    """`TrainStep.program(window=True)`, the graph's program, run eagerly:
    the batch-1 `mixed` ADD-S form on every sample, masks drawn first,
    gradients zeroed in place. Against the per-sample loop (`accumulate`,
    which runs ADD or ADD-S alone, by the host object id), dropout on:
    summed gradients, BN statistics, losses and dis bit-equal. Stale
    gradients in `.grad` are zeroed by the program."""
    runs = []
    for form in ("program", "loop"):
        pipe = _pipe()
        step = TrainStep(pipe, SYM, W, refine_iterations=iters)
        win = _window()
        gen = torch.Generator().manual_seed(7)
        if form == "program":
            for p in step.network.parameters():
                p.grad = torch.full_like(p, 3.0)
            losses, dists = step.program(step.inputs(win, gen, window=True),
                                         window=True)
        else:
            out = [step.accumulate(window_sample(win, i), gen) for i in range(WIN)]
            losses, dists = (torch.stack(v) for v in zip(*out))
        runs.append((_state(pipe, step.network), losses, dists))
    (sa, la, da), (sb, lb, db) = runs
    assert torch.equal(la, lb) and torch.equal(da, db)
    _assert_same(sa, sb)


# ---------------- GradientGraphs, with an eager stand-in ----------------


def _eager_capture(log):
    """A stand-in for `utils.cuda_graphs.capture` on the CPU: the warm-up
    runs, `after_warmup` undoes it, the "capture" runs nothing (as a real
    capture executes no kernel) and a replay reruns the program on the
    static inputs, writing the static outputs in place."""
    from plr2_tpu_torch.utils.cuda_graphs import Graph, clone

    def capture(fn, args, after_warmup=None, pool=None):
        static = clone(tuple(args))
        out = clone(fn(*static))
        if after_warmup is not None:
            after_warmup()
        log.append((static, pool))

        class Replay:
            @staticmethod
            def replay():
                for o, n in zip(out, fn(*static)):
                    o.copy_(n)

            @staticmethod
            def pool():
                return ("pool of capture", len(log))
        return Graph(Replay, static, out)
    return capture


def test_gradient_graphs_keys_replays_and_undoes_the_warmup(monkeypatch):
    """One capture per key; a replay leaves exactly one window's gradients
    and one set of BN updates (the warm-up's are undone); `.grad` set to
    None in between is bound again; a new canvas or `w` is a new key, and
    every key stays; all graphs share the first one's memory pool and
    gradient tensors; `cast` drops them all."""
    log = []
    monkeypatch.setattr(graphs, "capture", _eager_capture(log))
    cache = GradientGraphs()
    ref_pipe, pipe = _pipe(), _pipe()
    ref = TrainStep(ref_pipe, SYM, W)
    step = TrainStep(pipe, SYM, W)
    for seed in (0, 1):
        win = _window(seed, 2)
        gen = torch.Generator().manual_seed(seed)
        got = cache.gradients(step, win, gen, window=True)
        want = ref.program(ref.inputs(win, torch.Generator().manual_seed(seed),
                                      window=True), window=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        _assert_same(_state(pipe, step.network), _state(ref_pipe, ref.network))
        step.network.zero_grad(set_to_none=True)  # rebound at the next call
    assert len(log) == 1 and cache.captures == 1
    small = {k: v[:, :40, :40] if k == "img" else v
             for k, v in _window(0, 2).items()}
    small["choose"] = small["choose"] % 1600
    cache.gradients(step, small, torch.Generator(), window=True)
    grads = [p.grad for p in step.network.parameters()]
    cache.gradients(TrainStep(pipe, SYM, 0.5 * W), _window(0, 2),
                    torch.Generator(), window=True)
    assert cache.captures == 3 and cache.held == 3
    assert [pool for _, pool in log] == [None] + 2 * [("pool of capture", 1)]
    assert all(g is not None and p.grad is g
               for p, g in zip(step.network.parameters(), grads))
    cache.gradients(step, small, torch.Generator(), window=True)
    assert cache.captures == 3
    pipe.cast(torch.float64)
    cache.gradients(TrainStep(pipe, SYM, W), small, torch.Generator(),
                    window=True)
    assert cache.held == 1 and log[-1][1] is None


def _cfg(**train):
    return t_config.PipelineConfig(
        dataset=t_config.DatasetConfig(num_points=N, num_objects=NUM_OBJ,
                                       num_mesh_points=M, sym_list=SYM,
                                       add_noise=False, crop_size=HW),
        model=t_config.ModelConfig(num_points=N, num_objects=NUM_OBJ),
        train=t_config.TrainConfig(**{"batch_size": WIN, "lr": 1e-4, "w": W,
                                      **train}))


def _samples(n):
    from plr2_tpu_torch.data.preprocess import Sample
    win = {k: v for k, v in _window().items() if k != "obj"}
    return [Sample(**{k: win[k][i % WIN] for k in BATCH_KEYS}, obj=IDX[i % WIN])
            for i in range(n)]


@pytest.mark.parametrize("kind", [FusedTrainer, BatchTrainer])
def test_trainer_epoch_through_graphs_equals_the_eager_epoch(kind, monkeypatch):
    """An epoch of 5 samples (two windows or batches of 2 and a tail)
    through `GradientGraphs` with the eager stand-in, against the same
    trainer with `graphs=False`: losses, parameters, BN statistics and
    Adam's step count equal bit for bit."""
    monkeypatch.setattr(graphs, "capture", _eager_capture([]))
    out = []
    for graphed in (True, False):
        tr = kind(_cfg(sym_slots=-1, batch_size=2), pipe=_pipe(), graphs=False)
        if graphed:
            tr.graphs = GradientGraphs()  # the card's path, on the CPU
        ts = _samples(5)
        tr._sample_iter = lambda *a, **k: iter(ts)
        state = tr.init_state()
        state, info = tr.train_epoch(state, None, torch.Generator().manual_seed(1))
        net = tr.pipe.posenet
        out.append((info["losses"], {n: p.detach().clone() for n, p in net.named_parameters()},
                    [b.clone() for b in batchnorm_buffers(net)],
                    {int(s["step"]) for s in state.optimizer.state.values()}))
        if graphed:
            assert tr.graphs.captures >= 1
    (la, pa, ba, sa), (lb, pb, bb, sb) = out
    assert la == lb and sa == sb
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    for x, y in zip(ba, bb):
        assert torch.equal(x, y)
