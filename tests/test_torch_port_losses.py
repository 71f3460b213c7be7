"""plr2_tpu_torch.losses against the JAX package: `pose_loss` (stage 1
and refine stage, batches with all, none and some samples symmetric, JAX's
`max_sym_slots` None and 2) and `refine_loss`, values and gradients, on the
same numpy inputs. On the CPU the ADD-S match runs the plain twin of the
`nn_match` kernel; JAX runs its chunked XLA form (the same function: both
take the first argmin and the exact distance to it).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plr2_tpu.losses.add_loss import pose_loss as j_pose_loss
from plr2_tpu.losses.refine_loss import refine_loss as j_refine_loss
from plr2_tpu_torch.losses import pose_loss, refine_loss

torch.set_num_threads(2)

B, N, M = 4, 16, 32
SYM = (1, 3)
W = 0.015
IDX = {"all_sym": [1, 3, 1, 3], "none_sym": [0, 2, 4, 0], "mixed": [1, 0, 2, 3]}

# f32 arithmetic in another order (quaternion normalisation, the K=3
# rotation, sums of B*N terms); the gradients are of a mean over B*N
# hypotheses, so their size is ~1/(B*N) and the absolute floor sits below.
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)


def _rigid(rng, b):
    q = rng.normal(size=(b, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    return rot, rng.normal(size=(b, 3)) * 0.05


def _case(seed, n=N):
    rng = np.random.default_rng(seed)
    model_points = rng.normal(size=(B, M, 3)) * 0.05
    rot, t = _rigid(rng, B)
    target = np.einsum("bmk,blk->bml", model_points, rot) + t[:, None, :]
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(pred_r=f(rng.normal(size=(B, n, 4))),
                pred_t=f(rng.normal(size=(B, n, 3)) * 0.02),
                pred_c=f(rng.uniform(0.05, 0.95, size=(B, n, 1))),
                target=f(target), model_points=f(model_points),
                points=f(rng.normal(size=(B, n, 3)) * 0.05))


def _jax_pose(case, idx, refine, slots):
    def f(pr, pt, pc):
        o = j_pose_loss(pr, pt, pc, case["target"], case["model_points"],
                        jnp.asarray(idx, jnp.int32), case["points"], w=W,
                        refine=refine, sym_list=SYM, max_sym_slots=slots)
        return o.loss, o
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        case["pred_r"], case["pred_t"], case["pred_c"])
    return out, grads


def _torch_pose(case, idx, refine):
    leaves = {k: torch.from_numpy(case[k]).requires_grad_(True)
              for k in ("pred_r", "pred_t", "pred_c")}
    out = pose_loss(leaves["pred_r"], leaves["pred_t"], leaves["pred_c"],
                    torch.from_numpy(case["target"]),
                    torch.from_numpy(case["model_points"]),
                    torch.tensor(idx), torch.from_numpy(case["points"]),
                    w=W, refine=refine, sym_list=SYM)
    grads = torch.autograd.grad(out.loss, list(leaves.values()))
    return out, grads


# max_sym_slots only shapes the stage-1 ADD-S branch
@pytest.mark.parametrize("refine,slots", [(False, None), (False, 2), (True, None)])
@pytest.mark.parametrize("which", sorted(IDX))
def test_pose_loss_matches_jax(which, refine, slots):
    case = _case(3)
    want, jgrads = _jax_pose(case, IDX[which], refine, slots)
    got, tgrads = _torch_pose(case, IDX[which], refine)
    for name in ("loss", "dis", "new_points", "new_target"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **VALUE_TOL)
    assert not got.new_points.requires_grad and not got.new_target.requires_grad
    for name, g, jg in zip(("pred_r", "pred_t", "pred_c"), tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), err_msg=name,
                                   **GRAD_TOL)


def test_adds_rows_differ_from_add_rows():
    """The symmetric rows really take the ADD-S branch: ADD-S <= ADD, and
    strictly below it for a random pose."""
    case = _case(5)
    sym, _ = _torch_pose(case, IDX["all_sym"], refine=False)
    asym, _ = _torch_pose(case, IDX["all_sym"], refine=True)  # ADD only
    assert (sym.dis < asym.dis).all()


def _jax_refine(case, idx):
    def f(pr, pt):
        o = j_refine_loss(pr, pt, case["target"], case["model_points"],
                          jnp.asarray(idx, jnp.int32), case["points"],
                          sym_list=SYM)
        return jnp.sum(o.dis), o
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        case["pred_r"][:, :1], case["pred_t"][:, :1])
    return out, grads


@pytest.mark.parametrize("which", sorted(IDX))
def test_refine_loss_matches_jax(which):
    case = _case(9)
    want, jgrads = _jax_refine(case, IDX[which])
    pr = torch.from_numpy(case["pred_r"][:, :1].copy()).requires_grad_(True)
    pt = torch.from_numpy(case["pred_t"][:, :1].copy()).requires_grad_(True)
    got = refine_loss(pr, pt, torch.from_numpy(case["target"]),
                      torch.from_numpy(case["model_points"]),
                      torch.tensor(IDX[which]), torch.from_numpy(case["points"]),
                      sym_list=SYM)
    grads = torch.autograd.grad(got.dis.sum(), [pr, pt])
    for name in ("dis", "new_points", "new_target"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **VALUE_TOL)
    assert not got.new_points.requires_grad
    # a sum over B samples of means over M points: gradients of size ~1
    for name, g, jg in zip(("pred_r", "pred_t"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), err_msg=name,
                                   rtol=1e-4, atol=1e-6)


def test_losses_finite_at_exact_coincidence():
    """After tests/test_losses.py:194: pred == target exactly gives finite
    gradients (safe_norm's zero subgradient), ADD and ADD-S rows alike."""
    rng = np.random.default_rng(0)
    mp = torch.from_numpy((rng.normal(size=(2, 6, 3)) * 0.05).astype(np.float32))
    pr = torch.tensor([1.0, 0, 0, 0]).repeat(2, 4, 1).requires_grad_(True)
    pt = torch.zeros((2, 4, 3), requires_grad=True)
    pc = torch.full((2, 4, 1), 0.5, requires_grad=True)
    idx = torch.tensor([0, 1])  # one ADD row, one ADD-S row
    out = pose_loss(pr, pt, pc, mp, mp, idx, torch.zeros((2, 4, 3)), w=W,
                    refine=False, sym_list=(1,))
    for g in torch.autograd.grad(out.loss, [pr, pt, pc]):
        assert torch.isfinite(g).all()
    ro = refine_loss(pr[:, :1], pt[:, :1], mp, mp, idx, torch.zeros((2, 4, 3)),
                     sym_list=(1,))
    for g in torch.autograd.grad(ro.dis.sum(), [pr, pt]):
        assert torch.isfinite(g).all()
