"""plr2_tpu_torch's segmentation against the JAX package's
(plr2_tpu/models/segnet.py, plr2_tpu/train/seg_trainer.py,
plr2_tpu/eval/segment.py) on the same seeded numpy weights and inputs,
bridged by `models/weights.py` `segmenter_state_dict`:

- SegNet's forward at full VGG16 widths (32 x 32) and at two narrow blocks
  (16 x 16), with a constant image among the inputs: after each ReLU its
  windows tie on every element, the case `F.max_unpool2d` gets wrong;
- `max_pool_with_mask` / `max_unpool` bit-equal, ties included, and the
  pool's gradient to the first maximum of a window, as XLA's;
- `segmentation_loss`, the PSPNet segmenter's full map
  (`build_segmenter("pspnet")`), one `SegTrainer` step of each
  architecture (loss, parameters after Adam, BatchNorm statistics; flax's
  dropout intercepted to its input and the port's rates set to 0), the
  frame crops, `predict`'s padding of the normalised frame;
- `eval/segment.py`: the segnet_results layout written with the port's
  PNG codec and read back by PIL, against JAX's writer.

f32 within 1e-5 throughout (the JAX side runs its default XLA path; the
PSPNet segmenter's decoder runs the kernel's plain version on the CPU).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from plr2_tpu.models import segnet as j_segnet
from plr2_tpu.train import seg_trainer as j_seg
from plr2_tpu_torch.data.preprocess import normalize_frames
from plr2_tpu_torch.models import segnet
from plr2_tpu_torch.models.weights import segmenter_state_dict
from plr2_tpu_torch.train import seg_trainer

torch.set_num_threads(2)

TOL = 1e-5
SMALL = ((1, 8), (1, 16))


def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _randomize(rng, variables):
    """Random BatchNorm statistics and biases (flax initialises them to
    constants, which would hide a misplaced tensor)."""
    def fill(path, x):
        name = str(path[-1])
        if "var" in name:
            return (np.abs(rng.normal(size=x.shape)) * 0.5 + 0.3).astype(np.float32)
        if "mean" in name or "bias" in name:
            return (rng.normal(size=x.shape) * 0.1).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(fill, _to_numpy(variables))


def _port(arch, variables, num_classes, enc_blocks=None):
    if enc_blocks is not None:
        model = segnet.SegNet(num_classes, enc_blocks).eval()
    else:
        model = segnet.build_segmenter(arch, num_classes, device="cpu", seed=None)
    model.load_state_dict(segmenter_state_dict(arch, variables), strict=True)
    return model


def _inputs(rng, b, hw):
    """b images (B, hw, hw, 3): noise, and a constant image last."""
    x = rng.normal(size=(b, hw, hw, 3)).astype(np.float32)
    x[-1] = 0.25
    return x


# ---------------- pool and unpool ----------------


def test_pool_and_unpool_bit_equal_with_ties():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 8, 12, 5)).astype(np.float32)
    x[0] = 0.0                         # every window ties 4 ways
    x[1, :4] = np.maximum(x[1, :4], 0)  # ReLU-like zeros: ties of 2-4
    x[2, ::2, ::2] = x[2, 1::2, 1::2]   # ties of two at chosen places
    jp, jm = j_segnet.max_pool_with_mask(jnp.asarray(x))
    tp, tm = segnet.max_pool_with_mask(torch.from_numpy(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    y = rng.normal(size=jp.shape).astype(np.float32)
    ju = j_segnet.max_unpool(jnp.asarray(y), jm)
    tu = segnet.max_unpool(torch.from_numpy(y), tm)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    # the all-zero sample writes y / 4 at every place of a window, where
    # an index unpool writes y at one
    np.testing.assert_array_equal(tu[0].numpy(), np.repeat(np.repeat(
        y[0], 2, 0), 2, 1) / 4)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    pt, idx = torch.nn.functional.max_pool2d(xt, 2, 2, return_indices=True)
    ref = torch.nn.functional.max_unpool2d(
        torch.from_numpy(y).permute(0, 3, 1, 2), idx, 2, 2).permute(0, 2, 3, 1)
    assert not torch.equal(ref[0], tu[0])


def test_bf16_mask_is_formed_in_bf16():
    x = torch.zeros((1, 4, 4, 2), dtype=torch.bfloat16)
    _, mask = segnet.max_pool_with_mask(x)
    assert mask.dtype == torch.bfloat16 and torch.all(mask == 0.25)


def test_pool_gradient_goes_to_the_first_maximum_as_in_xla():
    x = np.zeros((1, 4, 4, 1), np.float32)
    x[0, 2:, 2:, 0] = [[1.0, 3.0], [3.0, 2.0]]
    jg = jax.grad(lambda v: j_segnet.max_pool_with_mask(v)[0].sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    segnet.max_pool_with_mask(xt)[0].sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    assert float(xt.grad[0, 2, 3, 0]) == 1.0 and float(xt.grad[0, 3, 2, 0]) == 0.0


# ---------------- forward passes ----------------


@pytest.mark.parametrize("blocks,hw", [(None, 32), (SMALL, 16)],
                         ids=["vgg16_32px", "narrow_16px"])
def test_segnet_forward_matches_jax(blocks, hw):
    rng = np.random.default_rng(hw)
    kw = {} if blocks is None else {"enc_blocks": blocks}
    jm = j_segnet.SegNet(num_classes=22, **kw)
    x = _inputs(rng, 3, hw)
    variables = _randomize(rng, jm.init(jax.random.key(0), jnp.asarray(x[:1])))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    model = _port("segnet", variables, 22, blocks or segnet.VGG16_BLOCKS)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, hw, hw, 22)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_pspnet_segmenter_full_map_matches_jax():
    rng = np.random.default_rng(7)
    jm = j_segnet.build_segmenter("pspnet", 22)
    x = _inputs(rng, 2, 48)
    variables = _randomize(rng, jm.init(jax.random.key(1), jnp.asarray(x[:1])))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    model = _port("pspnet", variables, 22)
    assert not model.log_softmax_final
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 48, 48, 22)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_build_segmenter_refuses_an_unknown_arch():
    with pytest.raises(ValueError, match="segnet"):
        segnet.build_segmenter("unet", 4, device="cpu")


def test_segmentation_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 5, 6, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, size=(2, 5, 6))
    want = float(j_segnet.segmentation_loss(jnp.asarray(logits),
                                            jnp.asarray(labels, jnp.int32)))
    got = float(segnet.segmentation_loss(torch.from_numpy(logits),
                                         torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)
    uniform = segnet.segmentation_loss(torch.zeros(1, 2, 2, 3),
                                       torch.zeros(1, 2, 2, dtype=torch.long))
    assert abs(float(uniform) - np.log(3.0)) < 1e-6


# ---------------- SegTrainer ----------------


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.mark.parametrize("arch", ["segnet", "pspnet"])
def test_seg_trainer_step_matches_jax(arch):
    """One Adam step from one state on one batch (SegNet at two narrow
    blocks; the PSPNet segmenter at its widths): the loss within 1e-5
    relative, the BatchNorm statistics within 1e-5, and each parameter
    tensor within 1e-5 relative L2. Adam's first step moves a weight by
    about lr * sign(g), so a gradient that is f32 noise on either side
    (|g| near 0, as on a few colour-encoder weights) moves it by up to lr
    either way: held elementwise such weights would test the noise (as
    tests/test_torch_port_train.py holds the colour encoder's gradients
    in relative L2). A SegNet conv's bias feeds a train-mode BatchNorm,
    which subtracts the batch mean: its gradient is 0 in exact arithmetic,
    so its whole step is that noise; those biases are held to the step's
    bound, |change| <= lr, on both sides."""
    rng = np.random.default_rng(11)
    hw = 16 if arch == "segnet" else 32
    jt = j_seg.SegTrainer(num_classes=5, crop=hw, batch=2, arch=arch)
    if arch == "segnet":
        jt.model = j_segnet.SegNet(num_classes=5, enc_blocks=SMALL)
    state = jt.init_state(jax.random.key(3))
    variables = _randomize(rng, state["variables"])
    img = rng.normal(size=(2, hw, hw, 3)).astype(np.float32)
    labels = rng.integers(0, 5, size=(2, hw, hw)).astype(np.int32)
    with fnn.intercept_methods(_no_dropout):
        jv, _, jloss = jt.train_step(variables, jt.tx.init(variables["params"]),
                                     jnp.asarray(img), jnp.asarray(labels),
                                     jax.random.key(4))
    jv = _to_numpy(jax.device_get(jv))

    tt = seg_trainer.SegTrainer(num_classes=5, crop=hw, batch=2, arch=arch,
                                device="cpu")
    if arch == "segnet":
        tt.model = segnet.SegNet(5, SMALL).eval()
    tstate = tt.init_state()
    tt.model.load_state_dict(segmenter_state_dict(arch, variables), strict=True)
    if arch == "pspnet":
        tt.model.dropout_rates = (0.0, 0.0, 0.0)
    loss = tt.train_step(tstate, torch.from_numpy(img),
                         torch.from_numpy(labels.astype(np.int64)),
                         torch.Generator().manual_seed(0))
    assert not tt.model.training
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    want = segmenter_state_dict(arch, jv)
    got = tt.model.state_dict()
    assert set(want) == set(got)
    before = segmenter_state_dict(arch, variables)
    lr = 1e-4
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        if arch == "segnet" and name.endswith("conv.bias"):
            for side in (got[name], w):
                assert float((side - before[name]).abs().max()) <= lr * (1 + 1e-3)
            continue
        if "running" in name:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=TOL,
                                       rtol=TOL, err_msg=name)
        else:
            rel = float((got[name] - w).norm() / w.norm())
            assert rel <= TOL, (name, rel)


def test_frame_crops_match_jax():
    rng = np.random.default_rng(5)

    class Fr:
        def __init__(self, h, w):
            self.color = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            self.label = rng.integers(0, 4, (h, w)).astype(np.int32)
    frames = [Fr(60, 70), Fr(40, 90), Fr(60, 70)]
    want = list(j_seg.frame_crops(frames, 32, 2, np.random.default_rng(9)))
    got = list(seg_trainer.frame_crops(frames, 32, 2, np.random.default_rng(9)))
    assert [a[0].shape for a in got] == [(2, 32, 32, 3), (1, 32, 32, 3)]
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_predict_pads_the_normalised_frame():
    """predict zero-pads the NORMALISED frame (zero is grey) to a multiple
    of 32 and keeps the frame's own pixels: equal to the model on the
    padded input, and to JAX's predict on the same weights."""
    rng = np.random.default_rng(13)
    jm = j_segnet.SegNet(num_classes=4, enc_blocks=SMALL)
    color = rng.integers(0, 256, (1, 40, 50, 3)).astype(np.uint8)
    norm = (color.astype(np.float32) / 255.0 - 0.5) / 0.5
    variables = _randomize(rng, jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    jt = j_seg.SegTrainer(num_classes=4)
    jt.model = jm
    want = np.asarray(jt.predict(variables, jnp.asarray(norm)))
    tt = seg_trainer.SegTrainer(num_classes=4, device="cpu")
    tt.model = _port("segnet", variables, 4, SMALL)
    got = tt.predict(normalize_frames(torch.from_numpy(color)))
    assert got.shape == (1, 40, 50)
    np.testing.assert_array_equal(got.numpy(), want)
    padded = np.zeros((1, 64, 64, 3), np.float32)
    padded[:, :40, :50] = norm
    with torch.no_grad():
        full = tt.model(torch.from_numpy(padded)).argmax(-1)[:, :40, :50]
    assert torch.equal(full, got)


def test_train_epoch_learns_and_stops_at_a_batch_boundary():
    """A narrow SegNet learns 'left half 0 / right half 1' on flat-colour
    frames (tests/test_segnet.py's task at lr 1e-2), and a stop request
    ends the epoch before the next step."""
    class Fr:
        def __init__(self, seed):
            r = np.random.default_rng(seed)
            self.color = np.zeros((32, 32, 3), np.uint8)
            self.color[:, :16] = r.integers(0, 100, 3)
            self.color[:, 16:] = r.integers(150, 256, 3)
            self.label = np.zeros((32, 32), np.int32)
            self.label[:, 16:] = 1
    frames = [Fr(s) for s in range(4)]
    tt = seg_trainer.SegTrainer(num_classes=2, lr=1e-2, crop=32, batch=2,
                                device="cpu")
    tt.model = segnet.SegNet(2, SMALL).eval()
    state = tt.init_state(0)
    first = None
    for epoch in range(8):
        state = tt.train_epoch(state, frames, seed=epoch)
        first = first or state["last_epoch_loss"]
    assert state["last_epoch_loss"] < 0.5 * first
    x = normalize_frames(torch.from_numpy(np.stack(
        [f.color for f in frames])))
    acc = float((tt.predict(x) == torch.from_numpy(np.stack(
        [f.label for f in frames]))).float().mean())
    assert acc > 0.8, acc
    calls = []
    out = tt.train_epoch(state, frames, seed=9,
                         stop_fn=lambda: calls.append(1) or len(calls) > 1)
    assert out["interrupted"] and len(calls) == 2


def test_trainer_runs_on_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        seg_trainer.SegTrainer(num_classes=4)


# ---------------- segnet_results ----------------


def test_write_segnet_results_matches_jax(tmp_path):
    """The upstream layout from a label predictor: the port's PNGs decode
    (by PIL) to JAX's masks, frames read by the port's decoder."""
    from PIL import Image

    from plr2_tpu.eval.segment import write_segnet_results as j_write
    from plr2_tpu_torch.data.codecs import write_png
    from plr2_tpu_torch.eval.segment import write_segnet_results

    rng = np.random.default_rng(2)
    root = tmp_path / "lm"
    for obj, frames in ((1, (0, 3)), (2, (1,))):
        d = root / "data" / f"{obj:02d}"
        (d / "rgb").mkdir(parents=True)
        (d / "test.txt").write_text("".join(f"{f}\n" for f in frames))
        for f in frames:
            write_png(d / "rgb" / f"{f:04d}.png",
                      rng.integers(0, 256, (24, 32, 3)).astype(np.uint8))

    def predict(color):
        return (color[..., 0] // 86).astype(np.int64)  # classes 0-2

    n = write_segnet_results(str(root), str(tmp_path / "port"), predict,
                             objlist=[1, 2])
    m = j_write(str(root), str(tmp_path / "jax"), predict, objlist=[1, 2])
    assert n == m == 3
    for obj, f in ((1, 0), (1, 3), (2, 1)):
        rel = f"{obj:02d}_label/{f:04d}_label.png"
        got = np.asarray(Image.open(tmp_path / "port" / rel))
        want = np.asarray(Image.open(tmp_path / "jax" / rel))
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) <= {0, 255}
