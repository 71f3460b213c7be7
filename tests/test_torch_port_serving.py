"""plr2_tpu_torch's frame serving against the JAX package's
(plr2_tpu/serving.py, following tests/test_serving.py): the device bbox
against the host bbox and JAX's device twin, the batched choose sampling
against the per-crop one and JAX's (bit-equal), `FrameEstimator` against
JAX's on the same frames, weights and key words in both sampling regimes,
against the port's own host chain (bit-equal on the wrap path), invalid
and oversized slots, `run_frames` against single-frame runs, the graph
keying (with an eager stand-in for the capture: the CPU has no CUDA
graph), the refusals and the serve CLI.

Small frames (240 x 320, a centre crop of a synthetic 480 x 640 scene),
canvas 120, 512 points, 3 objects; one JAX frame program compiled for the
whole file (the module fixture), its XLA path.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plr2_tpu.data import bbox as j_bbox
from plr2_tpu.data import preprocess as j_pre
from plr2_tpu.data.synthetic import make_scene
from plr2_tpu.pipeline import DenseFusionPipeline as JPipeline
from plr2_tpu.serving import FrameEstimator as JFrameEstimator
from plr2_tpu_torch import DenseFusionPipeline
from plr2_tpu_torch import serving
from plr2_tpu_torch.data import bbox as t_bbox
from plr2_tpu_torch.data import preprocess as t_pre
from plr2_tpu_torch.data.loader import raw_to_sample, stack_samples
from plr2_tpu_torch.serving import FrameEstimator, frame_key_words
from plr2_tpu_torch.tools import serve
from plr2_tpu_torch.utils.cuda_graphs import Graph

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
H, W, CANVAS, N, NUM_OBJ, ITERS = 240, 320, 120, 512, 3, 1
INTR_KEYS = ("cx", "cy", "fx", "fy", "cam_scale")
# poses against JAX: the f32 estimate's tolerance (test_torch_port_pipeline)
POSE_TOL = 2e-3


# ---------------- the device bbox ----------------


def _random_masks(rng, h, w, n):
    """n masks: empty, random blobs, and blobs on each edge and corner."""
    masks = np.zeros((n, h, w), bool)
    for i in range(1, n):
        rh, cw = int(rng.integers(1, h // 2)), int(rng.integers(1, w // 2))
        r0 = (0, h - rh, int(rng.integers(0, h - rh)))[i % 3]
        c0 = (w - cw, int(rng.integers(0, w - cw)), 0, w - cw)[i % 4]
        masks[i, r0:r0 + rh, c0:c0 + cw] = rng.random((rh, cw)) < 0.3
        masks[i, r0, c0] = True
    return masks


@pytest.mark.parametrize("h,w", [(240, 320), (480, 640), (97, 131)])
def test_device_bbox_matches_host_and_jax(h, w):
    rng = np.random.default_rng(h)
    masks = _random_masks(rng, h, w, 12)
    got = torch.stack(t_bbox.device_bbox_from_mask(torch.from_numpy(masks)), -1)
    assert got.dtype == torch.int64 and got.shape == (12, 4)
    for m, g in zip(masks, got.tolist()):
        assert tuple(g) == t_bbox.get_bbox_from_mask(m, h, w)
        assert tuple(g) == tuple(int(v) for v in
                                 j_bbox.device_bbox_from_mask(jnp.asarray(m)))
    # a mask padded by a canvas, clamped against the real image size
    c = 120
    padded = np.pad(masks, ((0, 0), (0, c), (0, c)))
    got_p = torch.stack(t_bbox.device_bbox_from_mask(
        torch.from_numpy(padded), h, w), -1)
    assert torch.equal(got_p, got)


def test_device_snap_bbox_matches_host():
    rng = np.random.default_rng(0)
    cases = []
    for _ in range(300):
        h, w = int(rng.integers(60, 481)), int(rng.integers(60, 641))
        rmin = int(rng.integers(0, h - 1))
        rmax = int(rng.integers(rmin + 1, h + 1))
        cmin = int(rng.integers(0, w - 1))
        cmax = int(rng.integers(cmin + 1, w + 1))
        cases.append((rmin, rmax, cmin, cmax, h, w))
    for rmin, rmax, cmin, cmax, h, w in cases[:60]:
        got = t_bbox.device_snap_bbox(*(torch.tensor(v) for v in
                                        (rmin, rmax, cmin, cmax)), h, w)
        assert tuple(int(v) for v in got) == t_bbox.snap_bbox(
            rmin, rmax, cmin, cmax, h, w)
    # one batched call over every case at one image size
    arr = torch.tensor([c[:4] for c in cases]).T
    got = torch.stack(t_bbox.device_snap_bbox(*arr, 480, 640), -1)
    want = [t_bbox.snap_bbox(*c[:4], 480, 640) for c in cases]
    assert got.tolist() == [list(v) for v in want]


# ---------------- batched choose sampling ----------------


def _jax_key(words):
    return jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32))


def test_sample_choose_batch_bit_equal_to_per_crop_and_jax():
    """Rows with 0, fewer than, exactly and more than num_points masked
    pixels (both regimes), one call; each row equals the per-crop function
    and JAX's given the same key words."""
    rng = np.random.default_rng(1)
    h, w, n = 30, 40, 64
    masks = np.zeros((6, h * w), bool)
    for row, count in enumerate((0, 20, n, n + 1, 500, h * w)):
        masks[row, rng.choice(h * w, count, replace=False)] = True
    words = rng.integers(0, 2 ** 32, (6, 2), dtype=np.uint64).astype(np.int64)
    got = t_pre.sample_choose_batch(torch.from_numpy(masks), n,
                                    torch.from_numpy(words), width=w)
    assert got.shape == (6, n) and got.dtype == torch.int64
    for m, kw, g in zip(masks, words, got):
        one = t_pre.sample_choose(torch.from_numpy(m), n, tuple(kw), width=w)
        assert torch.equal(g, one)
        want = j_pre.sample_choose(jnp.asarray(m), n, _jax_key(kw), width=w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert not got[0].any()


def test_coord_scores_takes_tensor_words():
    words = torch.tensor([[1, 2], [0xFFFFFFFF, 7], [12345, 67890]])
    got = t_pre.coord_scores(words, 9, 11)
    for row, kw in zip(got, words.tolist()):
        assert torch.equal(row, t_pre.coord_scores(tuple(kw), 9, 11))


# ---------------- FrameEstimator against JAX ----------------


def _numpy_variables(rng, shapes):
    """Seeded numpy weights for the JAX variable tree `shapes`."""
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


def _frame(regime):
    """A 240 x 320 centre crop of a 480 x 640 scene of 3 objects (620-683
    masked pixels each: the subsample regime at 512 points); the wrap
    regime drops every other depth row (about half the pixels)."""
    frame, models = make_scene(num_objects=3, model_points=64, seed=0)
    intr = dict(frame.intrinsics)
    intr["cx"] -= 160
    intr["cy"] -= 120
    color = np.ascontiguousarray(frame.color[120:360, 160:480])
    depth = frame.depth[120:360, 160:480].astype(np.float32)
    label = frame.label[120:360, 160:480].astype(np.int32)
    if regime == "wrap":
        depth[::2] = 0.0
    poses = frame.poses
    return color, depth, label, poses, models, intr


def _slot_inputs(poses, models, intr, obj_ids):
    mesh = [models[o] if o in models else models[1] for o in obj_ids]
    tr = [poses[o][0] if o in poses else np.eye(3) for o in obj_ids]
    tt = [poses[o][1] if o in poses else np.zeros(3) for o in obj_ids]
    return (np.stack(mesh).astype(np.float32),
            np.asarray([intr[k] for k in INTR_KEYS], np.float32),
            np.stack(tr).astype(np.float32), np.stack(tt).astype(np.float32))


def jax_words(key, obj_ids):
    """JAX's per-slot key words: the choose subkey of fold_in(key, id)."""
    return np.stack([
        np.asarray(jax.random.key_data(jax.random.split(
            jax.random.fold_in(key, int(o)), 3)[0])).reshape(-1)[[0, -1]]
        for o in obj_ids]).astype(np.int64)


@pytest.fixture(scope="module")
def served():
    """One JAX frame program (K = 4 slots, one inactive) and a port
    pipeline on the same numpy weights."""
    rng = np.random.default_rng(12)
    jpipe = JPipeline(num_points=N, num_objects=NUM_OBJ)
    shapes = jax.eval_shape(lambda k: jpipe.init(k, crop_hw=80, batch=1),
                            jax.random.key(0))
    variables = _numpy_variables(rng, shapes)
    jfe = JFrameEstimator(jpipe, canvas=CANVAS, img_h=H, img_w=W,
                          refine_iterations=ITERS)
    pipe = DenseFusionPipeline(N, NUM_OBJ, device="cpu", seed=None)
    pipe.load_jax_variables(variables)
    fe = FrameEstimator(pipe, canvas=CANVAS, img_h=H, img_w=W,
                        refine_iterations=ITERS)
    return variables, jfe, pipe, fe


OBJ_IDS = np.array([1, 3, 0, 2])


@pytest.mark.parametrize("regime", ["wrap", "subsample"])
def test_frame_estimator_matches_jax(served, regime):
    variables, jfe, _, fe = served
    color, depth, label, poses, models, intr = _frame(regime)
    counts = [int(((label == o) & (depth > 0)).sum()) for o in (1, 2, 3)]
    assert (max(counts) <= N) if regime == "wrap" else (min(counts) > N)
    mps, intr_vec, tr, tt = _slot_inputs(poses, models, intr, OBJ_IDS)
    key = jax.random.key(4)
    jposes, jsam = jfe.run_with_samples(
        variables, jnp.asarray(color), jnp.asarray(depth), jnp.asarray(label),
        jnp.asarray(OBJ_IDS, jnp.int32), jnp.asarray(mps),
        jnp.asarray(intr_vec), key, target_r=jnp.asarray(tr),
        target_t=jnp.asarray(tt))
    got, sam = fe.run_with_samples(color, depth, label, OBJ_IDS, mps,
                                   intr_vec, target_r=tr, target_t=tt,
                                   key_words=jax_words(key, OBJ_IDS))
    np.testing.assert_array_equal(sam.choose.numpy(), np.asarray(jsam.choose))
    for f in ("points", "img", "target"):
        np.testing.assert_allclose(getattr(sam, f).numpy(),
                                   np.asarray(getattr(jsam, f)), atol=1e-6,
                                   rtol=0, err_msg=f)
    np.testing.assert_array_equal(sam.idx.numpy(), np.asarray(jsam.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(jposes.valid))
    np.testing.assert_array_equal(got.oversized.numpy(),
                                  np.asarray(jposes.oversized))
    assert got.valid.tolist() == [True, True, False, True]
    np.testing.assert_allclose(got.quat.numpy(), np.asarray(jposes.quat),
                               atol=POSE_TOL)
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(jposes.trans),
                               atol=POSE_TOL)
    np.testing.assert_allclose(got.confidence.numpy(),
                               np.asarray(jposes.confidence), atol=2e-4)


def _host_chain(pipe, color, depth, label, poses, models, intr, obj_ids,
                words, canvas):
    """The port's host chain: host bbox -> raw_to_sample (the same key
    words) -> stack_samples -> estimate."""
    samples = []
    for o, kw in zip(obj_ids, words):
        raw = dict(color=color, depth=depth,
                   mask=(label == o) & (depth > 0), target_r=poses[o][0],
                   target_t=poses[o][1], model_points=models[o],
                   obj_idx=o - 1, intrinsics=intr)
        draws = t_pre.Draws(tuple(int(v) for v in kw), torch.ones(4),
                            torch.arange(4), torch.zeros(3))
        samples.append(raw_to_sample(raw, draws, pipe.num_points))
    batch = stack_samples(samples, crop=canvas)
    est = pipe.estimate(batch.img, batch.points, batch.choose, batch.idx,
                        refine_iterations=ITERS)
    return batch, est


def test_frame_program_equals_host_chain_on_the_wrap_path(served):
    """Bit for bit, an object hugging the bottom-right corner included
    (its window shifts inside the real image, not the padded one)."""
    _, _, pipe, fe = served
    color, depth, label, poses, models, intr = _frame("wrap")
    label = np.where(label == 3, 0, label)
    label[218:238, 288:318] = 3
    depth[218:238, 288:318] = 2000.0
    assert t_bbox.get_bbox_from_mask(label == 3, H, W) == (200, 240, 280, 320)
    obj_ids = np.array([1, 2, 3])
    mps, intr_vec, tr, tt = _slot_inputs(poses, models, intr, obj_ids)
    words = frame_key_words(torch.tensor(9), torch.from_numpy(obj_ids))
    got, sam = fe.run_with_samples(color, depth, label, obj_ids, mps,
                                   intr_vec, 9, target_r=tr, target_t=tt)
    batch, est = _host_chain(pipe, color, depth, label, poses, models, intr,
                             obj_ids, words.numpy(), CANVAS)
    assert got.valid.all()
    for f in ("choose", "points", "img", "target", "idx"):
        assert torch.equal(getattr(sam, f), getattr(batch, f)), f
    for a, b in ((got.quat, est.quat), (got.trans, est.trans),
                 (got.confidence, est.confidence)):
        assert torch.equal(a, b)


def test_key_words_follow_the_object_not_the_slot():
    ids = torch.tensor([[4, 0, 7, 2], [2, 7, 4, 0]])
    w = frame_key_words(torch.tensor([5, 5]), ids)
    assert w.shape == (2, 4, 2) and int(w.min()) >= 0 and int(w.max()) < 2 ** 32
    assert torch.equal(w[1], w[0][[3, 2, 0, 1]])
    assert not torch.equal(frame_key_words(torch.tensor(6), ids[0]), w[0])


# ---------------- slots, frames and the graph keying ----------------


def _small_pipe(num_points=32, num_objects=2):
    return DenseFusionPipeline(num_points, num_objects, device="cpu", seed=0)


def test_invalid_slots_and_subsample_choose():
    color, depth, label, poses, models, intr = _frame("subsample")
    pipe = _small_pipe(64, 3)
    fe = FrameEstimator(pipe, canvas=CANVAS, img_h=H, img_w=W,
                        refine_iterations=1)
    obj_ids = np.array([2, 0, 99])  # one real, one inactive, one absent
    mps = np.stack([models[2]] * 3).astype(np.float32)
    intr_vec = np.asarray([intr[k] for k in INTR_KEYS], np.float32)
    got, sam = fe.run_with_samples(color, depth, label, obj_ids, mps,
                                   intr_vec, 1)
    assert got.valid.tolist() == [True, False, False]
    assert not got.oversized.any()
    assert torch.isfinite(got.quat).all() and torch.isfinite(got.trans).all()
    assert sam.idx.tolist() == [1, 0, 2]  # clamped head indices
    choose = sam.choose[0].numpy()
    assert (np.diff(choose) > 0).all()
    mask = (label == 2) & (depth > 0)
    rmin, _, cmin, _ = t_bbox.get_bbox_from_mask(mask, H, W)
    assert mask[choose // CANVAS + rmin, choose % CANVAS + cmin].all()


def test_oversized_window_flagged_invalid():
    rng = np.random.default_rng(3)
    h, w = 192, 256
    color = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    depth = np.zeros((h, w), np.float32)
    label = np.zeros((h, w), np.int32)
    label[40:150, 60:180] = 1  # 110 x 120 -> a 120 x 120 window
    depth[40:150, 60:180] = 2000.0
    mps = (rng.normal(size=(1, 32, 3)) * 0.01).astype(np.float32)
    intr = np.asarray([128.0, 96.0, 200.0, 200.0, 10000.0], np.float32)
    pipe = _small_pipe()
    args = (color, depth, label, np.array([1]), mps, intr, 0)
    small = FrameEstimator(pipe, canvas=80, img_h=h, img_w=w,
                           refine_iterations=1).run(*args)
    assert not small.valid[0] and small.oversized[0]
    grown = FrameEstimator(pipe, canvas=120, img_h=h, img_w=w,
                           refine_iterations=1).run(*args)
    assert grown.valid[0] and not grown.oversized[0]


def test_run_frames_matches_single_frame_runs():
    frames = [_frame("wrap"), _frame("subsample")]
    pipe = _small_pipe(64, 3)
    fe = FrameEstimator(pipe, canvas=CANVAS, img_h=H, img_w=W,
                        refine_iterations=2)
    obj_ids = np.array([3, 1, 0])
    per = []
    for color, depth, label, poses, models, intr in frames:
        mps, intr_vec, _, _ = _slot_inputs(poses, models, intr, obj_ids)
        per.append((color, depth, label, obj_ids, mps, intr_vec))
    singles = [fe.run(*p, seed) for p, seed in zip(per, (5, 6))]
    stacked = [np.stack(x) for x in zip(*per)]
    batched = fe.run_frames(*stacked, np.array([5, 6]))
    assert batched.quat.shape == (2, 3, 4) and batched.valid.shape == (2, 3)
    for f in range(2):
        assert torch.equal(batched.valid[f], singles[f].valid)
        assert torch.equal(batched.oversized[f], singles[f].oversized)
        for a, b in ((batched.quat[f], singles[f].quat),
                     (batched.trans[f], singles[f].trans)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5)


def _eager_capture(log):
    """A stand-in for `serving._capture` on the CPU: the "graph" reruns the
    program on its static inputs and writes its static outputs in place,
    as a replay does."""
    def capture(fn, args):
        static = tuple(None if a is None else a.clone() for a in args)
        out = fn(*static)
        log.append(tuple(a is None for a in args))

        class Replay:
            @staticmethod
            def replay():
                new = fn(*static)
                flat_new = new if isinstance(new[0], torch.Tensor) else \
                    [t for part in new for t in part]
                flat_out = out if isinstance(out[0], torch.Tensor) else \
                    [t for part in out for t in part]
                for o, n in zip(flat_out, flat_new):
                    o.copy_(n)
        return Graph(Replay, static, out)
    return capture


def test_graph_keying_and_replay_with_an_eager_stand_in(monkeypatch):
    log = []
    monkeypatch.setattr(serving, "_capture", _eager_capture(log))
    color, depth, label, poses, models, intr = _frame("subsample")
    pipe = _small_pipe(32, 3)
    eager = FrameEstimator(pipe, canvas=CANVAS, img_h=H, img_w=W,
                           refine_iterations=1, graphs=True)
    assert not eager.graphs  # a CPU pipeline runs eagerly
    fe = FrameEstimator(pipe, canvas=CANVAS, img_h=H, img_w=W,
                        refine_iterations=1)
    fe.graphs = True  # the CUDA path, with the stand-in capture
    obj_ids = np.array([1, 2, 3])
    mps, intr_vec, _, _ = _slot_inputs(poses, models, intr, obj_ids)
    frame = (color, depth, label, obj_ids, mps, intr_vec)
    for seed in (0, 1, 2):  # one capture, then copy-in and replay
        got = fe.run(*frame, seed)
        want = eager.run(*frame, seed)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert len(log) == 1
    fe.run_with_samples(*frame, 0)  # poses and samples: another knob set
    fe.run(*frame, key_words=np.ones((3, 2), np.int64))  # words given
    fe.run(*[x[:2] if i in (3, 4) else x for i, x in enumerate(frame)], 0)
    fe.run_frames(*[np.stack([x] * 2) for x in frame], np.array([0, 1]))
    assert len(log) == 5 and len(fe._graphs) == 5
    fe.run(*frame, 3)
    assert len(log) == 5
    keys = list(fe._graphs)
    assert len(set(keys)) == 5
    # canvas, num_points, iterations, dtype, poses only; then the inputs
    assert keys[0][:5] == (CANVAS, 32, 1, torch.float32, False)
    assert keys[0][5][:4] == (((1, H, W, 3), torch.uint8),
                              ((1, H, W), torch.float32),
                              ((1, H, W), torch.int32), ((1, 3), torch.int64))
    assert keys[0][5][7:] == (None, None, None)  # no words, no targets
    pipe.cast(torch.bfloat16)  # new weights: the old graphs are dropped
    got = fe.run(*frame, 0)
    assert len(log) == 6 and len(fe._graphs) == 1
    assert got.quat.dtype == torch.bfloat16


# ---------------- refusals ----------------


def test_refusals():
    pipe = _small_pipe()
    with pytest.raises(NotImplementedError, match="A6"):
        FrameEstimator(pipe, seg_model=object())
    with pytest.raises(NotImplementedError, match="A6"):
        FrameEstimator(pipe, seg_scale=2)
    with pytest.raises(NotImplementedError, match="A7"):
        FrameEstimator(pipe, mesh=object())
    with pytest.raises(ValueError, match="canvas"):
        FrameEstimator(pipe, canvas=280, img_h=240, img_w=320)
    fe = FrameEstimator(pipe, canvas=40, img_h=48, img_w=48)
    frame = (np.zeros((48, 48, 3), np.uint8), np.zeros((48, 48), np.float32),
             np.zeros((48, 48), np.int32), np.array([1]),
             np.zeros((1, 8, 3), np.float32), np.ones(5, np.float32))
    with pytest.raises(NotImplementedError, match="A6"):
        fe.run(*frame, 0, seg_variables={})
    for argv in (["--synthetic", "--seg_arch", "pspnet"],
                 ["--synthetic", "--seg_model", "seg.msgpack"]):
        with pytest.raises(NotImplementedError, match="ROADMAP A6"):
            serve.main(argv)
    with pytest.raises(SystemExit, match="pick one"):
        serve.main(["--synthetic", "--dataset_root", "/data/ycb"])


def test_serve_cli_runs_on_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--synthetic", "--num_frames", "1", "--num_points", "16"])


# ---------------- the serve CLI ----------------


def _serve(*args):
    out = subprocess.run(
        [sys.executable, "-m", "plr2_tpu_torch.tools.serve", "--synthetic",
         "--cpu", "--num_points", "64", "--iters", "1", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")], out.stderr


def test_serve_cli_single_and_batched_frames():
    # the synthetic objects' windows are 120 px: a 120 px canvas serves them
    base = ("--max_objects", "2", "--canvas", "120")
    single, err = _serve("--num_frames", "2", *base)
    assert [line["frame"] for line in single] == [0, 1]
    assert all(len(line["objects"]) == 2 and len(line["objects"][0]["quat"]) == 4
               and all(o["valid"] for o in line["objects"]) for line in single)
    assert "served 2 frames" in err
    # frames 0-1 through run_frames, frame 2 (the tail) through run
    batched, err = _serve("--num_frames", "3", "--batch", "2", *base)
    assert [line["frame"] for line in batched] == [0, 1, 2]
    assert "served 3 frames" in err
    for a, b in zip(single, batched):
        for oa, ob in zip(a["objects"], b["objects"]):
            assert oa["obj"] == ob["obj"] and oa["valid"] == ob["valid"]
            np.testing.assert_allclose(oa["quat"], ob["quat"], atol=1e-4)
            np.testing.assert_allclose(oa["trans"], ob["trans"], atol=1e-4)


def test_serve_cli_drop_counter_and_auto_grow():
    base = ("--num_frames", "1", "--max_objects", "1", "--canvas", "40")
    lines, err = _serve(*base)
    assert lines[0].get("oversized", 0) >= 1 and lines[0].get("dropped", 0) >= 1
    assert "dropped 1 object slots" in err and "--auto_grow_canvas" in err
    lines, err = _serve(*base, "--auto_grow_canvas")
    assert "new estimator at" in err
    assert "oversized" not in lines[0] and lines[0]["objects"][0]["valid"]
    assert "dropped" not in err.splitlines()[-1]
