"""plr2_tpu_torch's full pipeline (BASELINE config 5) and on-device
segmentation against the JAX package's (plr2_tpu/eval/full_pipeline.py,
plr2_tpu/serving.py `_segment`), following tests/test_full_pipeline.py
and tests/test_posecnn_roi.py:

- `evaluate_full_pipeline` in host mode with ground-truth labels, with a
  segmenter's labels (a stray blob the largest-component window must
  ignore, an object the segmenter missed) and with PoseCNN results (ROI
  windows, a GT object never detected, a detection of a class without
  ground truth: estimated and exported, not scored), given JAX's key
  words: distances, lost and extra detections and the `.mat` files;
- device mode against host mode on the port (the default key words, the
  same in both modes), and a frame with no object;
- `FrameEstimator` with a segmenter against JAX's at seg_scale 1 and 2:
  the label maps equal, the poses within the f32 estimate's 2e-3, and
  `segment_frame` equal to JAX's;
- the segmenter's graph knobs and weights (an eager stand-in for the
  capture), `ycb_frames_and_models` on the YCB layout of
  tests/test_real_loaders.py.

Frames are 240 x 320 centre crops of 480 x 640 scenes of 3 objects, canvas
120, 64 points, 1 refine iteration; the segmenter is SegNet at two narrow
blocks with 4 classes whose weights are set by hand to label each flat
scene colour with its object (random weights paint every object with one
class, so each mask would span the frame: tests/test_torch_port_segnet.py
holds random weights against JAX). One JAX pipeline and one pair of JAX
frame programs for the file.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.io as sio
import torch

from plr2_tpu.data.synthetic import make_scene
from plr2_tpu.eval import full_pipeline as j_fp
from plr2_tpu.models.segnet import SegNet as JSegNet
from plr2_tpu.pipeline import DenseFusionPipeline as JPipeline
from plr2_tpu.serving import FrameEstimator as JFrameEstimator
from plr2_tpu.train.seg_trainer import SegTrainer as JSegTrainer
from plr2_tpu_torch import DenseFusionPipeline, serving
from plr2_tpu_torch.data.posecnn import PoseCNNMasks
from plr2_tpu_torch.eval import full_pipeline as t_fp
from plr2_tpu_torch.models.segnet import SegNet
from plr2_tpu_torch.models.weights import segmenter_state_dict
from plr2_tpu_torch.serving import FrameEstimator
from plr2_tpu_torch.train.seg_trainer import SegTrainer
from plr2_tpu_torch.utils.cuda_graphs import Graph
from test_real_loaders import ycb_root  # noqa: F401  (fixture)

torch.set_num_threads(2)

H, W, CANVAS, N, NUM_OBJ, ITERS, MESH = 240, 320, 120, 64, 3, 1, 64
SYM = (1,)
SMALL, CLASSES = ((1, 8), (1, 16)), 4
POSE_TOL = 2e-3  # the f32 estimate's tolerance against JAX
INTR_KEYS = ("cx", "cy", "fx", "fy", "cam_scale")


def _numpy_variables(rng, shapes):
    """Seeded numpy weights for a JAX variable tree."""
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


def _colour_segnet_variables():
    """SegNet(4 classes, two narrow blocks) variables that label the scene
    colours: every conv is its centre tap, the first one puts the
    normalised colour + 2 (positive, so the ReLUs pass it) in channels 0-2
    and the rest carry it; the decoder's BatchNorms scale by 4, undoing
    the unpool's 1/4 in flat windows; the classifier scores class k by the
    cosine of the feature with (c_k + 2): the colour's direction wins, so
    the other scales the unpool gives at an object's edge (ties of 1-3 in
    a window) change no label. c_k: make_scene's colour of object k, and
    the background's grey 30."""
    cols = np.array([[30, 30, 30]] + [[(k * 67) % 200 + 55, (k * 131) % 200 + 55,
                                       (k * 29) % 200 + 55] for k in (1, 2, 3)],
                    np.float32) / 255.0 * 2 - 1

    def conv(cin, cout, kernel_io, bias):
        k = np.zeros((3, 3, cin, cout), np.float32)
        k[1, 1] = kernel_io
        return {"kernel": k, "bias": np.asarray(bias, np.float32)}

    def block(cin, cout, scale, first=False):
        io = np.zeros((cin, cout), np.float32)
        io[:3, :3] = np.eye(3)
        bias = np.zeros(cout)
        if first:
            bias[:3] = 2.0
        c = cout
        return ({"Conv_0": conv(cin, cout, io, bias),
                 "BatchNorm_0": {"scale": np.full(c, scale, np.float32),
                                 "bias": np.zeros(c, np.float32)}},
                {"BatchNorm_0": {"mean": np.zeros(c, np.float32),
                                 "var": np.ones(c, np.float32)}})
    params, stats = {}, {}
    for name, (cin, cout, scale, first) in {
            "enc0_0": (3, 8, 1.0, True), "enc1_0": (8, 16, 1.0, False),
            "dec0_0": (16, 8, 4.0, False), "dec1_0": (8, 8, 4.0, False)}.items():
        params[name], stats[name] = block(cin, cout, scale, first)
    w = np.zeros((8, CLASSES), np.float32)
    w[:3] = ((cols + 2) / np.linalg.norm(cols + 2, axis=1, keepdims=True)).T
    params["classifier"] = conv(8, CLASSES, w, np.zeros(CLASSES))
    return {"params": params, "batch_stats": stats}


def _frames():
    """Two 240 x 320 centre crops of 3-object scenes; each object's mesh
    (1-based id -> (MESH, 3))."""
    frames, models = [], {}
    for seed in (0, 3):
        frame, mods = make_scene(num_objects=3, model_points=MESH, seed=seed)
        intr = dict(frame.intrinsics)
        intr["cx"] -= 160
        intr["cy"] -= 120
        frames.append(types.SimpleNamespace(
            color=np.ascontiguousarray(frame.color[120:360, 160:480]),
            depth=np.ascontiguousarray(frame.depth[120:360, 160:480]),
            label=np.ascontiguousarray(frame.label[120:360, 160:480]),
            poses=dict(frame.poses), intrinsics=intr))
        models.update(mods)
    return frames, models


def jax_words(key, obj_ids):
    """JAX's per-object key words: the choose subkey of fold_in(key, id)."""
    return np.stack([
        np.asarray(jax.random.key_data(jax.random.split(
            jax.random.fold_in(key, int(o)), 3)[0])).reshape(-1)[[0, -1]]
        for o in obj_ids]).astype(np.int64)


def jax_key_words(fi, obj_ids):
    """The words of JAX's full pipeline: fold_in(fold_in(key(0), frame), id)."""
    return jax_words(jax.random.fold_in(jax.random.key(0), fi), obj_ids)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    jpipe = JPipeline(num_points=N, num_objects=NUM_OBJ)
    shapes = jax.eval_shape(lambda k: jpipe.init(k, crop_hw=80, batch=1),
                            jax.random.key(0))
    variables = _numpy_variables(rng, shapes)
    pipe = DenseFusionPipeline(N, NUM_OBJ, device="cpu", seed=None)
    pipe.load_jax_variables(variables)
    jseg = JSegNet(num_classes=CLASSES, enc_blocks=SMALL)
    seg_vars = _colour_segnet_variables()
    seg = SegNet(CLASSES, SMALL).eval()
    seg.load_state_dict(segmenter_state_dict("segnet", seg_vars), strict=True)
    frames, models = _frames()
    return types.SimpleNamespace(jpipe=jpipe, variables=variables, pipe=pipe,
                                 jseg=jseg, seg_vars=seg_vars, seg=seg,
                                 frames=frames, models=models)


# ---------------- host mode against JAX ----------------


class NoisySegmenter:
    """A segmenter's labels: the ground truth with object 2 missed in the
    second frame and a stray blob of object 1 far from it."""

    def __init__(self, frames):
        self.frames = frames
        self.i = 0

    def reset(self):
        self.i = 0

    def __call__(self, color):
        fr = self.frames[self.i % len(self.frames)]
        lab = fr.label.copy()
        if self.i == 1:
            lab[lab == 2] = 0
        lab[5:12, 5:12] = 1
        self.i += 1
        return lab


def _posecnn_dir(tmp_path, frames):
    """results_PoseCNN-style .mat files: frame 0 detects objects 1 and 3
    (2 is lost); frame 1 detects 1, 2 and 3, where 3 has no ground truth
    there (an extra detection, estimated and exported)."""
    d = tmp_path / "posecnn"
    d.mkdir()
    for fi, (fr, dets) in enumerate(zip(frames, ((1, 3), (1, 2, 3)))):
        rois = []
        for o in dets:
            ys, xs = np.nonzero(fr.label == o)
            rois.append([0, o, xs.min() - 1, ys.min() - 1, xs.max() + 2,
                         ys.max() + 2])
        sio.savemat(d / f"{fi:06d}.mat",
                    {"labels": fr.label.astype(np.int32),
                     "rois": np.asarray(rois, np.float32),
                     "poses": np.zeros((len(dets), 7), np.float32)})
    return str(d)


def _mat(path):
    m = sio.loadmat(path)
    return (np.atleast_2d(np.asarray(m["poses"], np.float64)),
            np.asarray(m["cls_indexes"]).reshape(-1))


@pytest.mark.parametrize("mode", ["gt", "segmenter", "posecnn"])
def test_host_mode_matches_jax(case, mode, tmp_path):
    frames, models = case.frames, case.models
    jframes = frames
    if mode == "posecnn":
        # frame 1's object 3 has no ground truth: a detection of it is extra
        frames = [frames[0], types.SimpleNamespace(
            **{**vars(frames[1]), "poses": {o: p for o, p in
                                            frames[1].poses.items() if o != 3}})]
        jframes = frames
        d = _posecnn_dir(tmp_path, frames)
        seg_t, seg_j = PoseCNNMasks(d), __import__(
            "plr2_tpu.data.posecnn", fromlist=["PoseCNNMasks"]).PoseCNNMasks(d)
    elif mode == "segmenter":
        seg_t, seg_j = NoisySegmenter(frames), NoisySegmenter(frames)
    else:
        seg_t = seg_j = None
    want = j_fp.evaluate_full_pipeline(
        case.jpipe, case.variables, jframes, models, SYM,
        refine_iterations=ITERS, seg_predict=seg_j, crop_canvas=CANVAS,
        save_mat_dir=str(tmp_path / "jax"))
    got = t_fp.evaluate_full_pipeline(
        case.pipe, frames, models, SYM, refine_iterations=ITERS,
        seg_predict=seg_t, crop_canvas=CANVAS,
        save_mat_dir=str(tmp_path / "port"), key_words=jax_key_words)
    expect = {"gt": (0, 0), "segmenter": (1, 0), "posecnn": (1, 1)}[mode]
    assert (got.lost_detections, got.extra_detections) == expect
    assert (want.lost_detections, want.extra_detections) == expect
    assert (got.num_objects, got.num_frames) == (want.num_objects,
                                                 want.num_frames)
    assert sorted(got.per_object_distances) == sorted(want.per_object_distances)
    for o, d in want.per_object_distances.items():
        g = np.asarray(got.per_object_distances[o])
        assert np.array_equal(np.isinf(g), np.isinf(d))
        np.testing.assert_allclose(g[np.isfinite(g)],
                                   np.asarray(d)[np.isfinite(d)], atol=POSE_TOL)
    assert abs(got.mean_distance - want.mean_distance) <= POSE_TOL
    for fi in range(2):
        gp, gc = _mat(tmp_path / "port" / f"{fi:06d}.mat")
        wp, wc = _mat(tmp_path / "jax" / f"{fi:06d}.mat")
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gp, wp, atol=POSE_TOL)
    if mode == "posecnn":
        assert list(_mat(tmp_path / "port" / "000001.mat")[1]) == [1, 2, 3]


# ---------------- device mode against host mode ----------------


def test_device_mode_matches_host_mode(case, tmp_path):
    frames = list(case.frames)
    # a third frame where object 3 is too small: lost in both modes
    small = types.SimpleNamespace(**vars(frames[0]))
    small.label = np.where(small.label == 3, 0, small.label)
    small.label[0:5, 0:5] = 3
    frames.append(small)
    res = {dev: t_fp.evaluate_full_pipeline(
        case.pipe, frames, case.models, SYM, refine_iterations=ITERS,
        crop_canvas=CANVAS, device_pipeline=dev,
        save_mat_dir=str(tmp_path / str(dev))) for dev in (False, True)}
    host, device = res[False], res[True]
    assert host.lost_detections == device.lost_detections == 1
    assert host.num_objects == device.num_objects == 9
    for o, d in host.per_object_distances.items():
        np.testing.assert_allclose(device.per_object_distances[o], d, atol=1e-5)
    for fi in range(3):
        hp, hc = _mat(tmp_path / "False" / f"{fi:06d}.mat")
        dp, dc = _mat(tmp_path / "True" / f"{fi:06d}.mat")
        np.testing.assert_array_equal(hc, dc)
        np.testing.assert_allclose(hp, dp, atol=1e-5)


def test_device_mode_segments_inside_the_program(case):
    """Device mode with the segmenter inside the frame program equals
    device mode fed that segmenter's label maps."""
    fe = FrameEstimator(case.pipe, canvas=CANVAS, img_h=H, img_w=W,
                        seg_model=case.seg)
    maps = iter([fe._segment(torch.from_numpy(f.color)[None])[0].numpy()
                 for f in case.frames])
    inside, fed = (t_fp.evaluate_full_pipeline(
        case.pipe, case.frames, case.models, SYM, refine_iterations=ITERS,
        crop_canvas=CANVAS, device_pipeline=True, **kw)
        for kw in ({"seg_model": case.seg, "seg_variables": case.seg.state_dict()},
                   {"seg_predict": lambda color: next(maps)}))
    assert inside.per_object_distances == fed.per_object_distances
    assert inside.lost_detections == fed.lost_detections == 0


def test_a_frame_without_objects(case, tmp_path):
    empty = types.SimpleNamespace(**vars(case.frames[0]))
    empty.label = np.zeros_like(empty.label)
    for dev in (False, True):
        res = t_fp.evaluate_full_pipeline(
            case.pipe, [empty], case.models, SYM, refine_iterations=ITERS,
            crop_canvas=CANVAS, device_pipeline=dev,
            save_mat_dir=str(tmp_path / str(dev)))
        assert res.lost_detections == 3 and res.per_frame_poses == [{}]
        assert res.auc == 0.0 and res.mean_distance == float("inf")


# ---------------- FrameEstimator with a segmenter ----------------


@pytest.fixture(scope="module")
def seg_frame(case):
    """Frame 0 and its slots: the three objects and an inactive one. The
    segmenter labels each object's pixels with its id (but for a few
    pixels at the edges, where the pool mixes colours)."""
    fr = case.frames[0]
    fe = FrameEstimator(case.pipe, canvas=CANVAS, img_h=H, img_w=W,
                        refine_iterations=ITERS, seg_model=case.seg)
    labels = fe._segment(torch.from_numpy(fr.color)[None])[0].numpy()
    assert (labels == fr.label).mean() > 0.99
    return fr, np.array([1, 2, 3, 0], np.int64)


@pytest.mark.parametrize("scale", [1, 2])
def test_frame_estimator_segmenter_matches_jax(case, seg_frame, scale):
    fr, obj_ids = seg_frame
    jfe = JFrameEstimator(case.jpipe, canvas=CANVAS, img_h=H, img_w=W,
                          refine_iterations=ITERS, seg_model=case.jseg,
                          seg_scale=scale)
    fe = FrameEstimator(case.pipe, canvas=CANVAS, img_h=H, img_w=W,
                        refine_iterations=ITERS, seg_model=case.seg,
                        seg_scale=scale)
    want_lab = np.asarray(jax.jit(jfe._segment)(case.seg_vars,
                                                jnp.asarray(fr.color[None])))
    got_lab = fe._segment(torch.from_numpy(fr.color)[None]).numpy()
    assert got_lab.shape == (1, H, W) and got_lab.dtype == np.int32
    np.testing.assert_array_equal(got_lab, want_lab)
    mps = np.stack([case.models[max(int(o), 1)] for o in obj_ids]).astype(np.float32)
    intr = np.asarray([fr.intrinsics[k] for k in INTR_KEYS], np.float32)
    key = jax.random.key(5)
    jposes = jfe.run(case.variables, jnp.asarray(fr.color),
                     jnp.asarray(fr.depth, jnp.float32),
                     jnp.zeros((H, W), jnp.int32), jnp.asarray(obj_ids, jnp.int32),
                     jnp.asarray(mps), jnp.asarray(intr), key,
                     seg_variables=case.seg_vars)
    got = fe.run(fr.color, fr.depth.astype(np.float32), None, obj_ids, mps,
                 intr, key_words=jax_words(key, obj_ids))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(jposes.valid))
    assert got.valid.tolist() == [True, True, True, False]
    v = got.valid.numpy()
    np.testing.assert_allclose(got.quat.numpy()[v], np.asarray(jposes.quat)[v],
                               atol=POSE_TOL)
    np.testing.assert_allclose(got.trans.numpy()[v], np.asarray(jposes.trans)[v],
                               atol=POSE_TOL)


def test_segment_frame_matches_jax_and_the_estimator(case, seg_frame):
    """segment_frame (SegTrainer.predict) equals JAX's, and the frame
    program's labels at s = 1."""
    fr, _ = seg_frame
    jt = JSegTrainer(num_classes=CLASSES)
    jt.model = case.jseg
    want = j_fp.segment_frame(jt, {"variables": case.seg_vars}, fr.color)
    tt = SegTrainer(num_classes=CLASSES, device="cpu")
    tt.model = case.seg
    got = t_fp.segment_frame(tt, fr.color)
    np.testing.assert_array_equal(got, want)
    fe = FrameEstimator(case.pipe, canvas=CANVAS, img_h=H, img_w=W,
                        seg_model=case.seg)
    assert np.array_equal(fe._segment(torch.from_numpy(fr.color)[None])[0]
                          .numpy(), got)


def _eager_capture(log):
    """A stand-in for `serving._capture` on the CPU: a "replay" reruns the
    program on the static inputs and copies into the static outputs."""
    def capture(fn, args):
        static = tuple(None if a is None else a.clone() for a in args)
        out = fn(*static)
        log.append(1)

        class Replay:
            @staticmethod
            def replay():
                for o, n in zip(out, fn(*static)):
                    o.copy_(n)
        return Graph(Replay, static, out)
    return capture


def test_segmenter_graph_knobs_and_weights(case, seg_frame, monkeypatch):
    """seg_scale and the segmenter's dtype key the graphs; seg_variables
    are copied into the captured parameters (same storage, new values on
    the next replay); casting the segmenter drops the graphs."""
    log = []
    monkeypatch.setattr(serving, "_capture", _eager_capture(log))
    fr, obj_ids = seg_frame
    seg = SegNet(CLASSES, SMALL).eval()
    seg.load_state_dict(case.seg.state_dict())
    fe = FrameEstimator(case.pipe, canvas=CANVAS, img_h=H, img_w=W,
                        refine_iterations=ITERS, seg_model=seg)
    fe.graphs = True
    mps = np.stack([case.models[max(int(o), 1)] for o in obj_ids]).astype(np.float32)
    intr = np.asarray([fr.intrinsics[k] for k in INTR_KEYS], np.float32)
    args = (fr.color, fr.depth.astype(np.float32), fr.label, obj_ids, mps, intr, 0)
    first = fe.run(*args)
    assert len(log) == 1
    key = next(iter(fe._graphs))
    assert key[6:] == (1, torch.float32)
    assert key[5][2] is None  # the label map is not an input with a segmenter
    ptr = seg.classifier.weight.data_ptr()
    other = {k: (v if "running" in k or "num_batches" in k else -v)
             for k, v in case.seg.state_dict().items()}
    flipped = fe.run(*args, seg_variables=other)
    assert len(log) == 1 and seg.classifier.weight.data_ptr() == ptr
    assert torch.equal(seg.classifier.weight, other["classifier.weight"])
    eager = FrameEstimator(case.pipe, canvas=CANVAS, img_h=H, img_w=W,
                           refine_iterations=ITERS, seg_model=seg).run(*args)
    for a, b in zip(flipped, eager):
        assert torch.equal(a, b)
    assert not torch.equal(first.valid, flipped.valid) or \
        not torch.equal(first.quat, flipped.quat)
    seg.to(torch.bfloat16)
    fe.run(*args)
    assert len(log) == 2 and len(fe._graphs) == 1
    assert next(iter(fe._graphs))[7] == torch.bfloat16


def test_refusals(case):
    with pytest.raises(ValueError, match="seg_scale"):
        FrameEstimator(case.pipe, seg_model=case.seg, seg_scale=0)
    fe = FrameEstimator(case.pipe, canvas=CANVAS, img_h=H, img_w=W)
    fr = case.frames[0]
    with pytest.raises(ValueError, match="without seg_model"):
        fe.run(fr.color, fr.depth, fr.label, np.array([1]),
               np.zeros((1, 8, 3), np.float32), np.ones(5, np.float32),
               seg_variables={})


# ---------------- YCB keyframes ----------------


def test_ycb_frames_and_models_match_jax(ycb_root):
    from plr2_tpu.data.ycb import YCBDataset as JYCB
    from plr2_tpu_torch.data import YCBDataset

    want_f, want_m = j_fp.ycb_frames_and_models(
        JYCB(ycb_root, "test", 96, 128, add_noise=False))
    got_f, got_m = t_fp.ycb_frames_and_models(
        YCBDataset(ycb_root, "test", 96, 128, add_noise=False))
    assert len(got_f) == len(want_f) > 0 and sorted(got_m) == sorted(want_m)
    for o in want_m:
        np.testing.assert_array_equal(got_m[o], want_m[o])
    for g, w in zip(got_f, want_f):
        for f in ("color", "depth", "label"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert g.intrinsics == w.intrinsics and sorted(g.poses) == sorted(w.poses)
        for o, (r, t) in w.poses.items():
            np.testing.assert_array_equal(g.poses[o][0], r)
            np.testing.assert_array_equal(g.poses[o][1], t)
    assert len(t_fp.ycb_frames_and_models(
        YCBDataset(ycb_root, "test", 96, 128, add_noise=False), 1)[0]) == 1
