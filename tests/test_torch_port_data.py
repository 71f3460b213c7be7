"""The port's synthetic data path against the JAX package's: choose
sampling (bit-equal, given the same key words), the geometry the samples
need, the colour-jitter ops, `preprocess_crop` given the same draws, bbox
snapping, batch stacking and the synthetic datasets' raw frames."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plr2_tpu.data import bbox as j_bbox
from plr2_tpu.data import loader as j_loader
from plr2_tpu.data import preprocess as j_pre
from plr2_tpu.data import synthetic as j_synth
from plr2_tpu.geometry import pointcloud as j_pc
from plr2_tpu.geometry import quaternion as j_quat
from plr2_tpu_torch import geometry as t_geo
from plr2_tpu_torch.data import bbox as t_bbox
from plr2_tpu_torch.data import loader as t_loader
from plr2_tpu_torch.data import preprocess as t_pre
from plr2_tpu_torch.data import synthetic as t_synth

torch.set_num_threads(2)


def key_words(key):
    """The two words of a JAX key that `_coord_scores` reads."""
    kd = np.asarray(jax.random.key_data(key)).reshape(-1).astype(np.uint32)
    return int(kd[0]), int(kd[-1])


def _np(x):
    return np.array(x)  # a writable copy


# ---------------- choose sampling ----------------


def test_coord_scores_bit_equal_to_jax():
    key = jax.random.key(3)
    want = _np(j_pre._coord_scores(key, 37, 53))
    got = t_pre.coord_scores(key_words(key), 37, 53)
    np.testing.assert_array_equal(got.numpy(), want)


# (mask size, masked count, num_points, window width): the four regimes of
# tests/test_data.py:85-119, on 2-D windows so the hash's (row, col) matters
REGIMES = {"subsample": (20 * 30, 400, 96, 30), "wrap": (20 * 30, 7, 20, 30),
           "empty": (20 * 30, 0, 20, 30), "exact": (10 * 10, 20, 20, 10)}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_sample_choose_bit_equal_to_jax(regime):
    p, count, n, width = REGIMES[regime]
    rng = np.random.default_rng(len(regime))
    mask = np.zeros(p, bool)
    mask[rng.choice(p, count, replace=False)] = True
    for seed in range(4):
        key = jax.random.key(seed)
        want = _np(j_pre.sample_choose(jnp.asarray(mask), n, key, width=width))
        got = t_pre.sample_choose(torch.from_numpy(mask), n, key_words(key),
                                  width=width)
        assert got.dtype == torch.int64 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sample_choose_score_ties_take_the_lowest_index(monkeypatch):
    """Scores with many ties (1 on every third pixel, else 0): JAX's top_k
    keeps the lowest indices among equal scores, and so does the port's
    stable sort."""
    def tied(p):
        return np.arange(p) % 3 == 0
    monkeypatch.setattr(j_pre, "_coord_scores", lambda key, h, w: jnp.asarray(
        tied(h * w), jnp.int32))
    monkeypatch.setattr(t_pre, "coord_scores", lambda kw, h, w, device=None:
                        torch.from_numpy(tied(h * w)).long())
    mask = np.ones(91, bool)  # a shape no other test traces
    mask[[0, 5, 9, 40]] = False
    want = _np(j_pre.sample_choose(jnp.asarray(mask), 45, jax.random.key(0),
                                   width=13))
    got = t_pre.sample_choose(torch.from_numpy(mask), 45, (0, 0), width=13)
    np.testing.assert_array_equal(got.numpy(), want)
    # all 29 score-1 pixels, then the lowest 16 masked score-0 ones
    ones = [i for i in range(91) if tied(91)[i] and mask[i]]
    assert set(ones) <= set(want.tolist())


# ---------------- geometry ----------------


def test_geometry_matches_jax():
    rng = np.random.default_rng(1)
    depth = rng.uniform(500, 1500, 50).astype(np.float32)
    ys = rng.uniform(0, 480, 50).astype(np.float32)
    xs = rng.uniform(0, 640, 50).astype(np.float32)
    intr = (325.2611, 242.04899, 572.4114, 573.57043, 1000.0)
    want = j_pc.backproject_depth(*map(jnp.asarray, (depth, ys, xs)), *intr)
    got = t_geo.backproject_depth(*map(torch.from_numpy, (depth, ys, xs)), *intr)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6, rtol=0)

    pts = (rng.normal(size=(3, 40, 3)) * 0.05).astype(np.float32)
    q = rng.normal(size=(3, 4)).astype(np.float32)
    t = (rng.normal(size=(3, 3)) * 0.1).astype(np.float32)
    jq, tq = jnp.asarray(q), torch.from_numpy(q)
    rot = j_quat.quat_to_matrix(jq)
    np.testing.assert_allclose(t_geo.quat_to_matrix(tq).numpy(), _np(rot),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        t_geo.transform_points(torch.from_numpy(pts), torch.from_numpy(_np(rot)),
                               torch.from_numpy(t)).numpy(),
        _np(j_pc.transform_points(jnp.asarray(pts), rot, jnp.asarray(t))),
        atol=1e-6, rtol=0)
    qn = _np(j_quat.normalize_quaternion(jq))
    np.testing.assert_allclose(
        t_geo.apply_pose_quat(torch.from_numpy(pts), torch.from_numpy(qn),
                              torch.from_numpy(t)).numpy(),
        _np(j_pc.apply_pose_quat(jnp.asarray(pts), jnp.asarray(qn),
                                 jnp.asarray(t))), atol=1e-6, rtol=0)
    # matrix_to_quat on every pivot branch: rotations near identity and
    # near 180 degrees about each axis
    mats = np.concatenate([_np(rot), np.diag([1, -1, -1])[None],
                           np.diag([-1, 1, -1])[None],
                           np.diag([-1, -1, 1])[None]]).astype(np.float32)
    np.testing.assert_allclose(
        t_geo.matrix_to_quat(torch.from_numpy(mats)).numpy(),
        _np(j_quat.matrix_to_quat(jnp.asarray(mats))), atol=1e-6, rtol=0)


def test_transformations_copy_is_the_reference_module():
    from plr2_tpu.geometry import transformations as j_tfs
    from plr2_tpu_torch.geometry import transformations as t_tfs
    rand = np.random.default_rng(2).random(3)
    np.testing.assert_array_equal(t_tfs.random_rotation_matrix(rand),
                                  j_tfs.random_rotation_matrix(rand))
    q = t_tfs.quaternion_from_euler(0.3, -0.2, 1.1)
    np.testing.assert_array_equal(q, j_tfs.quaternion_from_euler(0.3, -0.2, 1.1))
    np.testing.assert_array_equal(t_tfs.quaternion_multiply(q, q),
                                  j_tfs.quaternion_multiply(q, q))


# ---------------- colour jitter ----------------


def _img01(seed=0, shape=(12, 17, 3)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    x[0, :4] = 0.5  # grey pixels: the HSV eqc branch
    x[1, :3] = [1.0, 0.0, 0.0]
    return x


@pytest.mark.parametrize("op", ["adjust_brightness", "adjust_contrast",
                                "adjust_saturation", "adjust_hue"])
def test_jitter_op_matches_jax(op):
    x = _img01(1)
    for f in ((0.8, 1.2, 1.05) if op != "adjust_hue" else (-0.05, 0.03, 0.049)):
        want = getattr(j_pre, op)(jnp.asarray(x), jnp.float32(f))
        got = getattr(t_pre, op)(torch.from_numpy(x), torch.tensor(f))
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)


def test_jitter_in_jax_order_matches_jax():
    x = _img01(2)
    for seed in range(3):
        key = jax.random.key(seed)
        kperm, kb, kc, ks, kh = jax.random.split(key, 5)
        factors = jnp.stack([
            jax.random.uniform(kb, (), minval=0.8, maxval=1.2),
            jax.random.uniform(kc, (), minval=0.8, maxval=1.2),
            jax.random.uniform(ks, (), minval=0.8, maxval=1.2),
            jax.random.uniform(kh, (), minval=-0.05, maxval=0.05)])
        order = jax.random.permutation(kperm, jnp.arange(4, dtype=jnp.int32))
        want = j_pre.color_jitter(jnp.asarray(x), key)
        got = t_pre.apply_jitter_ops(torch.from_numpy(x),
                                     torch.from_numpy(_np(factors)),
                                     torch.from_numpy(_np(order)))
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)


def test_draws_are_seeded_and_in_range():
    a = t_pre.draw(torch.Generator().manual_seed(4))
    b = t_pre.draw(torch.Generator().manual_seed(4))
    assert a.key_words == b.key_words and torch.equal(a.factors, b.factors)
    assert sorted(a.order.tolist()) == [0, 1, 2, 3]
    assert bool(((a.factors[:3] >= 0.8) & (a.factors[:3] <= 1.2)).all())
    assert abs(float(a.factors[3])) <= 0.05
    assert bool((a.add_t.abs() <= 0.03).all())
    assert all(0 <= k < 2 ** 32 for k in a.key_words)
    # color_jitter applies one draw's factors in its order
    x = torch.from_numpy(_img01(3))
    np.testing.assert_array_equal(
        t_pre.color_jitter(x, torch.Generator().manual_seed(4)).numpy(),
        t_pre.apply_jitter_ops(x, a.factors, a.order).numpy())


def test_normalize_image_matches_jax():
    img = np.random.default_rng(4).integers(0, 256, (9, 7, 3)).astype(np.uint8)
    np.testing.assert_allclose(
        t_pre.normalize_image(torch.from_numpy(img)).numpy(),
        _np(j_pre.normalize_image(jnp.asarray(img))), atol=1e-6, rtol=0)


# ---------------- preprocess_crop and the datasets ----------------


def _jax_draws(key, noise_trans=0.03):
    """The draws JAX's preprocess_crop makes from `key`, as port Draws."""
    k_choose, k_jit, k_trans = jax.random.split(key, 3)
    kperm, kb, kc, ks, kh = jax.random.split(k_jit, 5)
    factors = jnp.stack([
        jax.random.uniform(kb, (), minval=0.8, maxval=1.2),
        jax.random.uniform(kc, (), minval=0.8, maxval=1.2),
        jax.random.uniform(ks, (), minval=0.8, maxval=1.2),
        jax.random.uniform(kh, (), minval=-0.05, maxval=0.05)])
    order = jax.random.permutation(kperm, jnp.arange(4, dtype=jnp.int32))
    add_t = jax.random.uniform(k_trans, (3,), minval=-noise_trans,
                               maxval=noise_trans)
    return t_pre.Draws(key_words(k_choose), torch.from_numpy(_np(factors)),
                       torch.from_numpy(_np(order)).long(),
                       torch.from_numpy(_np(add_t)))


@pytest.fixture(scope="module")
def pose_ds():
    return (j_loader.SyntheticPoseDataset(num_frames=2, num_objects=2,
                                          model_points=128, num_points=96,
                                          seed=0),
            t_loader.SyntheticPoseDataset(num_frames=2, num_objects=2,
                                          model_points=128, num_points=96,
                                          seed=0))


@pytest.mark.parametrize("add_noise", [False, True], ids=["plain", "noise"])
def test_raw_to_sample_matches_jax_given_the_same_draws(pose_ds, add_noise):
    jds, tds = pose_ds
    for i in range(len(tds)):
        key = jax.random.key(10 + i)
        want = j_loader.raw_to_sample(jds.get_raw(i), key, 96,
                                      add_noise=add_noise)
        got = t_loader.raw_to_sample(tds.get_raw(i), _jax_draws(key), 96,
                                     add_noise=add_noise)
        np.testing.assert_array_equal(got.choose.numpy(), _np(want.choose))
        np.testing.assert_allclose(got.points.numpy(), _np(want.points),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.target.numpy(), _np(want.target),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.img.numpy(), _np(want.img),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got.model_points.numpy(),
                                      _np(want.model_points))
        assert int(got.idx) == int(want.idx)


def test_synthetic_datasets_raw_arrays_equal_jax(pose_ds):
    jds, tds = pose_ds
    lib_j = j_synth.make_model_library(5, 64, sym_ids=(2, 4))
    lib_t = t_synth.make_model_library(5, 64, sym_ids=(2, 4))
    scene = (j_loader.SyntheticSceneDataset(lib_j, num_frames=2,
                                            objects_per_frame=3, seed=3),
             t_loader.SyntheticSceneDataset(lib_t, num_frames=2,
                                            objects_per_frame=3, seed=3))
    for a, b in (pose_ds, scene):
        assert len(a) == len(b) and a.diameters == b.diameters
        for i in range(len(a)):
            ra, rb = a.get_raw(i), b.get_raw(i)
            assert set(ra) == set(rb)
            for k in ra:
                if k == "intrinsics":
                    assert ra[k] == rb[k]
                else:
                    np.testing.assert_array_equal(np.asarray(ra[k]),
                                                  np.asarray(rb[k]), err_msg=k)


def test_bbox_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        mask = np.zeros((480, 640), bool)
        r0, c0 = rng.integers(0, 470), rng.integers(0, 630)
        mask[r0:r0 + rng.integers(1, 300), c0:c0 + rng.integers(1, 400)] = True
        assert t_bbox.get_bbox_from_mask(mask) == j_bbox.get_bbox_from_mask(mask)
    assert t_bbox.get_bbox_from_mask(np.zeros((480, 640), bool)) == (0, 40, 0, 40)
    assert t_bbox.BORDER_LIST == j_bbox.BORDER_LIST


def test_stack_samples_matches_jax(pose_ds):
    jds, tds = pose_ds
    keys = [jax.random.key(20 + i) for i in range(3)]
    js = [j_loader.raw_to_sample(jds.get_raw(i), k, 96) for i, k in enumerate(keys)]
    ts = [t_loader.raw_to_sample(tds.get_raw(i), _jax_draws(k), 96)
          for i, k in enumerate(keys)]
    want = j_loader.stack_samples(js, crop=160)
    got = t_loader.stack_samples(ts, crop=160)
    for name in ("choose", "idx", "model_points"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(want, name)), err_msg=name)
    for name in ("img", "points", "target"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   _np(getattr(want, name)), atol=1e-5,
                                   rtol=0, err_msg=name)
    with pytest.raises(ValueError, match="exceeds canvas"):
        t_loader.stack_samples(ts, crop=40)


def test_iterate_samples_is_seeded_and_shuffles_as_jax(pose_ds):
    _, tds = pose_ds
    order = np.arange(len(tds))
    np.random.default_rng(7).shuffle(order)
    a = list(t_loader.iterate_samples(tds, torch.Generator().manual_seed(1), 96,
                                      add_noise=True, shuffle=True, seed=7))
    b = list(t_loader.iterate_samples(tds, torch.Generator().manual_seed(1), 96,
                                      add_noise=True, shuffle=True, seed=7))
    assert [int(s.idx) for s in a] == [tds.get_raw(int(i))["obj_idx"] for i in order]
    for x, y in zip(a, b):
        assert torch.equal(x.img, y.img) and torch.equal(x.choose, y.choose)


def test_config_copy_matches_the_reference():
    """The port's own config: the same dataclasses, fields, defaults and
    presets as the JAX package's."""
    import dataclasses
    from plr2_tpu import config as j_cfg
    from plr2_tpu_torch import config as t_cfg
    for name in ("DatasetConfig", "ModelConfig", "TrainConfig", "PipelineConfig"):
        a, b = getattr(j_cfg, name), getattr(t_cfg, name)
        assert [(f.name, f.type) for f in dataclasses.fields(a)] == [
            (f.name, f.type) for f in dataclasses.fields(b)], name
        assert dataclasses.asdict(a()) == dataclasses.asdict(b()), name
    assert sorted(j_cfg.PRESETS) == sorted(t_cfg.PRESETS)
    for name in j_cfg.PRESETS:
        assert dataclasses.asdict(j_cfg.get_preset(name)) == dataclasses.asdict(
            t_cfg.get_preset(name)), name
    with pytest.raises(KeyError, match="unknown preset"):
        t_cfg.get_preset("nope")
