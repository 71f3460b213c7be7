"""The port's real-data path against the JAX package's and against PIL and
PyYAML: the PNG and YAML readers (`data/codecs.py`), the native data plane
(`plr2_tpu_torch.native`, bit for bit with `plr2_tpu.native`), the LineMOD,
YCB-Video and PoseCNN loaders and the frame cache on the miniature on-disk
layouts of tests/test_real_loaders.py, `host_prepare` / `host_prepare_raw`,
`finish_sample` given JAX's draws, the prefetcher at 0 workers, in threads
and in spawned processes, a `Trainer` epoch fed by worker threads, and the
loaders on a host without PIL, PyYAML or JAX."""

import os
import pickle
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from plr2_tpu import native as j_native
from plr2_tpu.data import frame_cache as j_fc
from plr2_tpu.data import linemod as j_lm
from plr2_tpu.data import posecnn as j_pc
from plr2_tpu.data import prefetch as j_pf
from plr2_tpu.data import ycb as j_ycb
from plr2_tpu_torch import native as t_native
from plr2_tpu_torch.data import codecs
from plr2_tpu_torch.data import frame_cache as t_fc
from plr2_tpu_torch.data import linemod as t_lm
from plr2_tpu_torch.data import posecnn as t_pc
from plr2_tpu_torch.data import prefetch as t_pf
from plr2_tpu_torch.data import ycb as t_ycb
from plr2_tpu_torch.data.preprocess import Draws
from test_real_loaders import linemod_root, ycb_root  # noqa: F401  (fixtures)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_PTS, MESH = 96, 128


def _np(x):
    return np.array(x)


def same_raw(a, b):
    """Two raw dicts equal key for key, every array bit for bit."""
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


# ---------------- PNG ----------------

RNG = np.random.default_rng(0)
IMAGES = {"L8": RNG.integers(0, 256, (13, 17), dtype=np.uint8),
          "RGB8": RNG.integers(0, 256, (13, 17, 3), dtype=np.uint8),
          "LA8": RNG.integers(0, 256, (13, 17, 2), dtype=np.uint8),
          "RGBA8": RNG.integers(0, 256, (13, 17, 4), dtype=np.uint8),
          "L16": RNG.integers(0, 65536, (13, 17), dtype=np.uint16),
          "RGB16": RNG.integers(0, 65536, (13, 17, 3), dtype=np.uint16),
          "RGBA16": RNG.integers(0, 65536, (13, 17, 4), dtype=np.uint16)}


def same_as_pil(path, rgb=True):
    im = Image.open(path)
    want, got = np.asarray(im), codecs.read_png(path)
    assert (got.dtype, got.shape) == (want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)
    if rgb:
        want = np.asarray(Image.open(path).convert("RGB"))
        got = codecs.read_png(path, "RGB")
        assert (got.dtype, got.shape) == (want.dtype, want.shape)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(IMAGES))
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_read_png_equals_pil_on_every_filter(name, filters, tmp_path):
    path = tmp_path / "x.png"
    codecs.write_png(path, IMAGES[name], filters=filters)
    same_as_pil(path, rgb=IMAGES[name].dtype == np.uint8)


def test_read_png_equals_pil_on_palettes_and_pil_files(tmp_path):
    pal = RNG.integers(0, 256, (7, 3), dtype=np.uint8)
    idx = RNG.integers(0, 9, (13, 17), dtype=np.uint8)  # 7, 8: beyond PLTE
    for f in range(5):
        codecs.write_png(tmp_path / "p.png", idx, filters=(f,), palette=pal)
        same_as_pil(tmp_path / "p.png")
    for name in ("RGB8", "L8", "L16", "RGBA8", "LA8"):
        Image.fromarray(IMAGES[name]).save(tmp_path / "q.png")
        same_as_pil(tmp_path / "q.png", rgb=name != "L16")
    big = Image.fromarray(RNG.integers(0, 200, (13, 17), dtype=np.uint8), "P")
    big.putpalette(RNG.integers(0, 256, 768, dtype=np.uint8).tolist())
    big.save(tmp_path / "p8.png")  # a 200-colour palette: 8 bits a pixel
    same_as_pil(tmp_path / "p8.png")


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    # an Adam7 header (PIL writes none): the interlace byte of IHDR, and its CRC
    codecs.write_png(tmp_path / "i.png", IMAGES["RGB8"])
    blob = bytearray((tmp_path / "i.png").read_bytes())
    blob[28] = 1
    blob[29:33] = struct.pack(">I", zlib.crc32(bytes(blob[12:29])) & 0xFFFFFFFF)
    (tmp_path / "i.png").write_bytes(bytes(blob))
    assert Image.open(tmp_path / "i.png").info.get("interlace") == 1
    with pytest.raises(ValueError, match="i.png.*interlaced"):
        codecs.read_png(tmp_path / "i.png")
    small = Image.fromarray(IMAGES["L8"] % 9, "P")
    small.putpalette(list(range(27)))
    small.save(tmp_path / "p4.png")  # 9 colours: PIL writes 4 bits a pixel
    with pytest.raises(ValueError, match="p4.png.*bit depth 4"):
        codecs.read_png(tmp_path / "p4.png")
    Image.fromarray(IMAGES["L8"] > 128).save(tmp_path / "b1.png")
    with pytest.raises(ValueError, match="bit depth 1"):
        codecs.read_png(tmp_path / "b1.png")
    codecs.write_png(tmp_path / "d.png", IMAGES["L16"])
    with pytest.raises(ValueError, match="16-bit"):
        codecs.read_png(tmp_path / "d.png", "RGB")
    (tmp_path / "n.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        codecs.read_png(tmp_path / "n.png")


# ---------------- YAML ----------------

UPSTREAM_YAML = {
    "gt": """0:
- cam_R_m2c: [0.09630630, 0.99404401, 0.05100790, 0.67332804, -0.10347100, 0.73200500, 0.73224497, -0.03701720, -0.67916402]
  cam_t_m2c: [-105.35775150, -117.52119142, 1014.87701320]
  obj_bb: [244, 150, 44, 58]
  obj_id: 1
1:
- cam_R_m2c: [0.08273940, 0.99541402, 0.04791520,
    0.67097902, -0.09080610, 0.73588598, 0.73583800, -0.02789110, -0.67548198]  # wrapped
  cam_t_m2c: [-121.06947975, -117.42728745, 996.87958770]
  obj_bb: [239, 142, 46, 60]
  obj_id: 1
- {cam_R_m2c: [1, 0, 0, 0, 1, 0, 0, 0, 1], cam_t_m2c: [0, 0, 500], obj_id: 2}
""",
    "models_info": """# diameters in mm
1: {diameter: 102.09865663, min_x: -37.93430000, min_y: -38.79960000, min_z: -45.88450000, size_x: 75.86860000, size_y: 77.59920000, size_z: 91.76900000}
10: {diameter: 164.62757999, min_x: -50.39580000, min_y: -90.89790000, min_z: -96.86700000}
""",
    "info": """0:
  cam_K: [572.4114, 0.0, 325.2611, 0.0, 573.57043, 242.04899, 0.0, 0.0, 1.0]
  depth_scale: 1.0
1:
  cam_K: [572.4114, 0.0, 325.2611, 0.0, 573.57043, 242.04899, 0.0, 0.0, 1.0]
  depth_scale: 1.0
""",
    "scalars": """---
a: yes
b: Off
c: ~
d: 0x1F
e: 017
f: -.inf
h: 1_000
i: 'single ''q'''
j: "double \\"q\\" \\u00e9"
k: [a, 'b, c', {x: 1, y: [2, 3]}]
l: -1.5e+3
m: 1e5
n: 09
o:
  - - 1
    - 2
  - - 3
p: {}
q: []
r: http://x.y/z
""",
}


@pytest.mark.parametrize("name", sorted(UPSTREAM_YAML))
def test_parse_yaml_equals_pyyaml_on_upstream_text(name):
    text = UPSTREAM_YAML[name]
    assert repr(codecs.parse_yaml(text)) == repr(yaml.safe_load(text))


def test_read_yaml_equals_pyyaml_on_the_fixture_files(linemod_root, tmp_path):
    for rel in ("data/01/gt.yml", "data/01/info.yml", "models/models_info.yml"):
        path = os.path.join(linemod_root, rel)
        with open(path) as f:
            assert repr(codecs.read_yaml(path)) == repr(yaml.safe_load(f)), rel
    doc = {0: [{"obj_id": 1, "cam_R_m2c": [0.1, 1e-5, -2.0] * 3}],
           3: {"depth_scale": 1.0, "name": "a b", "q": "it's", "e": "",
               "n": None, "t": True, "x": ["k: v", "#", "-"]}}
    for flow in (False, None):
        (tmp_path / "d.yml").write_text(yaml.safe_dump(doc, default_flow_style=flow))
        assert codecs.read_yaml(tmp_path / "d.yml") == doc


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  x\n", "a: >\n  x\n",
    "a: 1\n---\nb: 2\n", "? a\n: 1\n", "a: 2001-12-14\n", "a: 1:30\n",
    "%YAML 1.1\n---\na: 1\n", "a: [1, 2\n"],
    ids=["anchor", "tag", "literal", "folded", "documents", "complex_key",
         "timestamp", "sexagesimal", "directive", "unterminated"])
def test_parse_yaml_refuses_what_it_does_not_read(text, tmp_path):
    (tmp_path / "bad.yml").write_text(text)
    with pytest.raises(ValueError, match="bad.yml"):
        codecs.read_yaml(tmp_path / "bad.yml")


# ---------------- the native data plane ----------------


def _masks():
    """Seeded masks: blobs, sparse pixels, the empty mask, masks touching
    each image edge and the full frame."""
    rng = np.random.default_rng(3)
    out = [np.zeros((480, 640), bool), np.ones((480, 640), bool)]
    for _ in range(6):
        m = np.zeros((480, 640), bool)
        r0, c0 = rng.integers(0, 470), rng.integers(0, 630)
        m[r0:r0 + rng.integers(1, 300), c0:c0 + rng.integers(1, 400)] = True
        m &= rng.random((480, 640)) < 0.7
        out.append(m)
    for edge in (np.s_[:5, 100:300], np.s_[-3:, :50], np.s_[200:260, :2],
                 np.s_[10:400, -1:], np.s_[:1, :1], np.s_[-1:, -1:]):
        m = np.zeros((480, 640), bool)
        m[edge] = True
        out.append(m)
    sparse = np.zeros((480, 640), bool)
    sparse[np.unravel_index(rng.choice(480 * 640, 30, replace=False), sparse.shape)] = True
    return out + [sparse]


def test_native_data_plane_bit_equal_to_jax():
    assert j_native.available()
    rng = np.random.default_rng(1)
    for _ in range(50):
        r0, c0 = int(rng.integers(-20, 470)), int(rng.integers(-20, 630))
        args = (r0, r0 + int(rng.integers(1, 300)), c0, c0 + int(rng.integers(1, 400)))
        assert t_native.snap_bbox(*args) == j_native.snap_bbox(*args)
    for k, m in enumerate(_masks()):
        for n in (1, 50, 500):
            a, b = t_native.mask_bbox_choose(m, n, seed=k), j_native.mask_bbox_choose(m, n, seed=k)
            assert a[0] == b[0] and a[2] == b[2]
            np.testing.assert_array_equal(a[1], b[1])
        bbox = t_native.mask_bbox(m)
        assert bbox == j_native.mask_bbox(m)
        valid = m & (rng.random(m.shape) < 0.5)
        a, b = (t_native.choose_in_bbox(valid, bbox, 200, seed=k),
                j_native.choose_in_bbox(valid, bbox, 200, seed=k))
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    depth = rng.uniform(0, 2000, size=(60, 80)).astype(np.float32)
    choose = rng.choice(60 * 80, 500).astype(np.int32)
    args = (depth, choose, 80, 10, 20, 325.2611, 242.04899, 572.4114, 573.57043, 1000.0)
    np.testing.assert_array_equal(t_native.backproject(*args), j_native.backproject(*args))


def test_native_parse_ply_bit_equal_to_jax(linemod_root):
    path = os.path.join(linemod_root, "models", "obj_01.ply")
    np.testing.assert_array_equal(t_native.parse_ply(path), j_native.parse_ply(path))
    np.testing.assert_array_equal(t_lm.parse_ply_vertices(path), j_lm.parse_ply_vertices(path))


def test_native_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "dataplane.cpp"
    bad.write_text("int plr2_snap_bbox( {\n")
    monkeypatch.setattr(t_native, "SOURCE", bad)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(t_native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed to build(.|\n)*error"):
        t_native.mask_bbox(np.ones((4, 4), bool))
    assert not list((tmp_path / "_build").rglob("*.so*"))


# ---------------- the loaders and the frame cache ----------------


@pytest.mark.parametrize("mode", ["train", "test"])
def test_linemod_dataset_bit_equal_to_jax(linemod_root, mode):
    kw = dict(num_points=N_PTS, num_mesh_points=MESH, seed=4)
    a, b = t_lm.LinemodDataset(linemod_root, mode, **kw), j_lm.LinemodDataset(linemod_root, mode, **kw)
    assert (len(a), a.objlist, a.diameters, a.add_noise) == (len(b), b.objlist, b.diameters, b.add_noise)
    assert a.meta == b.meta
    for obj in b.model_points:
        np.testing.assert_array_equal(a.model_points[obj], b.model_points[obj])
    for i in range(len(b)):
        same_raw(a.get_raw(i), b.get_raw(i))
    assert t_lm.OBJLIST == j_lm.OBJLIST and t_lm.SYM_OBJ_IDX == j_lm.SYM_OBJ_IDX
    assert t_lm.INTRINSICS == j_lm.INTRINSICS
    with pytest.raises(FileNotFoundError):
        t_lm.LinemodDataset(os.path.join(linemod_root, "nope"), mode)


def test_linemod_segnet_results_bit_equal_to_jax(linemod_root, tmp_path):
    gt = np.asarray(Image.open(os.path.join(linemod_root, "data/01/mask/0001.png"))) > 128
    pred = gt.copy()
    pred[:, 1::3] = False
    pred[2, 2] = True  # a stray pixel: the bbox comes from the largest blob
    out = tmp_path / "01_label"
    out.mkdir()
    Image.fromarray(pred.astype(np.uint8) * 255).save(out / "0001_label.png")
    kw = dict(num_points=N_PTS, num_mesh_points=MESH, objlist=[1],
              segnet_results=str(tmp_path))
    a, b = t_lm.LinemodDataset(linemod_root, "test", **kw), j_lm.LinemodDataset(linemod_root, "test", **kw)
    ra = a.get_raw(0)
    same_raw(ra, b.get_raw(0))
    assert not ra["lost"] and not ra["bbox_mask"][2, 2] and ra["mask"][2, 2] == (ra["depth"][2, 2] > 0)
    np.testing.assert_array_equal(t_lm.largest_component_mask(pred), j_lm.largest_component_mask(pred))
    Image.fromarray(np.zeros_like(pred, np.uint8)).save(out / "0001_label.png")
    ra = t_lm.LinemodDataset(linemod_root, "test", **kw).get_raw(0)
    assert ra["lost"]
    same_raw(ra, j_lm.LinemodDataset(linemod_root, "test", **kw).get_raw(0))


def test_linemod_cache_entries_read_only_and_hits_as_jax(linemod_root):
    kw = dict(num_points=N_PTS, num_mesh_points=MESH, objlist=[1], cache_mb=64)
    a, b = t_lm.LinemodDataset(linemod_root, "train", **kw), j_lm.LinemodDataset(linemod_root, "train", **kw)
    for _ in range(3):
        ra = a.get_raw(0)
        same_raw(ra, b.get_raw(0))
    assert (a._frame_cache.hits, a._frame_cache.misses) == (b._frame_cache.hits, b._frame_cache.misses) == (2, 1)
    assert a._frame_cache._bytes == b._frame_cache._bytes > 0
    with pytest.raises(ValueError, match="read-only"):
        ra["color"][0, 0, 0] = 1
    # a pickled dataset (a spawned worker's copy) arrives with an empty cache
    c = pickle.loads(pickle.dumps(a))
    assert c._frame_cache.capacity == a._frame_cache.capacity and not c._frame_cache._data
    same_raw(c.get_raw(0), ra)


def test_frame_cache_evicts_as_jax():
    a, b = t_fc.FrameCache(1), j_fc.FrameCache(1)
    arr = np.zeros(300 * 1024, np.uint8)  # three fit in 1 MB, four do not
    for key in (0, 1, 2, 0, 3, 1, 4, 0):
        a.get(key, lambda: arr.copy())
        b.get(key, lambda: arr.copy())
        assert list(a._data) == list(b._data) and a._bytes == b._bytes
    assert (a.hits, a.misses) == (b.hits, b.misses)
    assert t_fc.FrameCache(0).get(0, lambda: 5) == 5


YCB_KW = [dict(seed=5), dict(seed=5, cache_mb=64),
          dict(seed=2, front_num=1, front_keep_px=10, minimum_num_pt=0),
          dict(seed=3, add_front=False, minimum_num_pt=10 ** 6)]


@pytest.mark.parametrize("kw", YCB_KW, ids=["default", "cache", "front", "resample"])
def test_ycb_dataset_bit_equal_to_jax(ycb_root, kw):
    """The sample stream of several visits (the object draw, the synthetic
    background, the occluder, the resample) equal to JAX's, bit for bit."""
    args = (ycb_root, "train", N_PTS, MESH)
    a, b = t_ycb.YCBDataset(*args, **kw), j_ycb.YCBDataset(*args, **kw)
    assert (a.classes, a.frames, a.syn_frames) == (b.classes, b.frames, b.syn_frames)
    for ci in b.model_points:
        np.testing.assert_array_equal(a.model_points[ci], b.model_points[ci])
        np.testing.assert_array_equal(a.model_points_large[ci], b.model_points_large[ci])
    for i in (0, 1, 0, 1, 1):
        same_raw(a.get_raw(i), b.get_raw(i))
    for ds in (a, b):
        ds.set_refine(True)
    assert a.get_num_points_mesh() == b.get_num_points_mesh()
    same_raw(a.get_raw(0, obj_idx=1), b.get_raw(0, obj_idx=1))
    fa, fb = a.get_frame(1), b.get_frame(1)
    assert set(fa) == set(fb) and fa["intrinsics"] == fb["intrinsics"]
    for k in ("color", "depth", "label"):
        np.testing.assert_array_equal(fa[k], fb[k])
    assert sorted(fa["objects"]) == sorted(fb["objects"])
    for o in fb["objects"]:
        same_raw(fa["objects"][o], fb["objects"][o])
    assert (a._frame_cache.hits, a._frame_cache.misses) == (b._frame_cache.hits, b._frame_cache.misses)
    assert t_ycb.CAM_1 == j_ycb.CAM_1 and t_ycb.CAM_2 == j_ycb.CAM_2
    assert t_ycb.SYM_OBJ_IDX == j_ycb.SYM_OBJ_IDX


def test_ycb_draws_from_a_given_generator(ycb_root):
    """`rng=` replaces the dataset's generator for a visit: the same seed
    gives the same sample whatever the dataset's own stream did before."""
    ds = t_ycb.YCBDataset(ycb_root, "train", N_PTS, MESH, seed=2, front_num=1,
                          front_keep_px=10)
    first = ds.get_raw(1, rng=np.random.default_rng(7))
    ds.get_raw(0)
    ds.get_raw(1)
    same_raw(ds.get_raw(1, rng=np.random.default_rng(7)), first)


def test_posecnn_bit_equal_to_jax(tmp_path):
    import scipy.io as sio
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 4, (48, 64)).astype(np.int32)
    rois = np.array([[0, 1, 3, 5, 40, 30], [0, 3, -4, 10, 70, 50]], np.float64)
    sio.savemat(tmp_path / "000000.mat", {"labels": labels, "rois": rois,
                                          "poses": rng.normal(size=(2, 7))})
    sio.savemat(tmp_path / "000001.mat", {"labels": labels[::-1]})
    for row in rois:
        for hw in ((480, 640), (48, 64)):
            assert t_pc.roi_bbox(row, *hw) == j_pc.roi_bbox(row, *hw)
    a, b = t_pc.PoseCNNMasks(str(tmp_path)), j_pc.PoseCNNMasks(str(tmp_path))
    for f in (0, 1):
        ra = t_pc.load_posecnn_result(str(tmp_path / f"{f:06d}.mat"))
        rb = j_pc.load_posecnn_result(str(tmp_path / f"{f:06d}.mat"))
        for k in rb:
            assert (ra[k] is None) == (rb[k] is None)
            if rb[k] is not None:
                np.testing.assert_array_equal(ra[k], rb[k])
        assert a.detected_objects(f) == b.detected_objects(f)
        assert a.detections(f, 48, 64) == b.detections(f, 48, 64)
        np.testing.assert_array_equal(a(None), b(None))
    a.reset()
    np.testing.assert_array_equal(a(None), labels)


# ---------------- host preparation, finish_sample, prefetch ----------------


def _raws(linemod_root, ycb_root):
    lm = t_lm.LinemodDataset(linemod_root, "train", N_PTS, MESH)
    ycb = t_ycb.YCBDataset(ycb_root, "train", N_PTS, MESH, add_front=False)
    return [lm.get_raw(0), ycb.get_raw(0, obj_idx=0), ycb.get_raw(1, obj_idx=1)]


def test_host_prepare_bit_equal_to_jax(linemod_root, ycb_root):
    for k, raw in enumerate(_raws(linemod_root, ycb_root)):
        for fn in ("host_prepare", "host_prepare_raw"):
            for n in (N_PTS, 5000):  # the subset and the wrap regimes
                a = getattr(t_pf, fn)(raw, n, seed=k)
                b = getattr(j_pf, fn)(raw, n, seed=k)
                same_raw(a, b)


def _jax_draws(key, noise_trans=0.03):
    """The draws JAX's finish_sample makes from `key`, as port Draws."""
    kd = np.asarray(jax.random.key_data(key)).reshape(-1)
    _, k_jit, k_trans = jax.random.split(key, 3)
    kperm, kb, kc, ks, kh = jax.random.split(k_jit, 5)
    factors = jnp.stack([
        jax.random.uniform(kb, (), minval=0.8, maxval=1.2),
        jax.random.uniform(kc, (), minval=0.8, maxval=1.2),
        jax.random.uniform(ks, (), minval=0.8, maxval=1.2),
        jax.random.uniform(kh, (), minval=-0.05, maxval=0.05)])
    order = jax.random.permutation(kperm, jnp.arange(4, dtype=jnp.int32))
    add_t = jax.random.uniform(k_trans, (3,), minval=-noise_trans, maxval=noise_trans)
    return Draws((int(kd[0]), int(kd[-1])), torch.from_numpy(_np(factors)),
                 torch.from_numpy(_np(order)).long(), torch.from_numpy(_np(add_t)))


@pytest.mark.parametrize("add_noise", [False, True], ids=["plain", "noise"])
def test_finish_sample_matches_jax_given_the_same_draws(linemod_root, ycb_root, add_noise):
    for k, raw in enumerate(_raws(linemod_root, ycb_root)[:2]):
        prep = t_pf.host_prepare_raw(raw, N_PTS, seed=k)
        key = jax.random.key(30 + k)
        names = ("img_u8", "points", "choose", "model_points", "target_r", "target_t")
        want = j_pf.finish_sample(*(jnp.asarray(prep[n]) for n in names),
                                  jnp.asarray(prep["idx"]), key, add_noise=add_noise)
        got = t_pf.finish_sample(*(torch.from_numpy(np.array(prep[n])) for n in names),
                                 int(prep["idx"]), _jax_draws(key), add_noise=add_noise)
        np.testing.assert_array_equal(got.choose.numpy(), _np(want.choose))
        assert got.choose.dtype == torch.int64 and got.obj == int(prep["idx"])
        # test_torch_port_data.py's tolerances for preprocess_crop: the
        # jittered image passes four ops in f32, fused differently by XLA
        for name, atol in (("points", 1e-6), ("target", 1e-6), ("img", 1e-5)):
            np.testing.assert_allclose(getattr(got, name).numpy(), _np(getattr(want, name)),
                                       atol=atol, rtol=0, err_msg=name)
        np.testing.assert_array_equal(got.model_points.numpy(), _np(want.model_points))
        assert int(got.idx) == int(want.idx)


def same_samples(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.obj == y.obj
        for u, v in zip(x, y):
            assert torch.equal(u, v)


@pytest.mark.parametrize("which", ["linemod", "ycb"])
def test_prefetch_samples_equal_at_any_worker_count(linemod_root, ycb_root, which):
    """0 workers, 2 threads and 2 spawned processes give the same samples,
    augmentation included, in the same (shuffled) order; YCB's per-visit
    draws come from the dataset index."""
    if which == "linemod":
        ds = t_lm.LinemodDataset(linemod_root, "train", N_PTS, MESH, objlist=[1])
    else:
        ds = t_ycb.YCBDataset(ycb_root, "train", N_PTS, MESH, front_num=1,
                              front_keep_px=10, cache_mb=16)
    runs = {}
    for name, kw in (("inline", dict(num_workers=0)), ("threads", dict(num_workers=2)),
                     ("processes", dict(num_workers=2, use_processes=True))):
        gen = torch.Generator().manual_seed(11)
        runs[name] = [s for _ in range(2) for s in t_pf.iterate_prefetch_samples(
            ds, gen, N_PTS, add_noise=True, noise_trans=0.03, shuffle=True,
            seed=3, **kw)]
    same_samples(runs["threads"], runs["inline"])
    same_samples(runs["processes"], runs["inline"])
    a, b = runs["inline"][:len(ds)], runs["inline"][len(ds):]
    assert not torch.equal(a[0].img, b[0].img)  # each epoch draws anew


def test_prefetch_loader_order_and_errors(linemod_root):
    ds = t_lm.LinemodDataset(linemod_root, "train", N_PTS, MESH, objlist=[1])

    class Twice:
        def __len__(self):
            return 6

        def get_raw(self, i):
            if i == 4:
                raise KeyError("frame 4")
            return ds.get_raw(0)

    loader = t_pf.PrefetchLoader(Twice(), N_PTS, num_workers=3, raw_mode=True)
    it = iter(loader)
    assert [next(it)["index"] for _ in range(4)] == [0, 1, 2, 3]
    with pytest.raises(KeyError, match="frame 4"):
        next(it)
    full = list(t_pf.PrefetchLoader(ds, N_PTS, num_workers=2))
    same_raw(full[0], t_pf.host_prepare(ds.get_raw(0), N_PTS, seed=0))


def _trainer(linemod_root, workers):
    from plr2_tpu_torch.config import (DatasetConfig, ModelConfig,
                                       PipelineConfig, TrainConfig)
    from plr2_tpu_torch.train import Trainer
    cfg = PipelineConfig(
        dataset=DatasetConfig(name="linemod", num_points=N_PTS, num_objects=13,
                              num_mesh_points=MESH, sym_list=(7, 8), noise_trans=0.02),
        model=ModelConfig(num_points=N_PTS, num_objects=13),
        train=TrainConfig(batch_size=1, nepoch=1, workers=workers))
    tr = Trainer(cfg, device="cpu")
    tr.pipe.posenet.cnn.model.dropout_rates = (0.0, 0.0, 0.0)
    return tr


def test_trainer_epoch_with_worker_threads_is_deterministic(linemod_root):
    """A Trainer epoch fed by 2 threads equals one fed by 1 thread and one
    fed by the prefetcher in the calling thread, bit for bit (losses and
    every parameter after the step)."""
    ds = t_lm.LinemodDataset(linemod_root, "train", N_PTS, MESH, objlist=[1])
    test_ds = t_lm.LinemodDataset(linemod_root, "test", N_PTS, MESH, objlist=[1])
    runs = []
    for workers in (2, 1, 0):
        tr = _trainer(linemod_root, max(workers, 1))
        if workers == 0:
            tr._sample_iter = _inline_prefetch
        state, info = tr.train_epoch(tr.init_state(), ds, torch.Generator().manual_seed(4))
        dis = tr.test_epoch(state, test_ds, torch.Generator().manual_seed(5))
        runs.append((info["losses"], dis, tr.pipe.posenet.state_dict()))
    for losses, dis, sd in runs[1:]:
        assert losses == runs[0][0] and dis == runs[0][1]
        for k, v in sd.items():
            assert torch.equal(v, runs[0][2][k]), k
    assert np.isfinite(runs[0][0]).all() and np.isfinite(runs[0][1])


def _inline_prefetch(dataset, generator, add_noise, shuffle, seed):
    """The trainer's prefetch iterator with 0 workers (the calling thread)."""
    return t_pf.iterate_prefetch_samples(
        dataset, generator, N_PTS, add_noise=add_noise, noise_trans=0.02,
        shuffle=shuffle, seed=seed, num_workers=0, device="cpu")


def test_trainer_draws_translation_noise_at_dataset_noise_trans(linemod_root):
    """Both sample iterators draw the noise at DatasetConfig.noise_trans:
    target - R m - t is the sample's add_t, within it and not all zero."""
    import dataclasses
    ds = t_lm.LinemodDataset(linemod_root, "train", N_PTS, MESH, objlist=[1])
    raw = ds.get_raw(0)
    clean = raw["model_points"] @ raw["target_r"].T + raw["target_t"]
    for workers in (0, 2):
        for noise in (0.0, 0.004, 0.5):
            tr = _trainer(linemod_root, workers)
            tr.cfg = dataclasses.replace(tr.cfg, dataset=dataclasses.replace(
                tr.cfg.dataset, noise_trans=noise))
            (s,) = tr._sample_iter(ds, torch.Generator().manual_seed(1),
                                   add_noise=True, shuffle=False, seed=0)
            add_t = s.target.numpy() - clean
            np.testing.assert_allclose(add_t, np.broadcast_to(add_t[0], add_t.shape),
                                       atol=1e-6)
            assert np.abs(add_t[0]).max() <= noise + 1e-6
            assert (np.abs(add_t[0]).max() > noise / 10) == (noise > 0)


def test_loaders_run_without_pil_pyyaml_or_jax(linemod_root, ycb_root):
    """The card's host has no PIL and no PyYAML: with them (and jax, flax,
    plr2_tpu) blocked, both datasets build, decode and feed a prefetch
    sample, and the CLIs import."""
    code = (
        "import sys\n"
        "for m in ('PIL', 'yaml', 'jax', 'flax', 'plr2_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from plr2_tpu_torch.data import LinemodDataset, YCBDataset\n"
        "from plr2_tpu_torch.data.prefetch import iterate_prefetch_samples\n"
        "from plr2_tpu_torch.tools import train, eval_linemod, infer, serve\n"
        "lm = LinemodDataset(sys.argv[1], 'train', 64, 64)\n"
        "ycb = YCBDataset(sys.argv[2], 'train', 64, 64)\n"
        "assert lm.get_raw(0)['color'].shape == (480, 640, 3)\n"
        "assert ycb.get_frame(1)['label'].dtype.name == 'int32'\n"
        "for ds in (lm, ycb):\n"
        "    (s, *_) = iterate_prefetch_samples(ds, torch.Generator(), 64,\n"
        "                                       add_noise=True, num_workers=2)\n"
        "    assert s.points.shape == (64, 3) and s.img.dtype == torch.float32\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('PIL', 'yaml', 'jax', 'flax', 'plr2_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
    res = subprocess.run([sys.executable, "-c", code, linemod_root, ycb_root],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]
