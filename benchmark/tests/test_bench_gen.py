"""The traffic's inputs are a function of the seed alone."""

import numpy as np
import torch

from benchmark.gen import frames as G
from benchmark.gen.weights import make_weights
from benchmark.reference.frame import snap_bbox
from benchmark.tests import tiny

BIG = 2 ** 31 + 12345  # seeds may exceed 32 signed bits


def _equal(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


def test_serve_pool_repeats_from_the_seed_and_fits_the_canvas():
    s = tiny.spec("ycb.serve.f8")
    cfg, tr = s["config"], s["traffic"]
    a, b = G.serve_pool(cfg, tr, BIG), G.serve_pool(cfg, tr, BIG)
    assert _equal(a, b)
    c = G.serve_pool(cfg, tr, BIG + 1)
    assert not np.array_equal(a["colors"], c["colors"])
    for f in range(len(a["seeds"])):
        assert len(set(a["obj_ids"][f])) == tr["objects_per_frame"]
        for oid in a["obj_ids"][f]:
            m = a["labels"][f] == oid
            r, q = np.flatnonzero(m.any(1)), np.flatnonzero(m.any(0))
            box = snap_bbox(r[0], r[-1] + 1, q[0], q[-1] + 1, cfg["img_h"],
                            cfg["img_w"])
            assert box[1] - box[0] <= tr["canvas"]
            assert box[3] - box[2] <= tr["canvas"]


def test_train_pool_repeats_from_the_seed():
    s = tiny.spec("ycb.train.b32")
    a = G.stack(G.train_pool(s["config"], s["traffic"], BIG, 6))
    b = G.stack(G.train_pool(s["config"], s["traffic"], BIG, 6))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["img"].shape == (6, 80, 80, 3) and a["choose"].max() < 80 * 80
    assert set(a["idx"]) <= set(range(s["config"]["num_objects"]))


def test_weights_repeat_from_the_seed():
    a = make_weights(5, 32, BIG, torch.device("cpu"))
    b = make_weights(5, 32, BIG, torch.device("cpu"))
    c = make_weights(5, 32, BIG + 1, torch.device("cpu"))
    for net in a:
        assert all(torch.equal(a[net][k], b[net][k]) for k in a[net])
    w = "cnn.model.feats.conv1.weight"
    assert not torch.equal(a["posenet"][w], c["posenet"][w])
    assert float(a["posenet"]["cnn.model.feats.bn1.running_var"].min()) >= 0.3


def test_weights_fit_the_program():
    from plr2_tpu_torch.pipeline import DenseFusionPipeline

    pipe = DenseFusionPipeline(48, 5, device="cpu", seed=None)
    w = make_weights(5, 32, BIG, torch.device("cpu"))
    pipe.posenet.load_state_dict(w["posenet"], strict=True)
    pipe.refiner.load_state_dict(w["refiner"], strict=True)
