"""The plain reference against the program's plain CPU path at a tiny
size, piece by piece and through whole runs of every cell."""

import numpy as np
import pytest
import torch

from benchmark import run as R
from benchmark.gen import frames as G
from benchmark.gen.weights import make_weights
from benchmark.reference import frame as RF
from benchmark.reference import model as M
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 99


def _pipe(num_obj=5, points=48):
    from plr2_tpu_torch.pipeline import DenseFusionPipeline

    pipe = DenseFusionPipeline(points, num_obj, device="cpu", seed=None)
    w = make_weights(num_obj, 32, SEED, CPU)
    pipe.posenet.load_state_dict(w["posenet"])
    pipe.refiner.load_state_dict(w["refiner"])
    return pipe, w


def test_posenet_and_refiner_match_the_program():
    pipe, w = _pipe()
    g = torch.Generator().manual_seed(3)
    img = torch.randn(2, 80, 80, 3, generator=g)
    cloud = torch.randn(2, 48, 3, generator=g) * 0.1
    choose = torch.randint(0, 6400, (2, 48), generator=g)
    obj = torch.tensor([1, 4])
    with torch.no_grad():
        want = pipe.posenet(img, cloud, choose, obj)
        got = M.posenet(w["posenet"], img, cloud, choose, obj, 5)
        for a, b in zip(got[:2], want[:2]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(got[2], want[2][..., 0], rtol=1e-4,
                                   atol=1e-5)
        torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=1e-5)
        dq, dt = M.refiner(w["refiner"], cloud, got[3], obj, 5)
        wq, wt = pipe.refiner(cloud, want[3], obj)
        torch.testing.assert_close(dq, wq[:, 0], rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(dt, wt[:, 0], rtol=1e-4, atol=1e-5)


def test_frame_preprocessing_matches_the_serving_program():
    from plr2_tpu_torch.serving import FrameEstimator

    s = tiny.spec("ycb.serve.f8")
    cfg, tr = s["config"], s["traffic"]
    pipe, _ = _pipe(cfg["num_objects"], cfg["num_points"])
    est = FrameEstimator(pipe, canvas=tr["canvas"], img_h=cfg["img_h"],
                         img_w=cfg["img_w"], refine_iterations=1)
    pool = G.serve_pool(cfg, tr, SEED)
    for f in range(len(pool["seeds"])):
        poses, sample = est.run_with_samples(
            pool["colors"][f], pool["depths"][f], pool["labels"][f],
            pool["obj_ids"][f], pool["model_points"][f], pool["intr"],
            int(pool["seeds"][f]))
        slots = RF.prepare_frames(pool, [f], tr["canvas"], cfg["num_points"],
                                  cfg["min_mask_pixels"], cfg["num_objects"])
        for k, sl in enumerate(slots):
            assert np.array_equal(sample.choose[k].numpy(), sl["choose"])
            np.testing.assert_allclose(sample.points[k].numpy(), sl["cloud"],
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(sample.img[k].numpy(), sl["img"],
                                       rtol=1e-6, atol=1e-6)
            assert bool(poses.valid[k]) == sl["valid"]
            assert bool(poses.oversized[k]) == sl["oversized"]


def test_key_words_and_hash_match_the_program():
    from plr2_tpu_torch.data.preprocess import coord_scores
    from plr2_tpu_torch.serving import frame_key_words

    for seed, oid in ((0, 1), (2 ** 31 - 1, 21), (12345, 7)):
        want = frame_key_words(torch.tensor([seed]), torch.tensor([[oid]]))
        words = RF.key_words(seed, oid)
        assert list(want[0, 0].tolist()) == list(words)
        assert np.array_equal(coord_scores(words, 9, 7).numpy(),
                              RF.coord_scores(words, 9, 7))


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_whole_run_is_correct_at_a_tiny_size(cell):
    line, _ = tiny.run(tiny.spec(cell))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
