"""plr2_tpu_torch.eval against the JAX package's plr2_tpu/eval on the same
inputs: the metrics (ADD, ADD-S, the success rate, the threshold curve and
the VOCap AUC), `evaluate` in its per-crop and batched modes on the same
synthetic samples and choose draws (one lost detection among them), on
weights made from a numpy seed and on both trained checkpoints
(`trained_models/{synthetic_e2e,linemod}/best.msgpack`, read here with
flax and bridged by `models/weights.py`; the port never reads them), and
the offline report (JSON round trip both ways, the table, the curve
figure, the .mat re-evaluation).

The JAX side runs its default XLA pipeline (the port's kernels run their
plain versions on the CPU; tests/test_torch_port_models.py holds those
against JAX's Pallas configuration). One JAX pipeline per object count is
shared by the whole file, so each crop shape compiles once.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.serialization import msgpack_restore

from plr2_tpu.data import SyntheticPoseDataset as JDataset
from plr2_tpu.eval import evaluate as j_evaluate
from plr2_tpu.eval import metrics as j_metrics
from plr2_tpu.eval import report as j_report
from plr2_tpu.pipeline import DenseFusionPipeline as JPipeline
from plr2_tpu_torch import DenseFusionPipeline
from plr2_tpu_torch.data import Draws
from plr2_tpu_torch.data import SyntheticPoseDataset as TDataset
from plr2_tpu_torch.eval import metrics, report
from plr2_tpu_torch.eval import EvalResult, evaluate

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N, MESH, SYM = 96, 128, (1,)
# per-sample distance, port vs JAX (f32): both estimates sum in their own
# order (q and t agree within ~1e-6, tests/test_torch_port_checkpoint.py),
# and the distance moves by about as much; measured up to 7.7e-7 m on these
# samples, over all three weight sets and both modes
DIS_TOL = 1e-4


# ---------------- metrics ----------------


def _pose_case(rng, m=50):
    mp = (rng.normal(size=(m, 3)) * 0.05).astype(np.float32)
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    t = (rng.normal(size=3) * 0.1).astype(np.float32)
    target = (mp[rng.permutation(m)] + rng.normal(size=(m, 3)) * 0.01
              ).astype(np.float32)
    return mp, q, t, target


@pytest.mark.parametrize("symmetric", [False, True], ids=["add", "adds"])
def test_pose_distance_matches_jax(symmetric):
    rng = np.random.default_rng(int(symmetric))
    for _ in range(4):
        case = _pose_case(rng)
        want = float(j_metrics.pose_distance(*map(jnp.asarray, case),
                                             symmetric=symmetric))
        got = float(metrics.pose_distance(*map(torch.from_numpy, case),
                                          symmetric=symmetric))
        assert abs(got - want) <= 1e-6


def test_distances_promote_a_bf16_pose_to_f32():
    """bf16 mode returns a bf16 quaternion: as in JAX, its rotation matrix
    is computed in bf16 and promoted to f32 in the product with the
    points, so the distance is f32."""
    mp, q, t, target = _pose_case(np.random.default_rng(5))
    qb = torch.from_numpy(q).to(torch.bfloat16)
    for fn, jfn in ((metrics.add_distance, j_metrics.add_distance),
                    (metrics.adds_distance, j_metrics.adds_distance)):
        got = fn(torch.from_numpy(mp), qb, torch.from_numpy(t),
                 torch.from_numpy(target))
        want = jfn(jnp.asarray(mp), jnp.asarray(q, jnp.bfloat16),
                   jnp.asarray(t), jnp.asarray(target))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-6


def test_aggregates_equal_jax_and_known_values():
    assert metrics.compute_auc([0.5, 0.2], max_dist=0.1) == 0.0
    assert metrics.compute_auc([0.0, 0.0]) == pytest.approx(100.0)
    assert metrics.compute_auc([0.05]) == pytest.approx(100.0)
    assert metrics.compute_auc([0.05, 0.5]) == pytest.approx(50.0)
    assert metrics.compute_auc([]) == 0.0
    assert metrics.success_rate([0.01, 0.03], 0.02) == 0.5
    assert metrics.success_rate([], 0.02) == 0.0
    rng = np.random.default_rng(2)
    for _ in range(5):
        d = list(rng.uniform(0.0, 0.15, size=37))
        assert metrics.compute_auc(d) == j_metrics.compute_auc(d)
        assert metrics.success_rate(d, 0.02) == j_metrics.success_rate(d, 0.02)
        for got, want in zip(metrics.accuracy_threshold_curve(d, 0.1, 40),
                             j_metrics.accuracy_threshold_curve(d, 0.1, 40)):
            np.testing.assert_array_equal(got, want)


# ---------------- evaluate ----------------


def _key_words(key):
    kd = np.asarray(jax.random.key_data(key)).reshape(-1).astype(np.uint32)
    return int(kd[0]), int(kd[-1])


def jax_draws(seed):
    """The port's draws provider that reproduces JAX's evaluate: one key
    split per sample that is not lost; without noise only the choose
    hash's key words (the first of preprocess_crop's three subkeys) are
    read."""
    key = jax.random.key(seed)

    def nxt():
        nonlocal key
        key, sub = jax.random.split(key)
        k_choose = jax.random.split(sub, 3)[0]
        return Draws(_key_words(k_choose), torch.ones(4), torch.arange(4),
                     torch.zeros(3))
    return nxt


class WithLost:
    """A dataset with a lost detection (the upstream eval's empty predicted
    mask) at index `at`."""

    def __init__(self, ds, at=1):
        self.ds, self.at = ds, at
        self.diameters = ds.diameters

    def __len__(self):
        return len(self.ds) + 1

    def get_raw(self, i):
        if i == self.at:
            return {"lost": True}
        return self.ds.get_raw(i - (i > self.at))


def _seeded_like(tree, seed):
    """Weights of the tree's shapes drawn from a numpy seed: kernels at
    1/sqrt(fan in), BN statistics and scales near (0, 1), small biases."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        shape = np.shape(x)
        r = rng.normal(size=shape).astype(np.float32)
        if name.endswith("['var']"):
            return np.abs(r) * 0.5 + 0.3
        if name.endswith("['scale']"):
            return 1.0 + 0.1 * r
        if name.endswith("['mean']") or name.endswith("['bias']"):
            return 0.05 * r
        if name.endswith("['prelu_alpha']"):
            return np.float32(0.25)
        return r / np.sqrt(max(int(np.prod(shape[:-1])), 1))
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _checkpoint(name):
    return msgpack_restore((ROOT / "trained_models" / name / "best.msgpack")
                           .read_bytes())["variables"]


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_frames=2, num_objects=2, model_points=MESH, num_points=N,
              seed=1)
    return WithLost(JDataset(**kw)), WithLost(TDataset(**kw))


_JPIPES = {}


def _jpipe(num_objects):
    """One JAX pipeline per object count: its jitted estimate compiles each
    crop shape once for the whole file."""
    if num_objects not in _JPIPES:
        _JPIPES[num_objects] = JPipeline(num_points=N, num_objects=num_objects)
    return _JPIPES[num_objects]


def _num_objects(variables):
    return variables["posenet"]["params"]["conv4_c"]["bias"].shape[0]


WEIGHTS = {"seeded": lambda: _seeded_like(_checkpoint("synthetic_e2e"), 11),
           "synthetic_e2e": lambda: _checkpoint("synthetic_e2e"),
           "linemod": lambda: _checkpoint("linemod")}


def _rate_gap_allowed(dists, threshold):
    """A rate may differ by the share of samples within DIS_TOL of its
    threshold (none, on these samples, when the test passes exactly)."""
    d = np.asarray(dists)
    return float(np.mean(np.abs(d - threshold) <= DIS_TOL)) if d.size else 0.0


def _assert_results_match(got: EvalResult, want, diameters):
    assert got.num_samples == want.num_samples == 4
    assert got.lost_detections == want.lost_detections == 1
    assert sorted(got.per_object_distances) == sorted(want.per_object_distances)
    for obj, d in want.per_object_distances.items():
        np.testing.assert_allclose(got.per_object_distances[obj], d,
                                   atol=DIS_TOL, rtol=0)
        assert abs(got.per_object_auc[obj] - want.per_object_auc[obj]) <= \
            1000 * DIS_TOL
        assert abs(got.per_object_success[obj] - want.per_object_success[obj]) \
            <= _rate_gap_allowed(d, 0.1 * diameters[obj])
    all_d = [x for d in want.per_object_distances.values() for x in d]
    assert abs(got.mean_distance - want.mean_distance) <= DIS_TOL
    # the AUC integrates accuracy over [0, 0.1 m] and scales to 100
    assert abs(got.auc - want.auc) <= 1000 * DIS_TOL
    assert abs(got.under_2cm - want.under_2cm) <= _rate_gap_allowed(all_d, 0.02)
    assert abs(got.mean_success - want.mean_success) <= max(
        _rate_gap_allowed(d, 0.1 * diameters[o])
        for o, d in want.per_object_distances.items())


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("batch_size", [1, 4], ids=["per_crop", "batched"])
def test_evaluate_matches_jax(datasets, weights, batch_size):
    jds, tds = datasets
    variables = WEIGHTS[weights]()
    num_objects = _num_objects(variables)
    kw = dict(sym_list=SYM, refine_iterations=2, diameters=jds.diameters,
              batch_size=batch_size, crop_canvas=0)
    want = j_evaluate(_jpipe(num_objects), variables, jds, seed=3, **kw)
    pipe = DenseFusionPipeline(N, num_objects, device="cpu", seed=None)
    pipe.load_jax_variables(variables)
    got = evaluate(pipe, tds, draws=jax_draws(3), **kw)
    _assert_results_match(got, want, jds.diameters)


def test_evaluate_takes_one_draw_per_sample_that_is_not_lost(datasets):
    _, tds = datasets
    taken = []

    def counting():
        taken.append(1)
        return Draws((1, 2), torch.ones(4), torch.arange(4), torch.zeros(3))
    pipe = DenseFusionPipeline(N, 2, device="cpu", seed=0)
    res = evaluate(pipe, tds, sym_list=SYM, refine_iterations=0,
                   batch_size=4, crop_canvas=0, draws=counting)
    assert len(taken) == res.num_samples == 4 and res.lost_detections == 1
    assert not res.per_object_success and res.mean_success == 0.0


# ---------------- the offline report ----------------


@pytest.fixture
def per_obj():
    rng = np.random.default_rng(9)
    return {1: list(rng.uniform(0.0, 0.08, size=40)),
            2: list(rng.uniform(0.0, 0.15, size=25)),
            5: list(rng.uniform(0.0, 0.03, size=10)) + [float("inf")]}


def test_report_round_trip_both_ways(tmp_path, per_obj):
    meta = {"dataset": "linemod", "diameters": {1: 0.12, 2: 0.25, 5: 0.08}}
    report.save_distance_report(str(tmp_path / "port.json"), per_obj, meta)
    j_report.save_distance_report(str(tmp_path / "jax.json"), per_obj, meta)
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    got, got_meta = report.load_distance_report(str(tmp_path / "jax.json"))
    want, want_meta = j_report.load_distance_report(str(tmp_path / "port.json"))
    assert got == want == {k: [float(x) for x in v] for k, v in per_obj.items()}
    assert got_meta == want_meta


def test_accuracy_table_and_text_equal_jax(per_obj):
    diam = {1: 0.12, 2: 0.25, 5: 0.08}
    for d in (diam, None):
        rows = report.accuracy_table(per_obj, diameters=d)
        assert rows == j_report.accuracy_table(per_obj, diameters=d)
        names = {1: "ape", 2: "can"}
        assert report.format_accuracy_table(rows, names) == \
            j_report.format_accuracy_table(rows, names)


def test_plot_accuracy_curves_renders(tmp_path, per_obj):
    out = report.plot_accuracy_curves(per_obj, str(tmp_path / "c" / "a.png"))
    assert Path(out).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_mat_dir_reevaluation_matches_jax(tmp_path):
    """Per-frame pose dumps (`poses` (K, 7) wxyz|xyz, `cls_indexes`) as
    the JAX package's full-pipeline eval writes them, re-evaluated against
    the frames' ground truth; an object missing from a dump is a lost
    detection (inf), a file missing skips its frame."""
    import scipy.io as sio
    ds = TDataset(num_frames=3, num_objects=3, model_points=64, num_points=N,
                  seed=7)
    rng = np.random.default_rng(4)
    for fi, frame in enumerate(ds.frames[:2]):
        ids = sorted(frame.poses)[:-1] if fi == 1 else sorted(frame.poses)
        q = rng.normal(size=(len(ids), 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        poses = np.concatenate([q, rng.normal(size=(len(ids), 3)) * 0.1], 1)
        sio.savemat(str(tmp_path / f"{fi:06d}.mat"),
                    {"poses": poses, "cls_indexes": np.asarray(ids)})
    sym = (0, 2)
    got = report.distances_from_mat_dir(str(tmp_path), ds.frames, ds.models, sym)
    want = j_report.distances_from_mat_dir(str(tmp_path), ds.frames, ds.models,
                                            sym)
    assert sorted(got) == sorted(want)
    assert sum(np.isinf(v).sum() for v in got.values()) == 1
    for obj in want:
        np.testing.assert_allclose(got[obj], want[obj], atol=1e-6, rtol=0)
