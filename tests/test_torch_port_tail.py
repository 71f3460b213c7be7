"""The tail of the port against the JAX package on the same inputs:
YAML configs (`plr2_tpu_torch/config_io.py` over `data/codecs.py`'s
reader and writer, no PyYAML), the torchvision trunk import and the
reference `.pth` import / export (`models/torch_import.py`,
`models/torch_export.py`), and `utils/debug.checked`.

Weights are seeded numpy trees of the JAX pipeline's shapes (no JAX
init is run), handed to both sides as numpy arrays.
"""

import copy
import dataclasses
import functools
import glob
import math
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from plr2_tpu import config as jconfig
from plr2_tpu import config_io as jconfig_io
from plr2_tpu.models import torch_export as jexport
from plr2_tpu.models import torch_import as jimport
from plr2_tpu.pipeline import DenseFusionPipeline as JPipeline
from plr2_tpu.utils import debug as jdebug
from plr2_tpu_torch import DenseFusionPipeline
from plr2_tpu_torch import config as tconfig
from plr2_tpu_torch import config_io
from plr2_tpu_torch.data.codecs import dump_yaml, parse_yaml
from plr2_tpu_torch.models import torch_export, torch_import
from plr2_tpu_torch.models.weights import posenet_state_dict, refinenet_state_dict
from plr2_tpu_torch.utils.debug import checked

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(glob.glob(str(ROOT / "configs" / "*.yml")))
NUM_OBJ, N, HW = 4, 32, 48
# the partial load's coverage (tests/test_torchvision_import.py): 18
# compatible convs and their 18 BatchNorms x 4 tensors; the other 32 keys
# (the stem, layer1 block 0's first conv and BN, fc, the counters) skipped
TRUNK_COUNTS = (18 + 18 * 4, 32)


def fake_torchvision_resnet18_sd(seed=0):
    """torchvision.models.resnet18's state-dict layout, random values
    (tests/test_torchvision_import.py's)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def add(name, shape):
        sd[name] = torch.tensor(rng.standard_normal(shape).astype(np.float32) * 0.1)

    def add_bn(prefix, ch):
        add(f"{prefix}.weight", (ch,))
        add(f"{prefix}.bias", (ch,))
        add(f"{prefix}.running_mean", (ch,))
        sd[f"{prefix}.running_var"] = torch.tensor(
            rng.uniform(0.5, 1.5, (ch,)).astype(np.float32))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    add("conv1.weight", (64, 3, 7, 7))
    add_bn("bn1", 64)
    specs = {1: (64, 64), 2: (64, 128), 3: (128, 256), 4: (256, 512)}
    for li, (inp, planes) in specs.items():
        for bi in range(2):
            p = f"layer{li}.{bi}"
            cin = inp if bi == 0 else planes
            add(f"{p}.conv1.weight", (planes, cin, 3, 3))
            add_bn(f"{p}.bn1", planes)
            add(f"{p}.conv2.weight", (planes, planes, 3, 3))
            add_bn(f"{p}.bn2", planes)
            if bi == 0 and li > 1:
                add(f"{p}.downsample.0.weight", (planes, cin, 1, 1))
                add_bn(f"{p}.downsample.1", planes)
    add("fc.weight", (1000, 512))
    add("fc.bias", (1000,))
    return sd


def asdict_equal(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------- config_io ----------------


def test_yaml_config_roundtrip(tmp_path):
    """tests/test_utils.py's round trip, on the port."""
    cfg = config_io.config_from_dict({
        "preset": "ycb_refine",
        "dataset": {"num_points": 500, "sym_list": [1, 2]},
        "train": {"lr": 3e-4},
        "eval_refine_iterations": 4,
    })
    assert cfg.dataset.num_points == 500
    assert cfg.dataset.sym_list == (1, 2)
    assert cfg.train.lr == 3e-4
    assert cfg.eval_refine_iterations == 4
    assert cfg.model.num_objects == tconfig.get_preset("ycb_refine").model.num_objects
    p = tmp_path / "cfg.yml"
    config_io.save_config(cfg, str(p))
    assert config_io.load_config(str(p)) == cfg


def test_yaml_config_rejects_unknown_keys():
    with pytest.raises(KeyError, match="unknown"):
        config_io.config_from_dict({"train": {"learning_rate": 1e-4}})
    with pytest.raises(KeyError, match="unknown"):
        config_io.config_from_dict({"optimizer": "adam"})


def test_yaml_configs_roundtrip_new_model_fields(tmp_path):
    """tests/test_config.py's shipped-configs check, on the port."""
    for f in CONFIGS:
        assert isinstance(config_io.load_config(f).model.phase_upsample, bool)
    cfg = config_io.load_config(CONFIGS[0])
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, phase_upsample=False))
    out = tmp_path / "override.yml"
    config_io.save_config(cfg, str(out))
    assert config_io.load_config(str(out)).model.phase_upsample is False


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: Path(p).stem)
def test_shipped_config_loads_as_in_jax(path):
    assert asdict_equal(config_io.load_config(path), jconfig_io.load_config(path))


@pytest.mark.parametrize("preset", sorted(tconfig.PRESETS))
def test_saved_config_reads_back_equal_both_ways(preset, tmp_path):
    """The port's save_config read by JAX's load_config (PyYAML) and JAX's
    save_config read by the port's: the same config; the port writes the
    bytes that yaml.safe_dump writes."""
    cfg, jcfg = tconfig.get_preset(preset), jconfig.get_preset(preset)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr=1e-5, resume_posenet="yes", nepoch=2))
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, lr=1e-5, resume_posenet="yes", nepoch=2))
    ours, theirs = tmp_path / "port.yml", tmp_path / "jax.yml"
    config_io.save_config(cfg, str(ours))
    jconfig_io.save_config(jcfg, str(theirs))
    assert ours.read_text() == theirs.read_text()
    assert asdict_equal(jconfig_io.load_config(str(ours)), cfg)
    assert config_io.load_config(str(theirs)) == cfg


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def test_yaml_writer_scalars_read_back_as_pyyaml_reads_them():
    """Strings that YAML 1.1 would resolve to something else are quoted;
    floats keep a dot and a signed exponent; PyYAML and the port's reader
    read the text back to the values written."""
    doc = {
        "strings": ["", "1.0", "yes", "No", "on", "null", "~", "true", "0x1F",
                    "1_000", "2020-01-01", "1:30", ".inf", "x: y", "a #b", "-x",
                    "*a", "it's", "trail ", " lead", "line\nbreak", "é", "plain",
                    "experiments/logs"],
        "floats": [1e-4, 1e-05, 1.5e-05, 1e16, -2.5, 0.0, 500.0, float("inf"),
                   -float("inf"), float("nan"), 123456789.125],
        "others": [None, True, False, 0, -3, 10 ** 20],
        "empty": [], "none": {}, "nested": {"k": [3], "m": {"n": None}},
        "tuple": (1, 2),
    }
    text = dump_yaml(doc)
    want = {**doc, "tuple": [1, 2]}
    assert _same(yaml.safe_load(text), want)
    assert _same(parse_yaml(text), want)


# ---------------- weights: seeded JAX-shaped trees ----------------


def _numpy_variables(rng, shapes):
    """Seeded numpy weights of the JAX variable tree `shapes`."""
    def fill(path, s):
        name = str(path[-1])
        if "var" in name:
            return (np.abs(rng.normal(size=s.shape)) * 0.5 + 0.3).astype(np.float32)
        if "mean" in name:
            return (rng.normal(size=s.shape) * 0.3).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if "prelu_alpha" in name:
            return np.full(s.shape, 0.25, np.float32)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def case():
    """(JAX pipeline, its numpy variables, estimate inputs)."""
    rng = np.random.default_rng(5)
    jpipe = JPipeline(num_points=N, num_objects=NUM_OBJ)
    shapes = jax.eval_shape(lambda k: jpipe.init(k, crop_hw=HW, batch=1),
                            jax.random.key(0))
    variables = _numpy_variables(rng, shapes)
    inputs = (rng.normal(size=(2, HW, HW, 3)).astype(np.float32),
              (rng.normal(size=(2, N, 3)) * 0.1).astype(np.float32),
              rng.integers(0, HW * HW, size=(2, N)).astype(np.int32),
              np.array([1, 3], dtype=np.int32))
    return jpipe, variables, inputs


def port_pipe(variables=None):
    pipe = DenseFusionPipeline(N, NUM_OBJ, device="cpu",
                               seed=None if variables else 9)
    return pipe.load_jax_variables(variables) if variables else pipe


def assert_state_equal(got, want, skip_counters=False):
    """The same keys (BatchNorm's counters left out with skip_counters)
    and bit-equal tensors."""
    def keep(k):
        return not (skip_counters and k.endswith("num_batches_tracked"))

    assert sorted(filter(keep, got)) == sorted(filter(keep, want))
    for k in filter(keep, want):
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


def test_torchvision_import_matches_jax_tensor_for_tensor(case):
    """The fake resnet18 through JAX's import, then the port's conversion,
    equals the port's import into the same starting weights; the same
    imported / skipped keys in the same order."""
    _, variables, _ = case
    sd = fake_torchvision_resnet18_sd()
    jvars = copy.deepcopy(variables)
    jvars["posenet"], jimp, jskip = jimport.import_torchvision_resnet18(
        sd, jvars["posenet"])
    pipe = port_pipe(variables)
    imp, skip = torch_import.import_torchvision_resnet18(
        sd, pipe.posenet.cnn.model.feats)
    assert (imp, skip) == (jimp, jskip)
    assert (len(imp), len(skip)) == TRUNK_COUNTS
    assert_state_equal(pipe.posenet.state_dict(), posenet_state_dict(jvars["posenet"]))
    feats = pipe.posenet.cnn.model.feats
    # imported as the source holds them; the stem kept its weights
    assert torch.equal(feats.layer3[0].downsample[0].weight,
                       sd["layer3.0.downsample.0.weight"])
    assert torch.equal(feats.conv1.weight, posenet_state_dict(
        variables["posenet"])["cnn.model.feats.conv1.weight"])


def test_pretrained_trunk_file_loads_into_the_pipeline(case, tmp_path):
    _, variables, _ = case
    sd = fake_torchvision_resnet18_sd(seed=3)
    path = tmp_path / "resnet18.pth"
    torch.save(sd, path)
    pipe = port_pipe(variables)
    imp, skip = torch_import.load_pretrained_trunk(str(path), pipe)
    jvars = copy.deepcopy(variables)
    jvars, jimp, jskip = jimport.load_pretrained_trunk(str(path), jvars)
    assert (imp, skip) == (jimp, jskip)
    assert_state_equal(pipe.posenet.state_dict(), posenet_state_dict(jvars["posenet"]))


def _estimate(pipe, inputs):
    return pipe.estimate(*map(torch.from_numpy, inputs), refine_iterations=2)


def test_jax_exported_pth_loads_and_estimates_as_jax(case, tmp_path):
    """JAX's save_reference_checkpoint .pth files into the port: every
    tensor equal to load_jax_variables', and the estimate equal to JAX's
    at f32 2e-3; the same from a PoseNet file with DataParallel's
    `module.` segments in its keys and no BatchNorm counters."""
    jpipe, variables, inputs = case
    pose, refine = tmp_path / "pose_model.pth", tmp_path / "pose_refine_model.pth"
    jexport.save_reference_checkpoint(variables, str(pose), str(refine))
    pipe = torch_import.load_reference_checkpoint(str(pose), port_pipe(), str(refine))
    ref = port_pipe(variables)
    assert_state_equal(pipe.posenet.state_dict(), ref.posenet.state_dict())
    assert_state_equal(pipe.refiner.state_dict(), ref.refiner.state_dict())
    got = _estimate(pipe, inputs)
    want = jpipe.estimate(variables, *map(jnp.asarray, inputs), refine_iterations=2)
    np.testing.assert_allclose(got.quat.numpy(), np.asarray(want.quat), atol=2e-3)
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans), atol=2e-3)

    wrapped = {}
    for k, v in torch.load(pose, weights_only=True).items():
        if k.endswith("num_batches_tracked"):
            continue
        head, _, rest = k.partition(".")
        wrapped[f"module.{head}.module.{rest}" if head == "cnn" else f"module.{k}"] = v
    torch.save(wrapped, tmp_path / "wrapped.pth")
    again = torch_import.load_reference_checkpoint(str(tmp_path / "wrapped.pth"),
                                                   port_pipe())
    assert_state_equal(again.posenet.state_dict(), ref.posenet.state_dict(),
                       skip_counters=True)
    again.refiner.load_state_dict(ref.refiner.state_dict())
    assert torch.equal(_estimate(again, inputs).quat, got.quat)


def test_reference_checkpoint_refuses_keys_it_cannot_place(tmp_path):
    pipe = port_pipe()
    sd = pipe.posenet.state_dict()
    torch.save({**sd, "feat.conv9.weight": torch.zeros(1)}, tmp_path / "extra.pth")
    with pytest.raises(ValueError, match=r"unmatched PoseNet keys: \['feat.conv9.weight'\]"):
        torch_import.load_reference_checkpoint(str(tmp_path / "extra.pth"), pipe)
    torch.save({k: v for k, v in sd.items() if k != "conv1_r.bias"},
               tmp_path / "short.pth")
    with pytest.raises(ValueError, match="missing from the checkpoint: .*conv1_r.bias"):
        torch_import.load_reference_checkpoint(str(tmp_path / "short.pth"), pipe)
    torch.save({**sd, "conv1_r.bias": torch.zeros(3)}, tmp_path / "shape.pth")
    with pytest.raises(ValueError, match="shape mismatch at conv1_r.bias"):
        torch_import.load_reference_checkpoint(str(tmp_path / "shape.pth"), pipe)


def test_port_export_is_recovered_bit_equal_by_jax(case, tmp_path):
    """The port's save_reference_checkpoint (counters included) read by
    JAX's load_reference_checkpoint: every tensor back bit for bit."""
    _, variables, _ = case
    pipe = port_pipe()
    with torch.no_grad():
        pipe.posenet.cnn.model.feats.bn1.num_batches_tracked.fill_(7)
    pose, refine = tmp_path / "p.pth", tmp_path / "r.pth"
    nets = {"posenet": pipe.posenet.state_dict(), "refiner": pipe.refiner.state_dict()}
    torch_export.save_reference_checkpoint(nets, str(pose), str(refine))
    jvars = jimport.load_reference_checkpoint(str(pose), copy.deepcopy(variables),
                                              str(refine))
    assert_state_equal(posenet_state_dict(jvars["posenet"]), pipe.posenet.state_dict(),
                       skip_counters=True)
    assert_state_equal(refinenet_state_dict(jvars["refiner"]), pipe.refiner.state_dict())
    # the file holds the module's state dict, counters included
    assert_state_equal(torch.load(pose, weights_only=True), pipe.posenet.state_dict())


# ---------------- checked ----------------


@pytest.mark.parametrize("fn,arg", [
    (lambda m: m.log, -1.0), (lambda m: (lambda x: x / x), 0.0),
    (lambda m: m.sqrt, -4.0)], ids=["log_negative", "zero_by_zero", "sqrt_negative"])
def test_checked_raises_where_jax_raises(fn, arg):
    with pytest.raises(Exception, match="nan|division by zero"):
        jdebug.checked(fn(jnp))(jnp.asarray(arg))
    with pytest.raises(FloatingPointError, match="nan"):
        checked(fn(torch))(torch.tensor(arg))


def test_checked_returns_results_unchanged_and_checks_indices():
    def f(m, x, i):
        return (m.exp(x) * 2 - 1)[i].sum()

    jf, tf = functools.partial(f, jnp), functools.partial(f, torch)
    x = np.linspace(-1, 1, 7).astype(np.float32)
    i = np.array([0, 3, 6])
    want = jdebug.checked(jf)(jnp.asarray(x), jnp.asarray(i))
    got = checked(tf)(torch.from_numpy(x), torch.from_numpy(i))
    assert torch.equal(got, tf(torch.from_numpy(x), torch.from_numpy(i)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # on the CPU an index out of range raises in the operator itself
    bad = np.array([7])
    with pytest.raises(Exception, match="out-of-bounds"):
        jdebug.checked(jf)(jnp.asarray(x), jnp.asarray(bad))
    with pytest.raises(IndexError, match="out of bounds"):
        checked(tf)(torch.from_numpy(x), torch.from_numpy(bad))


def test_checked_raises_in_a_backward_and_passes_a_clean_one():
    w = torch.tensor([1.0, 0.0], requires_grad=True)

    def loss(w):
        y = torch.sqrt(w).sum()
        y.backward()
        return y

    with pytest.raises(FloatingPointError, match="inf generated by"):
        checked(loss)(w)
    w2 = torch.tensor([1.0, 4.0], requires_grad=True)
    assert float(checked(loss)(w2).detach()) == 3.0
    assert torch.allclose(w2.grad, torch.tensor([0.5, 0.25]))
