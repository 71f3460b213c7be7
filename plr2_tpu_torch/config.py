"""Typed configuration, this package's own copy of plr2_tpu/config.py
(same dataclasses, fields, defaults and presets).

The hyperparameters are the reference curriculum's contract:
  num_points 500 (LineMOD) / 1000 (YCB), w=0.015, lr=1e-4,
  decay x0.3 when best test dis < 0.016, refine switch at dis < 0.013,
  iteration=2, noise_trans=0.03, batch_size=8 (accumulated), nepoch=500.

Fields that the port reads differently:
- `ModelConfig.use_pallas_model` switches nothing here. The port's
  pipeline always runs the hand-written kernels on a CUDA tensor (their
  plain versions only on CPU tensors); JAX's default (False) picks XLA's
  path for the same function. It is not mapped to the pipeline's
  `use_kernels`, whose False would run the plain versions on the card.
- `ModelConfig.phase_upsample` is the JAX package's rewrite of the decoder
  stage; the port's decoder is the `upconv3x3_prelu` kernel either way.
- `ModelConfig.dtype = "bfloat16"` is mixed-precision training: f32
  parameters, BN statistics and Adam state, bf16 compute
  (`DenseFusionPipeline(dtype=torch.bfloat16)`).
- `TrainConfig.workers > 0` feeds the trainers from the native data
  plane in that many threads (`data/prefetch.py`);
  `PipelineConfig.data_parallel > 1` and `model_parallel > 1` raise
  NotImplementedError in the trainers.
- `DatasetConfig.noise_trans` is the translation noise that both of the
  trainers' sample iterators draw (JAX's inline iterator draws 0.03).
- `TrainConfig.sym_slots` sizes `BatchTrainer`'s ADD-S compaction as in
  JAX; the port picks the loss's branch on the host from the samples'
  object ids, where JAX picks it on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """Dataset geometry & sampling contract (SURVEY.md section 2 #8/#9)."""

    name: str = "linemod"  # "linemod" | "ycb"
    root: str = ""
    num_points: int = 500  # sampled cloud points per object
    num_objects: int = 13
    num_mesh_points: int = 500  # model points used by the ADD loss
    # refine-stage mesh resolution (upstream num_pt_mesh_large: YCB scores
    # the joint stage against 2600 model points; LineMOD keeps 500)
    num_mesh_points_large: int = 500
    # symmetric object indices (LineMOD: eggbox=7, glue=8 in the 13-class
    # list; YCB: 12, 15, 18, 19, 20 — see _YCB_SYM below)
    sym_list: Tuple[int, ...] = (7, 8)
    add_noise: bool = True
    noise_trans: float = 0.03
    # smallest canvas of the batched modes (crops are stacked onto a
    # border-list-snapped canvas at least this large; data/loader.py)
    crop_size: int = 160
    img_height: int = 480
    img_width: int = 640


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """PoseNet/PoseRefineNet dimensions (upstream lib/network.py layout)."""

    num_points: int = 500
    num_objects: int = 13
    emb_dim: int = 32  # PSPNet per-pixel color embedding channels
    use_pallas_model: bool = False  # no switch in the port (module docstring)
    phase_upsample: bool = True  # no switch in the port (module docstring)
    dtype: str = "float32"  # compute dtype for the CNN trunk ("bfloat16" ok)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Curriculum schedule (upstream tools/train.py semantics)."""

    batch_size: int = 8  # gradient-accumulation count in the reference
    lr: float = 1e-4
    lr_rate: float = 0.3  # lr decay factor
    w: float = 0.015  # confidence regularization weight
    w_rate: float = 0.3  # w decay factor
    decay_margin: float = 0.016  # best test dis below this -> decay lr & w
    refine_margin: float = 0.013  # best test dis below this -> train refiner
    refine_iterations: int = 2  # on-device refine steps during joint stage
    nepoch: int = 500
    repeat_epoch: int = 1
    seed: int = 0
    # host data-plane worker threads; > 0 raises in the port
    workers: int = 0
    checkpoint_dir: str = "trained_models"
    log_dir: str = "experiments/logs"
    resume_posenet: str = ""
    resume_refinenet: str = ""
    start_epoch: int = 1
    # one accumulation window per optimizer step, stacked on a shared
    # canvas (train/fused_trainer.py); ignored in --batched mode
    fused_accum: bool = False
    # batched-mode mixed-batch ADD-S compaction (losses/add_loss.py
    # max_sym_slots): >0 = the chamfer of a batch with at most this many
    # symmetric samples runs on that many compacted slots (exact), -1 =
    # auto-size from the symmetric-object fraction, 0 = off
    sym_slots: int = -1
    # run the per-epoch test loop batched (batch_size samples per call on
    # a shared snapped canvas, cycle-padded tail) in Trainer and
    # FusedTrainer; BatchTrainer always does
    batched_test: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    # inference-time refinement iterations (BASELINE config 4 => 2, config 5 => 4)
    eval_refine_iterations: int = 2
    # data-parallel axis size; > 1 raises in the port (one device)
    data_parallel: int = 1
    # tensor-parallel mesh axis size; > 1 raises in the port
    model_parallel: int = 1


# YCB-Video symmetric objects (upstream datasets/ycb/dataset.py):
# 024_bowl, 036_wood_block, 051_large_clamp, 052_extra_large_clamp, 061_foam_brick
_YCB_SYM = (12, 15, 18, 19, 20)

_LINEMOD = DatasetConfig(
    name="linemod", num_points=500, num_objects=13, num_mesh_points=500,
    sym_list=(7, 8), crop_size=160,
)
_YCB = DatasetConfig(
    name="ycb", num_points=1000, num_objects=21, num_mesh_points=500,
    num_mesh_points_large=2600, sym_list=_YCB_SYM, crop_size=160,
)


def _preset_1() -> PipelineConfig:
    """LineMOD 'ape': PoseNet forward, batch 1, 500 points, CPU smoke."""
    return PipelineConfig(
        dataset=_LINEMOD,
        model=ModelConfig(num_points=500, num_objects=13),
        train=TrainConfig(batch_size=1),
        eval_refine_iterations=0,
    )


def _preset_2() -> PipelineConfig:
    """LineMOD 13-object PoseNet training with ADD loss (ADD-S for sym)."""
    return PipelineConfig(
        dataset=_LINEMOD,
        model=ModelConfig(num_points=500, num_objects=13),
        train=TrainConfig(),
    )


def _preset_3() -> PipelineConfig:
    """YCB 21-object PoseNet training, 1000 points, confidence-weighted loss."""
    return PipelineConfig(
        dataset=_YCB,
        model=ModelConfig(num_points=1000, num_objects=21),
        train=TrainConfig(),
    )


def _preset_4() -> PipelineConfig:
    """YCB PoseNet + PoseRefineNet 2-iter refinement (joint fine-tune)."""
    return PipelineConfig(
        dataset=_YCB,
        model=ModelConfig(num_points=1000, num_objects=21),
        train=TrainConfig(refine_iterations=2),
        eval_refine_iterations=2,
    )


def _preset_5() -> PipelineConfig:
    """Full pipeline: seg-mask crop + DenseFusion + 4-iter refine, batched."""
    return PipelineConfig(
        dataset=_YCB,
        model=ModelConfig(num_points=1000, num_objects=21),
        train=TrainConfig(refine_iterations=2),
        eval_refine_iterations=4,
        data_parallel=1,
    )


PRESETS = {
    "linemod_smoke": _preset_1,
    "linemod_train": _preset_2,
    "ycb_train": _preset_3,
    "ycb_refine": _preset_4,
    "full_pipeline": _preset_5,
}


def get_preset(name: str) -> PipelineConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()
