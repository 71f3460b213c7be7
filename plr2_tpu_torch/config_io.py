"""YAML experiment configs over the typed config tree, the port of
plr2_tpu/config_io.py. An experiment is a YAML file that names an
optional base preset and replaces fields of its sections:

    preset: ycb_refine          # optional base preset
    dataset: {num_points: 1000, root: /data/ycb}
    model:   {dtype: bfloat16}
    train:   {lr: 1.0e-4, nepoch: 500}
    eval_refine_iterations: 2
    data_parallel: 1

The files are read by `data/codecs.read_yaml` and written by
`data/codecs.write_yaml`, which resolve and write scalars as PyYAML's
`safe_load` / `safe_dump` do; PyYAML itself is not needed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from plr2_tpu_torch.config import PipelineConfig, get_preset
from plr2_tpu_torch.data.codecs import read_yaml, write_yaml


def _replace_section(obj, overrides: Dict[str, Any]):
    valid = {f.name for f in dataclasses.fields(obj)}
    unknown = set(overrides) - valid
    if unknown:
        raise KeyError(f"unknown {type(obj).__name__} fields: {sorted(unknown)}")
    coerced = {k: tuple(v) if isinstance(v, list) else v
               for k, v in overrides.items()}
    return dataclasses.replace(obj, **coerced)


def config_from_dict(doc: Dict[str, Any]) -> PipelineConfig:
    """The preset `doc["preset"]` (default: `PipelineConfig()`) with the
    `dataset` / `model` / `train` fields and the top-level fields of `doc`
    replaced; lists become tuples. KeyError for an unknown field or key."""
    doc = dict(doc or {})
    preset = doc.pop("preset", None)
    cfg = get_preset(preset) if preset else PipelineConfig()
    sections = {name: _replace_section(getattr(cfg, name), doc.pop(name))
                for name in ("dataset", "model", "train") if name in doc}
    top_valid = {f.name for f in dataclasses.fields(cfg)}
    unknown = set(doc) - top_valid
    if unknown:
        raise KeyError(f"unknown config keys: {sorted(unknown)}")
    return dataclasses.replace(cfg, **sections, **doc)


def load_config(path: str) -> PipelineConfig:
    return config_from_dict(read_yaml(path))


def save_config(cfg: PipelineConfig, path: str) -> None:
    """Every field of `cfg`, in field order, as `load_config` reads it."""
    write_yaml(path, dataclasses.asdict(cfg))
