"""The parallel layer, the port of plr2_tpu/parallel (module docstrings
say how each maps JAX's single-controller mesh onto process groups)."""

from plr2_tpu_torch.parallel.data_parallel import (TrainStep, adam,
                                                   make_inference_step,
                                                   make_train_step)
from plr2_tpu_torch.parallel.mesh import (batch_sharding, init_distributed,
                                          make_mesh, replicated, shard_batch)
from plr2_tpu_torch.parallel.pipeline_parallel import (make_pp_estimate_step,
                                                       make_pp_refine)
from plr2_tpu_torch.parallel.point_parallel import (make_sp_inference_step,
                                                    make_sp_train_step,
                                                    sp_chamfer, sp_match)
from plr2_tpu_torch.parallel.tensor_parallel import (shard_pipeline,
                                                     shard_variables,
                                                     sharded_param_count,
                                                     tp_shardings, tp_spec)

__all__ = ["TrainStep", "adam", "batch_sharding", "init_distributed",
           "make_inference_step", "make_mesh", "make_pp_estimate_step",
           "make_pp_refine", "make_sp_inference_step", "make_sp_train_step",
           "make_train_step", "replicated", "shard_batch", "shard_pipeline",
           "shard_variables", "sharded_param_count", "sp_chamfer", "sp_match",
           "tp_shardings", "tp_spec"]
