from plr2_tpu_torch.parallel.data_parallel import TrainStep, make_train_step

__all__ = ["TrainStep", "make_train_step"]
