from plr2_tpu_torch.parallel.data_parallel import (TrainStep, adam,
                                                   make_train_step)

__all__ = ["TrainStep", "adam", "make_train_step"]
