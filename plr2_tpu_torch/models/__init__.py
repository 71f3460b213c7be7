from plr2_tpu_torch.models.posenet import PoseNet, PoseRefineNet
from plr2_tpu_torch.models.pspnet import PSPNet
from plr2_tpu_torch.models.weights import (init_random_, posenet_state_dict,
                                           refinenet_state_dict)

__all__ = ["PoseNet", "PoseRefineNet", "PSPNet", "init_random_",
           "posenet_state_dict", "refinenet_state_dict"]
