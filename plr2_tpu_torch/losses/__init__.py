from plr2_tpu_torch.losses.add_loss import PoseLossOut, pose_loss
from plr2_tpu_torch.losses.refine_loss import RefineLossOut, refine_loss

__all__ = ["PoseLossOut", "pose_loss", "RefineLossOut", "refine_loss"]
