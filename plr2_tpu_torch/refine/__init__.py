from plr2_tpu_torch.refine.iterative import initial_pose, iterative_refine

__all__ = ["initial_pose", "iterative_refine"]
