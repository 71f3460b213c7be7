from plr2_tpu_torch.geometry.pointcloud import compose_pose, recenter_points
from plr2_tpu_torch.geometry.quaternion import (normalize_quaternion,
                                                quat_multiply,
                                                quat_to_matrix_df)

__all__ = ["compose_pose", "recenter_points", "normalize_quaternion",
           "quat_multiply", "quat_to_matrix_df"]
