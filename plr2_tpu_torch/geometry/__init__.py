from plr2_tpu_torch.geometry.pointcloud import (apply_pose_quat,
                                               backproject_depth,
                                               compose_pose, recenter_points,
                                               transform_points)
from plr2_tpu_torch.geometry.quaternion import (matrix_to_quat,
                                                normalize_quaternion,
                                                quat_multiply, quat_to_matrix,
                                                quat_to_matrix_df)

__all__ = ["apply_pose_quat", "backproject_depth", "compose_pose",
           "recenter_points", "transform_points", "matrix_to_quat",
           "normalize_quaternion", "quat_multiply", "quat_to_matrix",
           "quat_to_matrix_df"]
