"""Evaluation: ADD / ADD-S metrics and the VOCap AUC (`metrics`), the eval
protocol in per-crop and batched mode (`evaluator`), the offline
distance reports, tables and curves (`report`), predicted LineMOD masks
(`segment`); the config-5 full pipeline is `eval.full_pipeline`."""

from plr2_tpu_torch.eval.evaluator import EvalResult, evaluate
from plr2_tpu_torch.eval.metrics import (accuracy_threshold_curve,
                                         add_distance, adds_distance,
                                         compute_auc, pose_distance,
                                         success_rate)
from plr2_tpu_torch.eval.report import (accuracy_table,
                                        distances_from_mat_dir,
                                        format_accuracy_table,
                                        load_distance_report,
                                        plot_accuracy_curves,
                                        save_distance_report)
from plr2_tpu_torch.eval.segment import (segment_frame, segnet_predictor,
                                         write_segnet_results)

__all__ = ["EvalResult", "evaluate", "accuracy_threshold_curve",
           "add_distance", "adds_distance", "compute_auc", "pose_distance",
           "success_rate", "accuracy_table", "distances_from_mat_dir",
           "format_accuracy_table", "load_distance_report",
           "plot_accuracy_curves", "save_distance_report", "segment_frame",
           "segnet_predictor", "write_segnet_results"]
