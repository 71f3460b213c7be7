from plr2_tpu_torch.utils.interrupt import GracefulInterrupt
from plr2_tpu_torch.utils.logger import setup_logger
from plr2_tpu_torch.utils.profiling import Timer, time_fn, trace

__all__ = ["GracefulInterrupt", "Timer", "setup_logger", "time_fn", "trace"]
