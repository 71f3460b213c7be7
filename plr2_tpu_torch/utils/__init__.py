from plr2_tpu_torch.utils.interrupt import GracefulInterrupt
from plr2_tpu_torch.utils.logger import setup_logger
from plr2_tpu_torch.utils.profiling import trace

__all__ = ["GracefulInterrupt", "setup_logger", "trace"]
