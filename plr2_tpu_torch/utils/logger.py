"""Per-epoch text logging (the reference's lib/utils.py setup_logger —
SURVEY.md section 5.5); this package's own copy of plr2_tpu/utils/logger.py."""

from __future__ import annotations

import logging
import os


def setup_logger(name: str, log_file: str, level=logging.INFO) -> logging.Logger:
    os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fh = logging.FileHandler(log_file)
    fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(sh)
    logger.propagate = False
    return logger
