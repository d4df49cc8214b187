"""File and stream logger (PyTorch-port copy of uhc_tpu.utils.logger:
the reference's khrylib create_logger)."""
from __future__ import annotations

import logging
import os


def create_logger(log_dir: str, name: str = "uhc_tpu_torch") -> logging.Logger:
    """INFO logger writing `HH:MM:SS message` lines to log_dir/log.txt
    and to stderr; calling it again replaces the handlers."""
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(message)s", "%H:%M:%S")
    fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger
