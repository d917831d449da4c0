"""Console and file logging (a copy of dbw_tpu/utils/logger.py, kept here so
that the port never imports the JAX package)."""

import logging
import time
from pathlib import Path


class Verbose:
    mute = False


_logger = None


def create_logger(run_dir, name="dbw_torch"):
    """Log to ``run_dir/training.log`` besides the console."""
    global _logger
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fh = logging.FileHandler(Path(run_dir) / "training.log")
    fh.setFormatter(logging.Formatter("%(asctime)s - %(message)s"))
    logger.addHandler(fh)
    _logger = logger
    return logger


def print_log(msg, level="info"):
    if Verbose.mute:
        return
    stamp = time.strftime("%Y-%m-%d %H:%M:%S")
    color = {"info": "", "warning": "\033[93m", "error": "\033[91m"}.get(level, "")
    end = "\033[0m" if color else ""
    print(f"{color}[{stamp}] {msg}{end}", flush=True)
    if _logger is not None:
        getattr(_logger, level, _logger.info)(msg)


def print_warning(msg):
    print_log(msg, level="warning")
