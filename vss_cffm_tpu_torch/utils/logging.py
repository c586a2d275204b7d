"""A logger writing to the stream and to ``work_dir/<timestamp>.log``
(the port's copy of ``vss_cffm_tpu/utils/logging.py``; reference
``mmseg/utils/logger.py:6-27`` and mmcv's TextLoggerHook cadence)."""

from __future__ import annotations

import logging
import os
import time

from .. import parallel

__all__ = ["get_logger"]

_LOGGERS: dict[str, logging.Logger] = {}


def get_logger(work_dir: str | None = None, name: str = "vss_cffm_tpu_torch") -> logging.Logger:
    """The logger ``name``, made once; INFO on rank 0, WARNING on the other
    ranks (mmcv's ``get_root_logger``; the JAX CLIs' rank-0 logging)."""
    level = logging.INFO if parallel.is_main() else logging.WARNING
    if name in _LOGGERS:
        _LOGGERS[name].setLevel(level)
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if work_dir:
        os.makedirs(work_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(os.path.join(work_dir, f"{stamp}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _LOGGERS[name] = logger
    return logger
