# Copied from khoice_tpu/utils/logging.py.
"""The port's loggers: `get_logger(name)`, one stderr handler a logger,
its level from KHOICE_LOG_LEVEL (default INFO).

The reference's only observability is `print("[log] ...")` lines scattered
through its scripts (e.g. src/merge_lists.py:92-98) plus Snakemake's rule
timing.  The original's stage timers, throughput counters and
`profiler_trace` (a jax.profiler wrapper) are left out: the port's timing
is its spans (utils/trace.py), which torch.profiler records, and
runtime/driver.py's seconds per stage.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "khoice") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("KHOICE_LOG_LEVEL", "INFO"))
    return logger
