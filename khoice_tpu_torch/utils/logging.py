# Copied from khoice_tpu/utils/logging.py.
"""Structured logging, stage timers and throughput counters.

The reference's only observability is `print("[log] ...")` lines scattered
through its scripts (e.g. src/merge_lists.py:92-98) plus Snakemake's rule
timing. Here every stage gets a timer and the engine-level k-mers/s
counters are first-class (the north-star metric, BASELINE.md).  The
original's `profiler_trace` (a jax.profiler wrapper) is left out: the port
imports no jax, and tools/profile_torch_sweep.py traces with torch.profiler.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "khoice") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("KHOICE_LOG_LEVEL", "INFO"))
    return logger


@contextlib.contextmanager
def stage_timer(name: str, logger: logging.Logger | None = None, **fields):
    log = logger or get_logger()
    t0 = time.time()
    log.info("stage_start %s %s", name, json.dumps(fields) if fields else "")
    try:
        yield
    finally:
        log.info("stage_done %s elapsed_s=%.3f", name, time.time() - t0)


class Throughput:
    """Accumulates (items, seconds) and reports items/s — used for the
    k-mers/s/chip counters."""

    def __init__(self, unit: str = "kmers"):
        self.unit = unit
        self.items = 0
        self.seconds = 0.0

    def add(self, items: int, seconds: float) -> None:
        self.items += items
        self.seconds += seconds

    @property
    def per_second(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0

    def report(self) -> str:
        return f"{self.items} {self.unit} in {self.seconds:.3f}s = {self.per_second / 1e6:.1f} M{self.unit}/s"

