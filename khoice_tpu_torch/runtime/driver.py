# Copied from khoice_tpu/runtime/driver.py.
"""Resumable stage driver — the Snakemake-orchestration equivalent.

The reference's workflow engine provides exactly two properties this
framework needs (SURVEY.md section 5): file-based resume (a rule whose
outputs exist is skipped; interrupted runs pick up at the first
unsatisfied stage) and task fan-out. Here stages are Python callables with
declared output files; the driver skips satisfied stages, times the rest,
and writes a machine-readable run manifest. Device-level parallelism lives
below (the engine batches on-device), so there is no process fan-out —
one long-lived runtime replaces the per-rule process boundaries.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, List, Optional, Sequence

from ..utils.logging import get_logger


@dataclasses.dataclass
class Stage:
    name: str
    outputs: Sequence[str]
    fn: Callable[[], None]
    # temp outputs may be deleted by later stages (reference temp() role,
    # e.g. exp_type_3.smk:125) — a missing temp output doesn't force re-run
    # if every non-temp output downstream exists.
    temp: bool = False

    def satisfied(self) -> bool:
        return bool(self.outputs) and all(os.path.exists(p) for p in self.outputs)


class Driver:
    def __init__(self, work_root: str, force: bool = False):
        self.work_root = work_root
        self.force = force
        self.log = get_logger("khoice.driver")
        self.manifest: List[dict] = []

    def run(self, stages: List[Stage]) -> None:
        os.makedirs(self.work_root, exist_ok=True)
        for stage in stages:
            if not self.force and stage.satisfied():
                self.log.info("skip %s (outputs satisfied)", stage.name)
                self.manifest.append({"stage": stage.name, "status": "skipped"})
                continue
            t0 = time.time()
            self.log.info("run %s", stage.name)
            stage.fn()
            missing = [p for p in stage.outputs if not os.path.exists(p)]
            if missing:
                raise RuntimeError(
                    f"stage {stage.name} did not produce outputs: {missing}"
                )
            dt = time.time() - t0
            self.log.info("done %s (%.2fs)", stage.name, dt)
            self.manifest.append(
                {"stage": stage.name, "status": "ok", "elapsed_s": round(dt, 3)}
            )
        with open(os.path.join(self.work_root, "run_manifest.json"), "w") as fd:
            json.dump(self.manifest, fd, indent=2)
