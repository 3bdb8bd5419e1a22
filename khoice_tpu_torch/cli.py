"""Command-line interface: `python -m khoice_tpu_torch run --exp-type 1 ...`.

The flags are khoice_tpu's (`python -m khoice_tpu run ...`) plus
`--device` (default `cuda`).  The port runs exp1 on one device; every
other experiment is served by `python -m khoice_tpu` until it is ported.
Inputs follow the reference database layout
(`database_root/dataset_{i}/*.fna.gz`); outputs land under --work-root
with the reference's directory names, and a run whose outputs exist is
skipped (runtime/driver.py) unless --force.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from khoice_tpu.config import KhoiceConfig
from khoice_tpu.runtime.driver import Driver, Stage
from khoice_tpu.utils.logging import get_logger

log = get_logger("khoice.cli")

PORTED_EXP_TYPES = (1,)


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device is available; pass --device cpu to run the plain "
            "PyTorch path on the CPU"
        )
    return device


def cmd_run(args) -> int:
    cfg = KhoiceConfig.from_yaml(args.config) if args.config else KhoiceConfig()
    if args.work_root:
        cfg.work_root = args.work_root
    if args.database_root:
        cfg.database_root = args.database_root
    if args.exp_type is not None:
        cfg.exp_type = args.exp_type
    if args.k_values:
        cfg.k_values = [int(x) for x in args.k_values.split(",")]
    if args.device_budget_gb:
        cfg.device_budget_gb = args.device_budget_gb
    if cfg.exp_type not in PORTED_EXP_TYPES:
        raise SystemExit(
            f"exp-type {cfg.exp_type} is not ported to khoice_tpu_torch yet; "
            "it is served by `python -m khoice_tpu run` until ported"
        )
    if args.mesh_shards and args.mesh_shards > 1:
        raise SystemExit(
            "--mesh-shards > 1 (the sharded sweep) is not ported to "
            "khoice_tpu_torch yet; it is served by `python -m khoice_tpu run`"
        )
    if args.trials and args.trials > 1:
        log.warning("--trials=%d ignored for exp_type=1 (exp1 has no trial axis)",
                    args.trials)
    for flag, value in (("--num-datasets", args.num_datasets),
                        ("--kmers-per-dataset", args.kmers_per_dataset)):
        if value:
            log.warning("%s=%d ignored for exp_type=1 (it reads every dataset "
                        "and every k-mer)", flag, value)
    device = _device(args.device)

    from khoice_tpu.pipelines.exp0 import load_database_dir

    from .pipelines.exp1 import run_exp1

    db = load_database_dir(cfg.database_root)
    if not db:
        raise SystemExit(f"no dataset_N directories under {cfg.database_root}")
    log.info("exp_type=1 datasets=%d k-grid=%d points device=%s",
             len(db), len(cfg.k_values), device)
    groups = {num: [db[num][name] for name in sorted(db[num])] for num in db}
    Driver(cfg.work_root, force=args.force).run([Stage(
        name="exp1",
        outputs=[
            os.path.join(cfg.work_root, "step_5/within_datasets_analysis.csv"),
            os.path.join(cfg.work_root, "step_9/across_datasets_analysis.csv"),
        ],
        fn=lambda: run_exp1(
            groups, cfg.k_values, cfg.work_root, device,
            union_cs=cfg.union_cs, hist_cx=cfg.hist_cx,
            device_budget_bytes=(
                int(cfg.device_budget_gb * 2**30) if cfg.device_budget_gb else None
            ),
        ),
    )])
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="khoice-tpu-torch",
        description="k-mer discriminatory-power analysis engine (PyTorch/CUDA port)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="run an experiment pipeline")
    run_p.add_argument("--exp-type", type=int, default=None)
    run_p.add_argument("--config", default=None, help="YAML config (reference schema)")
    run_p.add_argument("--work-root", default=None)
    run_p.add_argument("--database-root", default=None)
    run_p.add_argument("--k-values", default=None, help="comma-separated k grid override")
    run_p.add_argument("--num-datasets", type=int, default=None,
                       help="ignored by exp1, which reads every dataset")
    run_p.add_argument("--kmers-per-dataset", type=int, default=None,
                       help="size of exp3's simulated reads per dataset (ignored by exp1)")
    run_p.add_argument("--mesh-shards", type=int, default=None,
                       help="devices along the k-mer key-range mesh axis (not ported: 1 only)")
    run_p.add_argument("--device-budget-gb", type=float, default=None,
                       help="device memory budget for the exp1 sweep (default: "
                            "85%% of the device; groups beyond it raise, the "
                            "streaming sweep is not ported)")
    run_p.add_argument("--trials", type=int, default=None,
                       help="fan the experiment over trials 1..N (ignored by exp1)")
    run_p.add_argument("--force", action="store_true", help="ignore satisfied outputs")
    run_p.add_argument("--device", default="cuda",
                       help="torch device to run on (default cuda; cpu runs the "
                            "plain PyTorch path)")
    run_p.set_defaults(fn=cmd_run)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
