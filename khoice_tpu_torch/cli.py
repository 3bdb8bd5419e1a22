"""Command-line interface: `python -m khoice_tpu_torch run --exp-type N ...`.

The flags are khoice_tpu's (`python -m khoice_tpu run ...`) plus
`--device` (default `cuda`).  The port runs every experiment of the JAX
package: exp1-4 and exp6 on one device, on groups of any size and any k
grid (groups of more than 64 genomes and small grids take the per-k
fused path); exp0 and the MEM experiments exp5, 7 and 8 on the host, as
the JAX package does, so they take no device.  exp1-4 run sharded over a
key-range group of N ranks when `mesh_shards` (the flag or the config's)
is N > 1, one process per rank on its own device, and so does exp6's
read voting; at the end rank 0 logs each rank's rows sent and received
in the exchange (its share for itself excluded) and its peak device
memory:

    torchrun --nproc-per-node N -m khoice_tpu_torch run --exp-type 6 --mesh-shards N ...

(over several hosts, `torchrun --nnodes H --nproc-per-node N/H
--rdzv-endpoint HOST:PORT ...`).  Inputs follow the reference database layout
(`database_root/dataset_{i}/*.fna.gz`) and exp0's trial_{t}/ layout;
outputs land under --work-root with the reference's directory names, and
a stage whose outputs exist is skipped (runtime/driver.py) unless --force.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import torch
import torch.distributed as dist

from .config import KhoiceConfig
from .io.fasta import read_fasta
from .runtime.driver import Driver, Stage
from .utils import trace
from .utils.logging import get_logger

log = get_logger("khoice.cli")

EXP_TYPES = (0, 1, 2, 3, 4, 5, 6, 7, 8)
HOST_EXP_TYPES = (0, 5, 7, 8)  # they run nothing on a device
SHARDED_EXP_TYPES = (1, 2, 3, 4, 6)  # mesh_shards > 1 runs them over a key-range group


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device is available; pass --device cpu to run the plain "
            "PyTorch path on the CPU"
        )
    return device


def _trial_root(cfg: KhoiceConfig, root: str) -> str:
    return os.path.join(root, f"trial_{cfg.curr_trial}")


def _ensure_exp0(cfg: KhoiceConfig, db, root: str) -> dict:
    """Run exp0 for the current trial unless its outputs already exist."""
    from .pipelines.exp0 import run_exp0

    # key resume on exp0's LAST output (the trial summary): a run that died
    # mid-exp0 leaves earlier directories behind, and loading from those
    # partial outputs fails on missing read files
    marker = os.path.join(
        root, "trial_summaries", f"trial_{cfg.curr_trial}_summary.txt"
    )
    if os.path.isfile(marker):
        return _load_exp0(cfg, db, root)
    return run_exp0(db, cfg, cfg.curr_trial, root)


def _load_exp0(cfg: KhoiceConfig, db, root: str) -> dict:
    """Re-load a previously produced exp0 trial layout."""
    troot = _trial_root(cfg, root)
    pivots, nonpivots, reads = {}, {}, {}
    with trace.span("io:load_exp0"):
        for num in sorted(db):
            with open(os.path.join(troot, f"exp0_pivot_genomes/dataset_{num}/pivot_name.txt")) as fd:
                pivots[num] = fd.read().strip()
            with open(os.path.join(troot, f"exp0_nonpivot_genomes/dataset_{num}/nonpivot_names.txt")) as fd:
                nonpivots[num] = [x.strip() for x in fd if x.strip()]
            for rt in ("illumina", "ont"):
                path = os.path.join(troot, f"exp0_pivot_reads/dataset_{num}/{rt}/pivot_{num}_subset.fa")
                reads[(num, rt)] = [r.seq for r in read_fasta(path)]
    return {"pivots": pivots, "nonpivots": nonpivots, "reads": reads}


def cmd_run(args) -> int:
    """The `run` command, in its span `cli:run` (utils/trace.py); what it
    loaded is freed inside the span."""
    with trace.span("cli:run"):
        return _cmd_run(args)


def _cmd_run(args) -> int:
    cfg = KhoiceConfig.from_yaml(args.config) if args.config else KhoiceConfig()
    if args.work_root:
        cfg.work_root = args.work_root
    if args.database_root:
        cfg.database_root = args.database_root
    if args.exp_type is not None:
        cfg.exp_type = args.exp_type
    if args.k_values:
        cfg.k_values = [int(x) for x in args.k_values.split(",")]
    if args.num_datasets:
        cfg.num_datasets = args.num_datasets
    if args.kmers_per_dataset:
        cfg.kmers_per_dataset = args.kmers_per_dataset
    if args.mesh_shards:
        cfg.mesh_shards = args.mesh_shards
    if args.trials:
        cfg.num_trials = args.trials
    if args.device_budget_gb:
        cfg.device_budget_gb = args.device_budget_gb
    if cfg.exp_type not in EXP_TYPES:
        raise SystemExit(f"unknown exp type {cfg.exp_type}")
    sharded = cfg.mesh_shards > 1 and cfg.exp_type in SHARDED_EXP_TYPES
    if sharded:
        _check_launch(cfg.mesh_shards, args.device)
    elif cfg.mesh_shards > 1:
        log.warning("mesh_shards=%d ignored for exp_type=%d (it runs on the host)",
                    cfg.mesh_shards, cfg.exp_type)
    if cfg.exp_type == 1:
        for flag, value in (("--num-datasets", args.num_datasets),
                            ("--kmers-per-dataset", args.kmers_per_dataset)):
            if value:
                log.warning("%s=%d ignored for exp_type=1 (it reads every dataset "
                            "and every k-mer)", flag, value)
    device = _device(args.device) if cfg.exp_type not in HOST_EXP_TYPES else None

    owned = sharded and not dist.is_initialized()
    group = None
    if sharded:
        from .dist import mesh

        group = mesh.init_kv_group(device, world_size=cfg.mesh_shards)
        device = group.device
        if group.rank:  # rank 0 logs at info
            logging.disable(logging.INFO)
        log.info("sharded over %d ranks (kv key-range group), rank 0 on %s",
                 group.world_size, device)
        before = dict(mesh.exchanged)
    try:
        rc = _run_trials(cfg, args, device, group)
        if group is not None:
            totals = mesh.exchange_totals(group, before)
            log.info("exchange by rank: %s", json.dumps([
                {"rank": r, "rows_sent": sent, "rows_received": received,
                 "peak_device_bytes": peak} for r, (sent, received, peak) in enumerate(totals)]))
        return rc
    finally:
        if group is not None:
            logging.disable(logging.NOTSET)
        if owned:
            dist.destroy_process_group()


def _check_launch(mesh_shards: int, device_name: str) -> None:
    """A sharded run needs one process per rank, as torchrun starts them,
    and on CUDA one card per rank on the host; exit before any group
    starts if it has neither."""
    world = os.environ.get("WORLD_SIZE")
    if world is None or int(world) != mesh_shards:
        raise SystemExit(
            f"mesh_shards {mesh_shards} runs one process per rank; launch it with "
            f"`torchrun --nproc-per-node {mesh_shards} -m khoice_tpu_torch run ... "
            f"--mesh-shards {mesh_shards}` (WORLD_SIZE is {world})"
        )
    if torch.device(device_name).type == "cuda":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if torch.cuda.device_count() < local:
            raise SystemExit(
                f"{local} ranks on this host need {local} CUDA devices, and it has "
                f"{torch.cuda.device_count()}: NCCL runs one rank per card"
            )


def _run_trials(cfg: KhoiceConfig, args, device, group) -> int:
    from .pipelines.exp0 import load_database_dir

    db = load_database_dir(cfg.database_root)
    if not db:
        raise SystemExit(f"no dataset_N directories under {cfg.database_root}")

    # Multi-trial fan-out (reference NUM_TRIALS, prepare_data.smk:42-117):
    # exp0's and exp6's outputs are trial-keyed already; the other
    # exp0-dependent experiments write per-trial subroots so trials don't
    # clobber each other.
    if args.trials and args.trials > 1:
        if cfg.exp_type == 1:
            log.warning(
                "--trials=%d ignored for exp_type=1 (exp1 is deterministic "
                "over genomes; the reference's trial axis only exists for "
                "pivot/read experiments)", args.trials,
            )
        else:
            base_root = cfg.work_root
            rc = 0
            for t in range(1, args.trials + 1):
                cfg.curr_trial = t
                cfg.work_root = (
                    base_root if cfg.exp_type in (0, 6)
                    else os.path.join(base_root, f"trial_{t}_results")
                )
                log.info("=== trial %d/%d ===", t, args.trials)
                rc = max(rc, _run_one(cfg, args, db, device, exp0_root=base_root, group=group))
            cfg.work_root = base_root
            return rc
    return _run_one(cfg, args, db, device, exp0_root=cfg.work_root, group=group)


def _run_stages(driver: Driver, stages, group) -> None:
    """driver.run(stages); over a key-range group every rank makes rank 0's
    stage decisions: rank 0 checks a stage's resume markers and broadcasts
    whether it runs before any rank acts (a rank that skipped a stage that
    another entered would hang in its first collective); rank 0 runs it
    through a driver (the log, the outputs check, the manifest), the other
    ranks call its function, and a barrier closes it."""
    if group is None:
        driver.run(stages)
        return
    for stage in stages:
        todo = group.broadcast_flag(driver.force or not stage.satisfied())
        if group.rank == 0:
            Driver(driver.work_root, force=todo).run([stage])
        elif todo:
            stage.fn()
        group.barrier()


def _run_one(cfg: KhoiceConfig, args, db, device, exp0_root: str, group=None) -> int:
    driver = Driver(cfg.work_root, force=args.force)
    et = cfg.exp_type
    budget = int(cfg.device_budget_gb * 2**30) if cfg.device_budget_gb else None
    log.info("exp_type=%d datasets=%d k-grid=%d points device=%s",
             et, len(db), len(cfg.k_values), device)

    def genomes_of(num):
        return [db[num][name] for name in sorted(db[num])]

    if et == 0:
        driver.run([Stage(
            name="exp0",
            outputs=[os.path.join(exp0_root, f"trial_summaries/trial_{cfg.curr_trial}_summary.txt")],
            fn=lambda: _ensure_exp0(cfg, db, exp0_root),
        )])
    elif et == 1:
        from .pipelines.exp1 import run_exp1

        groups = {num: genomes_of(num) for num in db}
        _run_stages(driver, [Stage(
            name="exp1",
            outputs=[
                os.path.join(cfg.work_root, "step_5/within_datasets_analysis.csv"),
                os.path.join(cfg.work_root, "step_9/across_datasets_analysis.csv"),
            ],
            fn=lambda: run_exp1(
                groups, cfg.k_values, cfg.work_root, device,
                union_cs=cfg.union_cs, count_cs=cfg.count_cs, hist_cx=cfg.hist_cx,
                device_budget_bytes=budget, group=group,
            ),
        )], group)
    else:
        if group is None:
            exp0 = _ensure_exp0(cfg, db, exp0_root)
        else:  # rank 0 runs exp0 if needed; every rank reads its outputs
            if group.rank == 0:
                _ensure_exp0(cfg, db, exp0_root)
            group.barrier()
            exp0 = _load_exp0(cfg, db, exp0_root)
        pivots = {num: db[num][exp0["pivots"][num]] for num in db}
        nonpivot_genomes = {
            num: [db[num][n] for n in exp0["nonpivots"][num]] for num in db
        }
        rest = dict(nonpivot_genomes)  # exp4 and exp6's rest of set
        if not cfg.out_pivot:  # in-pivot adds the pivot to its own group
            rest = {num: rest[num] + [pivots[num]] for num in rest}
        if et == 2:
            from .pipelines.exp2 import run_exp2

            _run_stages(driver, [Stage(
                name="exp2",
                outputs=[os.path.join(cfg.work_root, "within_dataset_analysis_type_2/within_dataset_analysis.csv")],
                fn=lambda: run_exp2(pivots, nonpivot_genomes, cfg.k_values, cfg.work_root,
                                    device, union_cs=cfg.union_cs, hist_cx=cfg.hist_cx,
                                    device_budget_bytes=budget, group=group),
            )], group)
        elif et == 3:
            from .pipelines.exp3 import run_exp3, simulate_exp3_reads

            reads = simulate_exp3_reads(pivots, cfg.kmers_per_dataset, seed=cfg.read_sim_seed)
            _run_stages(driver, [Stage(
                name="exp3",
                outputs=[os.path.join(cfg.work_root, "final_analysis_type3/final_analysis_type3.csv")],
                fn=lambda: run_exp3(reads, nonpivot_genomes, cfg.k_values, cfg.work_root,
                                    device, union_cs=cfg.union_cs,
                                    device_budget_bytes=budget, group=group),
            )], group)
        elif et == 4:
            from .pipelines.exp4 import run_exp4

            _run_stages(driver, [Stage(
                name="exp4",
                outputs=[os.path.join(cfg.work_root, "accuracies_type_4/accuracy_values.csv")],
                fn=lambda: run_exp4(pivots, rest, cfg.k_values, cfg.work_root, device,
                                    count_cs=cfg.count_cs, union_cs=cfg.union_cs,
                                    device_budget_bytes=budget, group=group),
            )], group)
        elif et == 6:
            from .pipelines.exp6 import READ_TYPE_LABEL, run_exp6

            stages = []
            for rt in ("illumina", "ont"):
                reads_rt = {num: exp0["reads"][(num, rt)] for num in db}
                stages.append(Stage(
                    name=f"exp6_{rt}",
                    outputs=[os.path.join(cfg.work_root,
                                          f"trial_{cfg.curr_trial}_{READ_TYPE_LABEL[rt]}_acc.csv")],
                    fn=(lambda reads_rt=reads_rt, rt=rt: run_exp6(
                        reads_rt, rest, cfg.k_values, cfg.work_root, device, read_type=rt,
                        trial=cfg.curr_trial, seed=cfg.seed, device_budget_bytes=budget,
                        group=group)),
                ))
            _run_stages(driver, stages, group)
        elif et == 5:
            from .pipelines.exp5 import run_exp5

            driver.run([Stage(
                name="exp5",
                outputs=[os.path.join(cfg.work_root, "output_type_5/mems/confusion_matrix.csv")],
                fn=lambda: run_exp5(pivots, nonpivot_genomes, cfg.work_root,
                                    threshold=cfg.threshold, seed=cfg.seed),
            )])
        elif et == 7:
            from .pipelines.exp7 import run_exp7

            # both read types of exp0, four trial CSVs (exp_type_7.smk:36-47,284-292)
            reads7 = {
                rt: {num: exp0["reads"][(num, rt)] for num in db}
                for rt in ("illumina", "ont")
            }
            outputs7 = [
                os.path.join(cfg.work_root,
                             f"final_output_type_7/trial_{cfg.curr_trial}_{mt}_{rt}.csv")
                for mt in ("mems", "half_mems")
                for rt in ("illumina", "ont")
            ] + [
                os.path.join(cfg.work_root, f"output_type_7/{mt}/{rt}/confusion_matrix.csv")
                for mt in ("mems", "half_mems")
                for rt in ("illumina", "ont")
            ]
            driver.run([Stage(
                name="exp7",
                outputs=outputs7,
                fn=lambda: run_exp7(reads7, nonpivot_genomes, cfg.work_root,
                                    threshold=cfg.threshold, seed=cfg.seed,
                                    trial=cfg.curr_trial),
            )])
        else:
            from .pipelines.exp8 import run_exp8, simulate_exp8_reads

            # exp8 simulates its own reads from each pivot (2x Illumina +
            # depth-30 ONT, first-N subset; exp_type_8.smk:85-135)
            reads8 = simulate_exp8_reads(
                pivots, cfg.num_reads_per_dataset, seed=cfg.read_sim_seed
            )
            # every (mem_type, t, read_type) CSV is a stage output, so a
            # run killed between thresholds is not wrongly "satisfied"
            outputs8 = [
                os.path.join(cfg.work_root,
                             f"output_type_8/{mt}/t_{t}/{rt}/confusion_matrix.csv")
                for mt in ("mems", "half_mems")
                for t in cfg.t_values
                for rt in ("illumina", "ont")
            ]
            driver.run([Stage(
                name="exp8",
                outputs=outputs8,
                fn=lambda: run_exp8(reads8, nonpivot_genomes, cfg.work_root,
                                    t_values=cfg.t_values, seed=cfg.seed),
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
                       help="31-mer budget of the read sets exp0 and exp3 simulate "
                            "(ignored by exp1)")
    run_p.add_argument("--mesh-shards", type=int, default=None,
                       help="ranks of the k-mer key-range group for exp 1-4 and 6 (default 1: one "
                            "device); N > 1 needs N processes, one per device: launch with "
                            "`torchrun --nproc-per-node N -m khoice_tpu_torch run ... "
                            "--mesh-shards N` (NCCL on CUDA, one card per rank; gloo with "
                            "--device cpu)")
    run_p.add_argument("--device-budget-gb", type=float, default=None,
                       help="device memory budget of the exp1-4 sweeps, the per-k "
                            "sorts and exp6's votes (default: 85%% of the device; an "
                            "exp1 group beyond it streams in bounded memory, the other "
                            "steps raise)")
    run_p.add_argument("--trials", type=int, default=None,
                       help="fan exp0 and 2-8 over trials 1..N (reference NUM_TRIALS; "
                            "ignored by exp1)")
    run_p.add_argument("--force", action="store_true", help="ignore satisfied outputs")
    run_p.add_argument("--device", default="cuda",
                       help="torch device to run on (default cuda; cpu runs the "
                            "plain PyTorch path)")
    run_p.set_defaults(fn=cmd_run)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
