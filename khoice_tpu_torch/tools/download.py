# Copied from khoice_tpu/tools/download.py.
"""NCBI genome/protein download adapters (network tooling, not compute).

Re-implements src/download_genomes.py and src/download_virus.py from the
reference: an Entrez esearch/esummary/xtract pipe finds the latest RefSeq
(or GenBank) assembly FTP paths per species
(src/download_genomes.py:46-81), wget fetches `*_genomic.fna.gz` (or
`*_protein.faa.gz` for the virus variant, src/download_virus.py:88) into
auto-numbered `database_{n}/dataset_{i}` folders
(src/download_genomes.py:250-261), and a README_dataset_summary.txt
records the mapping (:198-203).

This environment has zero egress, so the network calls are isolated in
`run_cmd` and the module is fully testable with a stub runner.
"""

from __future__ import annotations

import os
import subprocess
from typing import Callable, Dict, List, Optional, Sequence

from ..utils.logging import get_logger

log = get_logger("khoice.download")

Runner = Callable[[List[str], Optional[str]], str]


def _default_runner(cmd: List[str], stdin: Optional[str] = None) -> str:
    proc = subprocess.run(
        cmd, input=stdin, capture_output=True, text=True, check=True
    )
    return proc.stdout


def esearch_ftp_paths(
    species: str,
    database: str = "refseq",
    runner: Runner = _default_runner,
) -> List[str]:
    """FTP dir paths of 'latest refseq complete genome' assemblies for a
    species (reference query string, src/download_genomes.py:48-51)."""
    assert database in ("refseq", "genbank")
    query = f'{species}[Organism] AND ((latest[filter] OR "latest {database}"[filter]) AND "complete genome"[filter])'
    xtract_field = "FtpPath_RefSeq" if database == "refseq" else "FtpPath_GenBank"
    pipeline = (
        f"esearch -db assembly -query '{query}' | esummary | "
        f"xtract -pattern DocumentSummary -element {xtract_field}"
    )
    out = runner(["bash", "-c", pipeline], None)
    return [line.strip() for line in out.splitlines() if line.strip()]


def genomic_fna_url(ftp_dir: str) -> str:
    base = ftp_dir.rstrip("/").split("/")[-1]
    return f"{ftp_dir}/{base}_genomic.fna.gz"


def protein_faa_url(ftp_dir: str) -> str:
    base = ftp_dir.rstrip("/").split("/")[-1]
    return f"{ftp_dir}/{base}_protein.faa.gz"


def next_database_dir(out_root: str) -> str:
    """Auto-numbered database_{n} dir (src/download_genomes.py:252-261)."""
    n = 1
    while os.path.isdir(os.path.join(out_root, f"database_{n}")):
        n += 1
    path = os.path.join(out_root, f"database_{n}")
    os.makedirs(path)
    return path


def download_genomes(
    species_list: Sequence[str],
    out_root: str,
    num_genomes: Optional[int] = None,
    database: str = "refseq",
    protein: bool = False,
    runner: Runner = _default_runner,
) -> str:
    """Fetch genomes per species into dataset_{i} dirs; returns the
    database_{n} directory created."""
    db_dir = next_database_dir(out_root)
    summary = []
    for i, species in enumerate(species_list, start=1):
        ftp_dirs = esearch_ftp_paths(species, database=database, runner=runner)
        if num_genomes is not None:
            ftp_dirs = ftp_dirs[:num_genomes]
        urls = [
            protein_faa_url(d) if protein else genomic_fna_url(d)
            for d in ftp_dirs
        ]
        ddir = os.path.join(db_dir, "data", f"dataset_{i}")
        os.makedirs(ddir, exist_ok=True)
        url_file = os.path.join(ddir, "url_list.txt")
        with open(url_file, "w") as fd:
            fd.write("\n".join(urls) + "\n")
        if urls:
            runner(["wget", "--input-file", url_file, "-P", ddir, "-q"], None)
        summary.append((i, species, len(urls)))
        log.info("dataset_%d %s: %d assemblies", i, species, len(urls))

    with open(os.path.join(db_dir, "README_dataset_summary.txt"), "w") as fd:
        fd.write("Dataset summary\n")
        for i, species, n in summary:
            fd.write(f"dataset_{i}: {species} ({n} assemblies)\n")
    return db_dir
