# Copied from khoice_tpu/engine/table_io.py.
"""KmerTable persistence — the `.kmc_pre`/`.kmc_suf` database-file role.

Every edge in the reference's DAG is a KMC database pair on disk
(reference: workflow/rules/exp_type_1.smk:160-161); stages resume because
satisfied outputs are skipped. The engine's equivalent: a table saved as a
compact .npz (present keys + counts only), plus the KMC-compatible text
formats (sorted dump, histogram) emitted by reports/csvio and
KmerTable.dump().

The port's tables are compact and keep no capacity (engine/table.py), so
where the JAX package's readers take `capacity` these take the `device`
the table is built on (default "cuda", as `table_from_host`).  The files
are the JAX package's: either package loads what the other writes.
"""

from __future__ import annotations

import os

import numpy as np

from .table import KmerTable, encode_kmer, key_words, table_from_host


def save_table(path: str, t: KmerTable) -> None:
    keys, counts = t.to_host()
    np.savez_compressed(path, k=np.int64(t.k), keys=keys, counts=counts)


def load_table(path: str, device="cuda") -> KmerTable:
    with np.load(path) as data:
        k = int(data["k"])
        keys = data["keys"]
        counts = data["counts"]
    return table_from_host(k, keys, counts, device=device)


def write_dump_txt(path: str, t: KmerTable) -> None:
    """`kmc_tools transform ... dump -s` text format: KMER\\tCOUNT, sorted
    (reference exp_type_4.smk:255-258)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fd:
        for kmer, count in t.dump():
            fd.write(f"{kmer}\t{count}\n")


def _from_kmers(k: int, kmers, counts, device) -> KmerTable:
    keys = (np.stack([encode_kmer(km) for km in kmers]) if kmers
            else np.zeros((0, key_words(k)), np.uint32))
    return table_from_host(k, keys, np.array(counts, np.uint32), device=device)


def read_dump_txt(path: str, k: int, device="cuda") -> KmerTable:
    kmers, counts = [], []
    with open(path) as fd:
        for line in fd:
            if line.strip():
                km, c = line.split()
                kmers.append(km)
                counts.append(int(c))
    return _from_kmers(k, kmers, counts, device)


def write_kmc_binary(path_prefix: str, t: KmerTable,
                     counter_size: int = 4) -> tuple:
    """Export a KmerTable as a KMC binary database pair
    (.kmc_pre/.kmc_suf; engine/kmc_format.py layout)."""
    from .kmc_format import write_kmc_database

    return write_kmc_database(path_prefix, dict(t.dump()), t.k,
                              counter_size=counter_size)


def read_kmc_binary(path_prefix: str, device="cuda") -> KmerTable:
    """Import a KMC binary database pair into a KmerTable."""
    from .kmc_format import read_kmc_database

    counts_dict, params = read_kmc_database(path_prefix)
    kmers = sorted(counts_dict)
    return _from_kmers(params["kmer_length"], kmers,
                       [counts_dict[km] for km in kmers], device)
