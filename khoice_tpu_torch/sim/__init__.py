# Copied from khoice_tpu/sim/__init__.py.
from .reads import (
    sim_illumina,
    sim_ont,
    grab_reads,
    subset_reads_kmers,
    subset_features_half_mems,
    subset_features_mems,
)

__all__ = [
    "sim_illumina",
    "sim_ont",
    "grab_reads",
    "subset_reads_kmers",
    "subset_features_half_mems",
    "subset_features_mems",
]
