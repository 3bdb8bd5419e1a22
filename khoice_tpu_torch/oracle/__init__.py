# Copied from khoice_tpu/oracle/__init__.py.
from .pykmc import (
    canonical,
    count_kmers,
    set_counts,
    union_sum,
    intersect_sum,
    subtract,
    histogram,
    revcomp,
    sorted_dump,
)

__all__ = [
    "canonical",
    "count_kmers",
    "set_counts",
    "union_sum",
    "intersect_sum",
    "subtract",
    "histogram",
    "revcomp",
    "sorted_dump",
]
