"""Device engine of the port: packing, tables and their ops, extraction,
the shared-sort k-sweep, budgets.  The names exported are the JAX
package's (khoice_tpu/engine/__init__.py)."""

from .table import SENTINEL, KmerTable, key_words
from .ops import (
    count_codes,
    histogram,
    intersect_sum,
    n_present,
    set_counts,
    subtract,
    total_count,
    union_many,
)
from .extract import extract_canonical, extract_canonical_sweep

__all__ = [
    "KmerTable",
    "key_words",
    "SENTINEL",
    "count_codes",
    "union_many",
    "intersect_sum",
    "subtract",
    "set_counts",
    "histogram",
    "n_present",
    "total_count",
    "extract_canonical",
    "extract_canonical_sweep",
]
