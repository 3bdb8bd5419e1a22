"""Classification layers of the port: `confusion.py`, copied from the JAX
package, and `annotate.py`, the pivot annotation of exp4's per-k path and
exp6's read voting.  The names exported are the JAX package's
(khoice_tpu/classify/__init__.py)."""

from .annotate import Annotation, build_annotation, feature_buckets, read_votes
from .confusion import (
    accuracy_values,
    feature_confusion_rows,
    read_level_confusion_row,
    write_accuracy_csv,
    write_confusion_matrix,
)

__all__ = [
    "Annotation",
    "build_annotation",
    "feature_buckets",
    "read_votes",
    "accuracy_values",
    "feature_confusion_rows",
    "read_level_confusion_row",
    "write_confusion_matrix",
    "write_accuracy_csv",
]
