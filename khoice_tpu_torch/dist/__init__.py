"""The key-range SPMD path on torch.distributed (port of khoice_tpu/dist/:
mesh.py, sharded.py, occurrence.py, ksweep.py, ksweep_classify.py, exp6's
sharded votes in vote.py and the multi-process entry points in
multihost.py; the port's own launch.py starts a group's ranks in one
call).  The names exported are the JAX package's."""

from .mesh import make_mesh, split_keys_for
from .occurrence import sharded_occurrence_histogram
from .sharded import (
    ShardedKmerTable,
    sharded_count_codes,
    sharded_histogram,
    sharded_intersect_sum,
    sharded_set_counts,
    sharded_subtract,
    sharded_union_many,
)

__all__ = [
    "make_mesh",
    "split_keys_for",
    "ShardedKmerTable",
    "sharded_count_codes",
    "sharded_union_many",
    "sharded_intersect_sum",
    "sharded_subtract",
    "sharded_set_counts",
    "sharded_histogram",
    "sharded_occurrence_histogram",
]
