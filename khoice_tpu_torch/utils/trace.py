"""Named spans at the port's layer boundaries, on the profiler's clock.

    from ..utils import trace

    with trace.span("io:read_fasta"):
        ...

While a torch profiler records (`torch.profiler.profile`, as the
benchmark's traced run and `tools/profile_torch_sweep.py --out DIR` open
it), `span` opens `torch.profiler.record_function(name)`: a
`user_annotation` event on the host thread, on the same clock as the
device's kernels and copies, so each second the device waits can be put
down to the innermost span open on the host.  Otherwise it returns one
shared null context, and the check is all it costs.  There is no flag:
spans are on exactly while a profiler records.

Names are fixed strings `<layer>:<what>`, the layers of PERF.md's layer
map; nothing of a call goes into a name.  A span's parent is the span
enclosing it on the host thread; one `run` command is everything under
its `cli:run`.  The spans in SYNC_SPANS are the points where the host
waits on the device's stream (an upload from pageable memory, a read
back, the sort's statistics): every synchronising call of the traced
paths sits inside one of them.
"""

from __future__ import annotations

import contextlib

import torch

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()

# host->device copies, device->host reads, the radix sort's first pass
# and plan (its statistics read back)
SYNC_SPANS = ("engine:upload", "engine:readback", "kernel:sort_plan")


def span(name: str):
    """A context manager: `record_function(name)` while a profiler
    records, else the shared null context."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)
