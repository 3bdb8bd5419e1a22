"""Device-idle seconds per pass that the engine and its kernels leave:
the traced window's idle gaps (harness/trace.py `idle_gaps`, seconds with
no kernel, copy or set on the device) whose innermost open span is one
of the program's `engine:` or `kernel:` spans.  On a device that the
trace holds no events of, every second of the window counts as idle, as
in the breakdown's idle gaps."""

from benchmark.metrics import program_spans


def read(rec):
    if program_spans.spans(rec) is None:
        return None
    gaps = rec.trace.idle_gaps(top=None)
    return rec.per_pass(sum(s for label, s in gaps if label.startswith(("engine:", "kernel:"))))
