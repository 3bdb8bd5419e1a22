"""Host seconds per pass in rank 0's key-range exchanges: the program's
`dist:exchange` spans (dist/mesh.py's exchange_counts and exchange_rows:
the all_to_all of the shares and of the rows, with the wait for the
other ranks), outermost, read from the trace's user annotations.  A
program that opens none reads nothing."""

from benchmark.metrics import program_spans

NAMES = ("dist:exchange",)


def read(rec):
    if rec.trace is None:
        return None
    found = [e for e in rec.trace.spans if e.get("name") in NAMES]
    if not found:
        return None
    return rec.per_pass(program_spans.outermost_seconds(found, NAMES))
