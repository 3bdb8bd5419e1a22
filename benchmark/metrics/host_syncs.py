"""Host syncs per pass: the program's spans in which the host waits on
the device's stream (metrics/program_spans.py `SYNCS`: every upload from
pageable memory, every read back, every radix sort's first pass and
plan), counted in the traced window."""

from benchmark.metrics import program_spans


def read(rec):
    found = program_spans.spans(rec)
    if found is None:
        return None
    return rec.per_pass(sum(e["name"] in program_spans.SYNCS for e in found))
