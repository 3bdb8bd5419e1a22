"""Host seconds per pass in exp6's read-level confusion rows: the
program's `reports:confusion` spans (each k's argmax and tie-break over
every dataset's votes, classify/confusion.py::read_level_confusion_row),
outermost."""

from benchmark.metrics import program_spans


def read(rec):
    found = program_spans.spans(rec)
    if found is None:
        return None
    return rec.per_pass(program_spans.outermost_seconds(found, ("reports:confusion",)))
