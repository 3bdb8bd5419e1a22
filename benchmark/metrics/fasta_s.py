"""Host seconds per pass in FASTA files read: the program's
`io:read_fasta` spans (one file decompressed and scanned each: the
database's genomes, exp0's reads loaded back), outermost."""

from benchmark.metrics import program_spans


def read(rec):
    found = program_spans.spans(rec)
    if found is None:
        return None
    return rec.per_pass(program_spans.outermost_seconds(found, ("io:read_fasta",)))
