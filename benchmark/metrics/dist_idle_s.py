"""Device-idle seconds per pass that rank 0 spends in the key-range
group's steps: the traced window's idle gaps (harness/trace.py
`idle_gaps`) whose innermost open span is one of the program's `dist:`
spans (the exchange, the split keys, the store barrier, the reductions):
rank 0's card waiting on its peers and on the host work between them.  A
program that opens no `dist:` span reads nothing."""


def read(rec):
    if rec.trace is None or not any(e.get("name", "").startswith("dist:")
                                    for e in rec.trace.spans):
        return None
    gaps = rec.trace.idle_gaps(top=None)
    return rec.per_pass(sum(s for label, s in gaps if label.startswith("dist:")))
