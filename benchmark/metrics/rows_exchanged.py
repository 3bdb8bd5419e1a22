"""Rows sent per pass between the ranks of a sharded cell, summed over
every rank, in millions: each rank's count of rows exchange_rows sent to
the other ranks over the window (dist/mesh.py's `exchanged`, its share
for itself left out), from the traffic's `work()`."""


def read(rec):
    ranks = rec.work.get("ranks")
    if not ranks:
        return None
    return rec.per_pass(sum(r["rows_sent"] for r in ranks) / 1e6)
