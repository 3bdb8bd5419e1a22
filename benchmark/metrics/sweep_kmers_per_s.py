"""sweep_kmers_per_s: canonical k-mers swept in the window (grid points
times positions, summed over every set of every pass) over the window's
seconds, in millions per second, on the host's clock."""


def read(rec):
    kmers = rec.work.get("kmers")
    return kmers / rec.window_s / 1e6 if kmers else None
