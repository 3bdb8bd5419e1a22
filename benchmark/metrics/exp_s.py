"""exp_s: the window's seconds over the experiment passes it completed,
on the host's clock: what a user waits for one experiment, from the
database read to the last CSV written."""


def read(rec):
    return rec.window_s / rec.passes
