"""setup_s: process start to the first timed pass (imports, CUDA context,
kernel libraries, the seeded inputs, exp0 where the mix needs it, the
warm pass), on the host's clock."""


def read(rec):
    return rec.setup_s
