"""The radix sort's share of its byte bound over every sort of the traced
window: the bytes each sort's elements need (metrics/roofline.py), from
the shapes of every call of kernels/sort._launch, at the card's
bandwidth, over the device time of the sort's kernels in the trace."""

from benchmark.metrics import roofline

CALLS = {"sort.calls": [("khoice_tpu_torch.kernels.sort", "_launch")]}
KERNELS = ("first_pass_kernel", "middle_pass_kernel", "last_pass_kernel")


def read(rec):
    if rec.trace is None or "khoice_tpu_torch.kernels.sort._launch" in rec.missing:
        return None
    total = sum(roofline.sort_call_bytes(a) for a in rec.recorder.args["sort.calls"])
    return roofline.share(total, rec.trace.kernel_seconds(KERNELS))
