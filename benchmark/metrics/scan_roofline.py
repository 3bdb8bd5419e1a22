"""The multi-k scan's share of its byte bound over every scan of the
traced window: the bytes each call needs (metrics/roofline.py), from the
shapes of every call of kernels/ksweep_scan._launch, at the card's
bandwidth, over the device time of the scan kernel in the trace."""

from benchmark.metrics import roofline

CALLS = {"scan.calls": [("khoice_tpu_torch.kernels.ksweep_scan", "_launch")]}
KERNELS = ("scan_tiles",)


def read(rec):
    if rec.trace is None or "khoice_tpu_torch.kernels.ksweep_scan._launch" in rec.missing:
        return None
    total = sum(roofline.scan_call_bytes(a) for a in rec.recorder.args["scan.calls"])
    return roofline.share(total, rec.trace.kernel_seconds(KERNELS))
