"""The key-range exchange's share of the NVLink roofline over the traced
window, on rank 0: the larger direction of the bytes each exchange_rows
call moved to and from the other ranks (metrics/nvlink.py), from the
shapes of every call at the name dist/sharded.py binds, at 450 GB/s, over
the device time of the NCCL kernels in rank 0's trace (the collectives:
the exchanges of rows and of their counts, the reductions, the gathers
of split samples)."""

from benchmark.metrics import nvlink

CALLS = {"exchange.calls": [("khoice_tpu_torch.dist.sharded", "exchange_rows")]}


def read(rec):
    if rec.trace is None or "khoice_tpu_torch.dist.sharded.exchange_rows" in rec.missing:
        return None
    total = sum(nvlink.exchange_call_bytes(a, 0) for a in rec.recorder.args["exchange.calls"])
    device_s = sum(float(e["dur"]) for e in rec.trace.device
                   if e.get("cat") == "kernel" and "nccl" in e.get("name", "").lower()) / 1e6
    return nvlink.share(total, device_s)
