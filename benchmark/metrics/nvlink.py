"""The bytes a key-range exchange moves between cards, and its share of
the NVLink roofline.

One call of dist/mesh.py::exchange_rows(rows, send_counts, recv_counts)
sends send_counts[r] element-major rows of `rows` ([n, c], its element
size) to rank r and receives recv_counts[r] rows from it; a rank's share
for itself stays on its card and is left out.  Sending and receiving run
at once, so the least time of a call is its larger direction at the
card's NVLink bandwidth each way; a share is the least time of every
call over the device time of the collectives' kernels in the trace, in
per cent.
"""

from __future__ import annotations

import math

import torch

# NVIDIA H100 SXM, published: 900 GB/s of NVLink (18 links of the fourth
# generation), 450 GB/s each way
NVLINK_BYTES_PER_S = 450e9


def exchange_call_bytes(args, rank: int) -> int:
    """The larger direction of the bytes one recorded call of
    exchange_rows(rows, send_counts, recv_counts) moved between `rank`
    and the other ranks: rows x row width x element size."""
    (_kind, shape, dtype), send, recv = args[0], args[1], args[2]
    row = math.prod(shape[1:]) * getattr(torch, dtype.removeprefix("torch.")).itemsize
    return row * max(sum(send) - send[rank], sum(recv) - recv[rank])


def share(total_bytes: int, device_s: float):
    """Per cent of the NVLink roofline, or None where no device time was
    traced."""
    if not device_s or not total_bytes:
        return None
    return 100.0 * total_bytes / NVLINK_BYTES_PER_S / device_s
