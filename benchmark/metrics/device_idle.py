"""The share of the traced window with no kernel, copy or set running on
the device (the union of their intervals, metrics/busy.py), in per cent."""


def read(rec):
    if rec.trace is None or not rec.trace.busy_s:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.window_s)
