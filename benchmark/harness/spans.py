"""Host spans, call shapes and counters, taken from outside the program.

In the traced run the benchmark replaces functions of the program at the
name each module bound on import (`pipelines/exp1` binds
`encode_records` itself, for example) with a wrapper that adds the
outermost call's seconds to its span, annotates the profiler's trace
with the span's name and, where asked, keeps a summary of the call's
arguments (tensor shapes).  Counters are read before and after the
window.  Nothing of the program is edited; every wrapper is taken out
when the window closes.  A name that is not there is noted, and the
metrics that need it read nothing.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time
from collections import defaultdict


def summarize(value):
    """A picklable summary of an argument: ("tensor", shape, dtype) for a
    tensor, lists of ints as they are, other values as they are."""
    shape = getattr(value, "shape", None)
    if shape is not None and hasattr(value, "dtype"):
        return ("tensor", tuple(int(d) for d in shape), str(value.dtype))
    if isinstance(value, (list, tuple)):
        return [summarize(v) for v in value]
    return value


def _resolve(module: str, attr: str):
    try:
        mod = importlib.import_module(module)
    except ImportError:
        return None, None
    return mod, getattr(mod, attr, None)


def counter_total(value) -> int:
    """A counter's count: an int, or the sum of a dict of ints."""
    if isinstance(value, dict):
        return sum(int(v) for v in value.values())
    return int(value)


class Recorder:
    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.seconds = defaultdict(float)
        self.args = defaultdict(list)
        self.missing = set()
        self._depth = defaultdict(int)
        self._undo = []
        self._counters = {}
        self.counter_deltas = {}

    def wrap(self, label: str, module: str, attr: str, capture: bool = False) -> None:
        mod, fn = _resolve(module, attr)
        if fn is None or not callable(fn):
            self.missing.add(f"{module}.{attr}")
            return
        rec = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            rec._depth[label] += 1
            t0 = time.perf_counter()
            try:
                with rec.annotation(label):
                    return fn(*args, **kwargs)
            finally:
                rec._depth[label] -= 1
                if rec._depth[label] == 0:
                    rec.seconds[label] += time.perf_counter() - t0
                if capture:
                    rec.args[label].append(summarize(args))

        setattr(mod, attr, wrapper)
        self._undo.append((mod, attr, fn))

    def annotation(self, label: str):
        if not self.annotate:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(label)

    def watch(self, module: str, attr: str) -> None:
        mod, value = _resolve(module, attr)
        if value is None:
            self.missing.add(f"{module}.{attr}")
            return
        self._counters[(module, attr)] = counter_total(value)

    def read_counters(self) -> None:
        for (module, attr), before in self._counters.items():
            _mod, value = _resolve(module, attr)
            self.counter_deltas[f"{module}.{attr}"] = counter_total(value) - before

    def restore(self) -> None:
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()
