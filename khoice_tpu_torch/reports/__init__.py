# Copied from khoice_tpu/reports/__init__.py.
from .metrics import summarize_histogram_type1, summarize_histogram_type2
from .csvio import write_hist_txt, read_hist_txt

__all__ = [
    "summarize_histogram_type1",
    "summarize_histogram_type2",
    "write_hist_txt",
    "read_hist_txt",
]
