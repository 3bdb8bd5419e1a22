# Copied from khoice_tpu/mems/__init__.py.
from .ms import MatchingStatisticsIndex
from .extract import extract_half_mems, extract_mems, Feature
from .analyze import analyze_features, write_outputs

__all__ = [
    "MatchingStatisticsIndex",
    "extract_half_mems",
    "extract_mems",
    "Feature",
    "analyze_features",
    "write_outputs",
]
