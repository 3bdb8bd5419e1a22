# Copied from khoice_tpu/utils/__init__.py.
from .logging import get_logger

__all__ = ["get_logger"]
