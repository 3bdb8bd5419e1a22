# Copied from khoice_tpu/runtime/__init__.py.
from .driver import Stage, Driver

__all__ = ["Stage", "Driver"]
