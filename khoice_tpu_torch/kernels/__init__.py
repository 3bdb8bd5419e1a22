"""Hand-written CUDA kernels of the port and their Python wrappers.

Each wrapper checks its inputs, launches its kernel on the current
stream for CUDA tensors, and runs the plain PyTorch version for CPU
tensors only.  Sources live in `khoice_tpu_torch/csrc/`; `_build.py`
compiles them with nvcc at first use.
"""
