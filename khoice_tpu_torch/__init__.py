"""PyTorch/CUDA port of khoice_tpu (the JAX/TPU k-mer engine).

The package mirrors khoice_tpu's layout module for module
(`engine/ksweep.py` <-> `khoice_tpu/engine/ksweep.py`, ...).  It imports
torch and never jax; the jax-free host layers of khoice_tpu (FASTA I/O,
reports, config, the stage driver, the oracle) are imported, not copied.
Every TPU Pallas kernel on a ported path is a hand-written CUDA kernel
under `csrc/`, built with nvcc at first use (kernels/_build.py).
"""
