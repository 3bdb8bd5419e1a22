"""PyTorch/CUDA port of khoice_tpu (the JAX/TPU k-mer engine).

The package mirrors khoice_tpu's layout module for module
(`engine/ksweep.py` <-> `khoice_tpu/engine/ksweep.py`, ...).  It imports
torch and never jax, and nothing of khoice_tpu: the host layers it needs
(config, the stage driver, logging, FASTA I/O with its native scanner,
packing, reports, read simulation, confusion matrices, exp0, the MEM layer
`mems/` with its native matching-statistics engine and the MEM experiments
exp5/7/8, the KMC database format) are copies, each naming the module it
was copied from on its first line; the native sources build with g++ into
the git-ignored `_build/`.
Every TPU Pallas kernel on a ported path is a hand-written CUDA kernel
under `csrc/`, built with nvcc at first use (kernels/_build.py).
"""
