"""Build the port's CUDA sources into one shared library and load it.

At first use, one `nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17
-O3 -Xcompiler -fPIC -c` per `khoice_tpu_torch/csrc/*.cu`, all started
together, then one `nvcc -shared` link, into `khoice_tpu_torch/_build/`
(git-ignored), keyed by a hash of the sources and the flags, so an edit
rebuilds and an unchanged tree reuses the library.  The sources expose a
plain C interface, bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# (restype, argtypes) of every C entry point; pointers and the stream are
# c_void_p so ctypes never truncates them to 32 bits
_SIGNATURES = {
    "ksweep_scan_tile_elems": (ctypes.c_int, []),
    "ksweep_scan_max_ks": (ctypes.c_int, []),
    "ksweep_scan_hist_bytes_max": (ctypes.c_int, []),
    "ksweep_scan_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]),
    "extract_canonical_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]),
    "extract_canonical_tile_elems": (ctypes.c_int, []),
    "extract_sweep_tile_elems": (ctypes.c_int, []),
    "extract_sweep_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]),
    "radix_sort_tile_elems": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
    "radix_sort_first_pass": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]),
    "radix_sort_passes": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]),
    "occ_scan_tile_elems": (ctypes.c_int, []),
    "occ_scan_bins_max": (ctypes.c_int, []),
    "occ_scan_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]),
    "vote_mask_tile_elems": (ctypes.c_int, []),
    "vote_mask_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]),
    "read_votes_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]),
}

# seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the port's CUDA kernels cannot be built")
    return path


def _sources() -> list:
    srcs = sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as fd:
            h.update(os.path.basename(src).encode() + fd.read())
    return os.path.join(BUILD_DIR, f"libkhoice_kernels_{h.hexdigest()[:16]}.so")


def _compile(tmpdir: str) -> str:
    """Compile every source to an object in parallel, link the objects;
    returns the build log (ptxas's report for every kernel)."""
    srcs = _sources()
    objs = [os.path.join(tmpdir, os.path.basename(src) + ".o") for src in srcs]
    procs = [
        subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)
    ]
    logs, failed = [], []
    for src, proc in zip(srcs, procs):
        out = proc.communicate()[0]
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    so = os.path.join(tmpdir, "lib.so")
    proc = subprocess.run([_nvcc(), "-shared", "-o", so, *objs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    return "".join(logs)


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this tree."""
    global build_seconds
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            log = _compile(tmpdir)
            with open(so + ".log", "w") as fd:
                fd.write(log)
            os.replace(os.path.join(tmpdir, "lib.so"), so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def build_log() -> str:
    """nvcc's output of the build (ptxas register and spill report)."""
    path = library_path() + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as fd:
        return fd.read()
