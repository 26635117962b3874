"""Build the port's CUDA kernels with nvcc at first use and load them.

Each source in ``csrc/`` becomes a shared library with a plain C interface,
compiled for Hopper (``sm_90a``) into ``build/`` beside this file (listed in
``.gitignore``) and loaded with ``ctypes``.  A library's file name carries a
hash of the sources and flags, so an edited kernel is rebuilt.  A source may
be built with preprocessor ``defines`` too, a library of its own: K1's, K2's
and K7's with ``BN_EPILOGUE``, their bodies with the eval BatchNorm as
their epilogue (``ops/epilogue.py``), which serving loads beside the
libraries built without it.  Nothing is
built or imported when this module is imported: a machine without nvcc can
import the package and use the kernels' plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
SOURCES = ("depthwise.cu", "dw_fused.cu", "depthwise_bwd.cu", "dw_fused_bwd.cu",
           "pw_stats.cu", "pointwise.cu", "depthwise_pbwd.cu", "fma_probe.cu",
           "jpeg.cu", "clip_prep.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# K1's, K2's and K7's sources are built a second time with BN_EPILOGUE:
# every body with the BN epilogue (kernels/csrc/common.cuh)
BN_EPILOGUE = ("X3D_BN_EPILOGUE",)
BN_EPILOGUE_SOURCES = ("depthwise.cu", "dw_fused.cu", "pointwise.cu")
# Flags of one source: the clip kernel rounds every product and sum as the
# plain version does (no contracted multiply-adds); the codec links nvJPEG.
COMPILE_FLAGS = {"clip_prep.cu": ("-fmad=false",)}
LINK_FLAGS = {"jpeg.cu": ("-lnvjpeg",)}

# nvcc's report per library (ptxas -v: registers, shared memory, spills),
# by library_name
build_logs: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[tuple, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (put it on PATH or set CUDA_HOME): the CUDA kernels "
        "are built from x3d_tpu_torch/kernels/csrc at first use")


def _flags(source: str, defines: Sequence[str] = ()) -> tuple:
    return (*NVCC_FLAGS, *COMPILE_FLAGS.get(source, ()),
            *(f"-D{d}" for d in defines))


def _library_path(source: str, defines: Sequence[str] = ()) -> str:
    digest = hashlib.sha256(" ".join(
        (*_flags(source, defines), *LINK_FLAGS.get(source, ()))).encode())
    for path in [os.path.join(CSRC, source)] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def library_name(source: str, defines: Sequence[str] = ()) -> str:
    """A library's key in :data:`build_logs`: the source, then its
    defines."""
    return " ".join((source, *defines))


def compile_source(source: str, defines: Sequence[str] = ()) -> str:
    """Compile ``csrc/<source>`` (with ``-D`` of each of ``defines``)
    unless its library exists; returns its path.  nvcc's report is kept
    beside the library (``.log``) and in :data:`build_logs`, also when an
    earlier process built it."""
    out = _library_path(source, defines)
    log, name = f"{out}.log", library_name(source, defines)
    if os.path.exists(out):
        if name not in build_logs and os.path.exists(log):
            with open(log) as f:
                build_logs[name] = f.read()
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *_flags(source, defines), "-o", tmp,
         os.path.join(CSRC, source),
         *LINK_FLAGS.get(source, ())],
        capture_output=True, text=True)
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    with open(f"{tmp}.log", "w") as f:
        f.write(build_logs[name])
    os.replace(f"{tmp}.log", log)
    os.replace(tmp, out)
    return out


def build_all() -> None:
    """Compile every kernel library at once, one nvcc process each: every
    source, and K1's, K2's and K7's with ``BN_EPILOGUE``."""
    libraries = [(s, ()) for s in SOURCES] + \
        [(s, BN_EPILOGUE) for s in BN_EPILOGUE_SOURCES]
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(lambda lib: compile_source(*lib), libraries))


def load(source: str, signatures: Dict[str, Sequence],
         defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The library built from ``csrc/<source>`` (with ``defines``), with
    each C function's argument types set (``c_void_p`` for pointers and the
    stream, so ctypes does not cut them to 32 bits).  Every function
    returns an int."""
    key = (source, *defines)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(compile_source(source, defines))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libs[key] = lib
    return lib
