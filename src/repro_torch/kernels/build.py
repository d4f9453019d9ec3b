"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C launch function and is compiled on
first use into ``_build/<name>-<hash>.so`` beside this module (the directory
is git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

(``-Xptxas -v`` puts each kernel's registers and spills into the log that
``build`` returns.)

The hash covers the source and the flags, so an edited kernel rebuilds and
an unchanged one loads from the previous build.  Nothing here runs at
import time: the CPU tests import every module on a box without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> (exported launch function, its argtypes, its restype)
_C = ctypes
SIGNATURES = {
    "label_intersect": ("label_intersect_launch", [
        _C.c_void_p, _C.c_void_p, _C.c_int64, _C.c_int32, _C.c_int32,
        _C.c_void_p, _C.c_int64, _C.c_int32, _C.c_int32, _C.c_void_p,
        _C.c_void_p,
    ], _C.c_int),
    "frontier_or": ("frontier_or_launch", [
        _C.c_void_p, _C.c_int64, _C.c_int32, _C.c_void_p, _C.c_int64, _C.c_int32,
        _C.c_void_p, _C.c_int64, _C.c_void_p, _C.c_void_p, _C.c_void_p,
    ], _C.c_int),
    "frontier_expand": ("frontier_expand_launch", [
        _C.c_void_p, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_void_p, _C.c_void_p,
        _C.c_int64, _C.c_int64, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_int32, _C.c_void_p, _C.c_int32, _C.c_void_p, _C.c_int64, _C.c_void_p,
        _C.c_int32, _C.c_int32, _C.c_void_p, _C.c_void_p, _C.c_void_p,
    ], _C.c_int),
    "bitset_mm": ("bitset_mm_launch", [
        _C.c_void_p, _C.c_int64, _C.c_int32, _C.c_void_p, _C.c_int64, _C.c_int32,
        _C.c_void_p, _C.c_void_p,
    ], _C.c_int),
    "ell_spmm": ("ell_spmm_launch", [
        _C.c_void_p, _C.c_void_p, _C.c_int64, _C.c_int32, _C.c_void_p, _C.c_int64,
        _C.c_int32, _C.c_void_p, _C.c_void_p, _C.c_void_p,
    ], _C.c_int),
    "embedding_bag": ("embedding_bag_launch", [
        _C.c_void_p, _C.c_int64, _C.c_int32, _C.c_void_p, _C.c_int64, _C.c_int32,
        _C.c_void_p, _C.c_void_p, _C.c_void_p,
    ], _C.c_int),
    "flash_attention": ("flash_attention_launch", [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64,
        _C.c_int32, _C.c_int32, _C.c_int64, _C.c_float, _C.c_void_p,
    ], _C.c_int),
    "flash_attention_sm90": ("flash_attention_sm90_launch", [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64,
        _C.c_int32, _C.c_int32, _C.c_int64, _C.c_float, _C.c_void_p,
    ], _C.c_int),
}

_LOCK = threading.Lock()
# name -> (loaded library, its launch function); the library object is kept
# so the function pointer never outlives it
_LIBS: Dict[str, tuple] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(name: str) -> dict:
    """Compile kernel ``name`` unless a current build exists.

    Returns ``{"seconds", "cached", "log"}``; raises ``RuntimeError`` with
    the compiler's output when ``nvcc`` fails."""
    path = _lib_path(name)
    if path.exists():
        return {"seconds": 0.0, "cached": True, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{proc.returncode}\n{log}")
    os.replace(tmp, path)   # atomic: a reader never sees half a library
    return {"seconds": time.perf_counter() - t0, "cached": False, "log": log}


def library(name: str):
    """The loaded launch function of kernel ``name`` (building it if needed)."""
    loaded = _LIBS.get(name)
    if loaded is None:
        with _LOCK:
            loaded = _LIBS.get(name)
            if loaded is None:
                build(name)
                symbol, argtypes, restype = SIGNATURES[name]
                lib = ctypes.CDLL(str(_lib_path(name)))
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = restype
                loaded = _LIBS[name] = (lib, fn)
    return loaded[1]
