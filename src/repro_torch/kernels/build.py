"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C launch function and is compiled on
first use into ``_build/<name>-<hash>.so`` beside this module (the directory
is git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

(``-Xptxas -v`` puts each kernel's registers and spills into the log that
``build`` returns.)  A source named in ``PARTS`` compiles as that many
translation units at once (``-c -DK4_PARTS=n -DK4_PART=i``), linked into
the one library: ``flash_attention.cu``'s 17 tiled instantiations took
about 50 s in one nvcc.

The hash covers the source, every ``csrc/*.cuh`` header and the flags, so
an edited kernel or header rebuilds and an unchanged one loads from the
previous build (an edited header rebuilds also the kernels that do not
include it).  Nothing here runs at
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
    "serve_batch": ("serve_batch_launch", [
        _C.c_void_p, _C.c_void_p, _C.c_int64, _C.c_int32, _C.c_int32, _C.c_void_p,
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_int32,
        _C.c_void_p, _C.c_void_p, _C.c_int64, _C.c_void_p, _C.c_void_p, _C.c_void_p,
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
    "embedding_bag_bwd": ("embedding_bag_bwd_launch", [
        _C.c_void_p, _C.c_int64, _C.c_int32, _C.c_void_p, _C.c_int32, _C.c_void_p, _C.c_int64,
        _C.c_void_p,
    ], _C.c_int),
    "flash_attention_bwd": ("flash_attention_bwd_launch", [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64,
        _C.c_int32, _C.c_int32, _C.c_int64, _C.c_float, _C.c_void_p,
    ], _C.c_int),
    "flash_attention_bwd_sm90": ("flash_attention_bwd_sm90_launch", [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64,
        _C.c_int32, _C.c_int32, _C.c_int64, _C.c_float, _C.c_void_p,
    ], _C.c_int),
    "flash_attention": ("flash_attention_launch", [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64,
        _C.c_int64, _C.c_int32, _C.c_int32, _C.c_int64, _C.c_float, _C.c_void_p,
    ], _C.c_int),
    "flash_attention_sm90": ("flash_attention_sm90_launch", [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64, _C.c_int64,
        _C.c_int64, _C.c_int32, _C.c_int32, _C.c_int64, _C.c_float, _C.c_void_p,
    ], _C.c_int),
}

# name -> translation units its source compiles as, in parallel (see the source's header)
PARTS = {"flash_attention": 5}

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
    digest = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode() + str(PARTS.get(name, 1)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> dict:
    """Compile kernel ``name`` unless a current build exists.

    Returns ``{"seconds", "cached", "log"}``; raises ``RuntimeError`` with
    the compiler's output when ``nvcc`` fails."""
    path = _lib_path(name)
    if path.exists():
        return {"seconds": 0.0, "cached": True, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    src = str(CSRC / f"{name}.cu")
    t0 = time.perf_counter()
    n, objs = PARTS.get(name, 1), []
    if n == 1:
        steps = [[[_nvcc(), *NVCC_FLAGS, "-o", str(tmp), src]]]
    else:   # the parts at once, then one link
        objs = [path.with_suffix(f".{os.getpid()}.{i}.o") for i in range(n)]
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        steps = [[[_nvcc(), *flags, "-c", f"-DK4_PARTS={n}", f"-DK4_PART={i}", "-o", str(o),
                   src] for i, o in enumerate(objs)],
                 [[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]]]
    log, rc = "", 0
    for step in steps:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in step]
        for proc in procs:
            log += proc.communicate()[0]
            rc = rc or proc.returncode
        if rc:
            break
    for o in objs:
        o.unlink(missing_ok=True)
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited {rc}\n{log}")
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
