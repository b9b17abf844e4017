"""ctypes binding of the native C++ BVH builder (port of
vimg_tpu.runtime.native).

``bvh_builder.cpp`` is this package's own copy of vimg_tpu's builder. It is
compiled with ``g++`` at first use into ``vimg_tpu_torch/_build/`` (never
next to the source), under a name that hashes the source and the flags.
There is no numpy fallback: a failed build raises, because the numpy
builder orders primitives differently and so gives other cluster tables.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "bvh_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# vimg_tpu's flags (so both builders compile the same code the same way),
# plus -pthread for the builder's std::thread on older C libraries
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread"]

_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libvimg_bvh_{h.hexdigest()[:16]}.so"


def _compile_lib() -> Path:
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native BVH builder is "
                           "compiled from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_compile_lib()))
            f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.vimg_build_bvh_mode.restype = ctypes.c_int32
            lib.vimg_build_bvh_mode.argtypes = [
                ctypes.c_int32, ctypes.c_int32, f32, f32, f32, f32, f32,
                i32, i32, i32, i32]
            _LIB = lib
    return _LIB


def build_bvh_native(bmin, bmax, centers, mode=0):
    """Same contract as geometry.bvh.build_bvh_numpy, in C++.
    mode: 0 = binned SAH, 1 = exact sweep SAH (reference -b flag)."""
    lib = get_lib()
    n = np.int32(bmin.shape[0])
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    centers = np.ascontiguousarray(centers, np.float32)
    cap = 2 * int(n)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    start = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    order = np.empty(int(n), np.int32)
    n_nodes = lib.vimg_build_bvh_mode(n, np.int32(mode), bmin, bmax, centers,
                                      node_min, node_max, start, count, skip,
                                      order)
    if n_nodes < 0:
        raise RuntimeError("native BVH build failed")
    return dict(node_min=node_min[:n_nodes], node_max=node_max[:n_nodes],
                node_start=start[:n_nodes], node_count=count[:n_nodes],
                node_skip=skip[:n_nodes], order=order)
