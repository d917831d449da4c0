"""The neighbour-search library of the DTU protocol (``neighbors.cpp``, a
copy of the JAX package's source): an exact KD-tree with OpenMP-parallel
1-NN queries and the insertion-ordered greedy radius filter.

Built on first use with ``g++ -O3 -march=native -fopenmp`` into
``.dbw_torch_build/`` at the repository root, named by a hash of the source
and flags, and bound with ctypes. Nothing falls back: no compiler or a
failed build raises with the compiler's output."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "neighbors.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".dbw_torch_build"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-fPIC", "-shared"]

_lock = threading.Lock()
_lib = None
_F32P = ctypes.POINTER(ctypes.c_float)


def build():
    """Compile the library (if not already built for this source and these
    flags) and return its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    so = BUILD_DIR / f"libneighbors_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the neighbour library cannot be "
                           "built") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC.name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # concurrent builders each land a whole file
    return so


def get_lib():
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.kdtree_build.restype = ctypes.c_void_p
            lib.kdtree_build.argtypes = [_F32P, ctypes.c_int64]
            lib.kdtree_free.argtypes = [ctypes.c_void_p]
            lib.kdtree_query1.argtypes = [
                ctypes.c_void_p, _F32P, ctypes.c_int64, _F32P,
                ctypes.POINTER(ctypes.c_int32)]
            lib.greedy_radius_mask.argtypes = [
                _F32P, ctypes.c_int64, ctypes.c_float, ctypes.POINTER(ctypes.c_uint8)]
            _lib = lib
    return _lib


def _fptr(arr):
    return arr.ctypes.data_as(_F32P)


class NativeKDTree:
    """Exact 1-NN index over (n, 3) float32 points."""

    def __init__(self, points):
        self._lib = get_lib()
        self._pts = np.ascontiguousarray(points, np.float32)
        self._handle = self._lib.kdtree_build(_fptr(self._pts), len(self._pts))

    def query(self, queries):
        """(dists (m,) float32, idx (m,) int32): the nearest Euclidean
        distance and index of each query."""
        q = np.ascontiguousarray(queries, np.float32)
        dist = np.empty(len(q), np.float32)
        idx = np.empty(len(q), np.int32)
        self._lib.kdtree_query1(self._handle, _fptr(q), len(q), _fptr(dist),
                                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return dist, idx

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.kdtree_free(handle)
            self._handle = None


def greedy_radius_mask(points, radius):
    """Insertion-ordered greedy radius filter: the keep mask (n,) bool."""
    pts = np.ascontiguousarray(points, np.float32)
    keep = np.empty(len(pts), np.uint8)
    get_lib().greedy_radius_mask(_fptr(pts), len(pts), ctypes.c_float(radius),
                                 keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep.astype(bool)
