"""Build, load and count the hand-written CUDA kernels in ``csrc/``.

The sources are compiled on first use with ``nvcc``, one process per source
started together, and linked into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), placed in
``.dbw_torch_build/`` at the repository root and keyed by a hash of the
sources and flags. The library is loaded with ``ctypes``; each wrapper
passes ``data_ptr()``s and the current PyTorch stream.

Nothing here falls back: no ``nvcc``, a failed build or a failed launch
raises. ``LAUNCHES`` counts the kernel launches made by the wrappers
(one per launch), so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / ".dbw_torch_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
]

LAUNCHES = {"K1_select": 0, "K1_select_hard": 0, "K1_select_hard_ss": 0,
            "K2_frag_fwd": 0, "K3_frag_bwd": 0, "K4_texel_grad": 0,
            "K5_small_scatter": 0, "K6_blend_fwd": 0, "K6_blend_bwd": 0,
            "K7_lpips_fwd": 0, "K7_lpips_bwd": 0, "K8_quad_fwd": 0}
# a launcher's return code for an empty input (no kernel launched)
NOTHING_LAUNCHED = -1

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "dbw_select": [_P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I,
                   _P, _P],
    "dbw_frag_fwd": [_P, _P, _P, _P, _P, _I, _F, _I, _I, _I, _I, _I,
                     _P, _P, _P, _P, _P],
    "dbw_frag_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P, _P],
    "dbw_texel_grad": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "dbw_quad_sample_fwd": [_P, _P, _P, _P, _L, _L, _I, _P, _P],
    "dbw_small_scatter": [_P, _P, _I, _I, _I, _I, _P, _I, _P],
    "dbw_blend_fwd": [_P, _P, _I, _I, _F, _F, _F, _P, _P],
    "dbw_blend_bwd": [_P, _P, _P, _I, _I, _F, _F, _F, _P, _P, _P],
    "dbw_lpips_chunks": [_I, _I, _L],
    "dbw_lpips_fwd": [_P, _P, _P, _I, _I, _I, _L, _I, _F, _P, _P, _P],
    "dbw_lpips_bwd": [_P, _P, _P, _P, _I, _I, _I, _L, _I, _F, _I, _P, _P],
}

_LIB = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(verbose=False):
    """Compile csrc/*.cu into the build directory (if not already built for
    these sources) and return the library path."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib = BUILD_DIR / f"libdbw_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in sources]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
         "-o", str(o), str(p)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p, o in zip(sources, objs)]
    outs = [proc.communicate() for proc in procs]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        for p, proc, (out, err) in zip(sources, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {p.name} ({proc.returncode}):\n{out}\n{err}")
            if verbose:
                print(err.strip())
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, lib)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return lib


def library():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def launch(name, counter, *args):
    """Call launcher ``name`` on the current stream; raise on a launch error
    and count the launch. A launcher returns NOTHING_LAUNCHED for an empty
    input, which launches nothing and is not counted."""
    fn = getattr(library(), name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err == NOTHING_LAUNCHED:
        return
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[counter] += 1


def check(t, dtype, name, align=4):
    """Wrapper-side argument check: a contiguous CUDA tensor of ``dtype``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data is not {align}-byte aligned")
    return t.data_ptr()
