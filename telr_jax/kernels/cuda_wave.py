"""The CUDA wavefront kernels (native/wave_cuda.cu) as JAX operations.

The library is built with nvcc for sm_90a into native/build/ on first
use (or beforehand with `make -C native cuda`), loaded with ctypes and its
two FFI handlers registered for the CUDA platform.  A build or load
failure is an error: a GPU run never falls back to the XLA form quietly.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from typing import Optional

import jax
import numpy as np

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_SRC = os.path.join(_NATIVE, "wave_cuda.cu")
_LIB_PATH = os.path.join(_NATIVE, "build", "libtelr_wave_cuda.so")

_LIB: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # set when this process built it


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA wavefront kernels need the "
                       "CUDA toolkit to build (make -C native cuda)")


def build() -> None:
    """Compile the library with the repository's make target."""
    global build_seconds
    t0 = time.perf_counter()
    cmd = ["make", "-C", _NATIVE, "cuda", f"NVCC={_nvcc()}",
           f"FFI_INCLUDE={jax.ffi.include_dir()}"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError("building the CUDA wavefront kernels failed:\n"
                           + proc.stdout[-4000:] + proc.stderr[-4000:])
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """Build (when missing or older than its source), load and register
    the library; idempotent."""
    global _LIB
    if _LIB is not None:
        return _LIB
    stale = (not os.path.isfile(_LIB_PATH)
             or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC))
    if stale:
        build()
    lib = ctypes.CDLL(_LIB_PATH)
    for name, symbol in (("telr_wave_dp", lib.TelrWaveDp),
                         ("telr_wave_walk", lib.TelrWaveWalk)):
        jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(symbol),
                                    platform="CUDA")
    _LIB = lib
    return lib


def dp_call_spec(meta, qw, tw, scal, *, width, mode, params_tuple):
    """(operands, result shapes, attributes) of one telr_wave_dp call —
    the same operands the XLA form takes, checked here so that a bad
    shape fails in Python and not inside the kernel."""
    n, s_pad = meta.shape
    if qw.shape != (n, width) or tw.shape != (n, width) \
            or scal.shape != (n, 4):
        raise ValueError(f"wave batch shapes disagree: meta {meta.shape}, "
                         f"qw {qw.shape}, tw {tw.shape}, scal {scal.shape}")
    if width % 128 or width > 4096:
        raise ValueError(f"CUDA wavefront band width {width} must be a "
                         "multiple of 128, at most 4096")
    if s_pad % 8:
        raise ValueError(f"step count {s_pad} must be a multiple of 8")
    ma, mi, go, ge, amb = params_tuple
    results = (jax.ShapeDtypeStruct((n, s_pad, width), np.int8),
               jax.ShapeDtypeStruct((n, 4), np.int32))
    attrs = dict(mode=np.int32(mode), ma=np.int32(ma), mi=np.int32(mi),
                 go=np.int32(go), ge=np.int32(ge), amb=np.int32(amb))
    operands = tuple(jax.numpy.asarray(a, dtype=dt) for a, dt in (
        (meta, np.int8), (qw, np.int8), (tw, np.int8), (scal, np.int32)))
    return operands, results, attrs


def cuda_dp(meta, qw, tw, scal, *, width, mode, params_tuple):
    """The wavefront DP on the GPU: (res (n, 4) int32, dirs (n, S, W))."""
    load()
    operands, results, attrs = dp_call_spec(
        meta, qw, tw, scal, width=width, mode=mode,
        params_tuple=params_tuple)
    dirs, res = jax.ffi.ffi_call("telr_wave_dp", results)(*operands, **attrs)
    return res, dirs


def cuda_walk(dirs, meta, scal, res, *, mode):
    """One thread per pair walks its direction bytes: (packed, small)."""
    load()
    n, s_pad, _w = dirs.shape
    results = (jax.ShapeDtypeStruct((n, s_pad // 4), np.uint8),
               jax.ShapeDtypeStruct((7, n), np.int32))
    return jax.ffi.ffi_call("telr_wave_walk", results)(
        dirs, meta, scal, res, mode=np.int32(mode))
