"""Native (C++) runtime components, bound with ctypes.

The reference's runtime is native (Fortran + OpenMP); these are the
equivalent native pieces of this framework's host runtime.  Currently:

- ``cloud_generator.cc`` — the bit-exact McICA stochastic cloud
  generator (the serial host-side hot spot of the CLI driver),
  OpenMP-parallel over columns like driver/ecrad_driver.F90:339-384.

The shared library is built from source on first use with g++ into
``build/`` beside the sources (not committed); ``lib()`` returns None if
no compiler is available, and callers fall back to the NumPy
implementation.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "cloud_generator.cc")
_LIB = os.path.join(_DIR, "build", "libecrad_native.so")
_lib = None
_tried = False


def _build():
    """Compile to a private name, then rename into place, so processes
    building at once never load a half-written library."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-fopenmp", "-std=c++17",
           _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)


def lib():
    """The loaded shared library, building it if needed; None if
    unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build()
        _lib = ctypes.CDLL(_LIB)
        fn = _lib.ecrad_cloud_generator
        fn.restype = None
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_double,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_double,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
    except Exception:
        _lib = None
    return _lib


def cloud_generator_all_columns(ng, i_overlap_scheme, iseed,
                                frac_threshold, frac, overlap_param,
                                decorrelation_scaling, fractional_std,
                                pdf_sampler, use_beta_overlap=False):
    """Drop-in native replacement for
    solvers.cloud_generator_exact.cloud_generator_all_columns; returns
    None if the native library is unavailable."""
    L = lib()
    if L is None:
        return None
    frac = np.ascontiguousarray(frac, np.float64)
    ncol, nlev = frac.shape
    overlap_param = np.ascontiguousarray(overlap_param, np.float64)
    fractional_std = np.ascontiguousarray(fractional_std, np.float64)
    iseed = np.ascontiguousarray(iseed, np.int64)
    pdf_val = np.ascontiguousarray(pdf_sampler.val, np.float64)
    od_scaling = np.zeros((ncol, nlev, ng), np.float64)
    cover = np.zeros(ncol, np.float64)
    L.ecrad_cloud_generator(
        ncol, nlev, int(ng), int(i_overlap_scheme), iseed,
        float(frac_threshold), frac, overlap_param,
        float(decorrelation_scaling), fractional_std, pdf_val,
        int(pdf_sampler.ncdf), int(pdf_sampler.nfsd),
        float(pdf_sampler.fsd1), float(pdf_sampler.inv_fsd_interval),
        int(bool(use_beta_overlap)), od_scaling, cover)
    return od_scaling, cover
