"""ctypes binding for the C++ host runtime (native/sparkl_host.cpp).

Port of sparkl_tpu/native.py for the one function the slice needs: the
lattice sampler, so that scene positions come out bit-equal to the JAX
package's. The library builds lazily with g++ on first use into the same
path sparkl_tpu uses (native/libsparkl_host.so); without g++ and without a
built library, callers use the numpy form instead.
"""

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO, "native", "sparkl_host.cpp")
_SO = os.path.join(_REPO, "native", "libsparkl_host.so")

_lock = threading.Lock()
_lib = None


def _build():
    # Build beside the target and rename into place, so that concurrent
    # processes never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp,
             _SRC, "-pthread"],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded library, or None when there is neither a built library
    nor a g++ to build one."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        stale = (not os.path.exists(_SO)) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        )
        if stale:
            if shutil.which("g++") is None:
                return None
            _build()
        lib = ctypes.CDLL(_SO)
        lib.sparkl_cube_particles.restype = ctypes.c_int64
        lib.sparkl_cube_particles.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def cube_particles(origin, counts, radius, randomize=False, seed=0):
    """Native lattice sampler; returns float32 [n, dim] or None."""
    lib = get_lib()
    if lib is None:
        return None
    dim = len(counts)
    origin = np.asarray(origin, np.float64)
    counts = np.asarray(counts, np.int64)
    n = int(np.prod(counts))
    out = np.empty((n, dim), np.float32)
    lib.sparkl_cube_particles(
        _ptr(origin, ctypes.c_double), _ptr(counts, ctypes.c_int64),
        ctypes.c_int(dim), ctypes.c_double(radius), ctypes.c_int(int(randomize)),
        ctypes.c_uint64(seed), _ptr(out, ctypes.c_float),
    )
    return out
