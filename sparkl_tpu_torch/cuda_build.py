"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc and ctypes.

Each .cu source compiles to an object file, all at once in parallel nvcc
processes, and the objects link into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), keyed by a hash of
the sources and flags, under build/sparkl_tpu_torch/ at the repository root.
The first call in a process builds if needed and loads; later calls return
the loaded library. Only the machine with the card has nvcc: elsewhere
`library()` raises.

The kernel wrappers call in through `launch`, after `check_tensor` on each
argument; `route` sends CPU tensors to the plain versions and CUDA tensors
to the kernels, and refuses any other device. Many kernels take a few
microseconds on the card, about what the host takes to enqueue one, so the
launch path is kept near one torch op's host time: each C launcher is bound
once, as a ctypes prototype, when the library loads (`launch` is then a dict
lookup and the call), `stream_ptr` and `raw_stream` read the raw current
stream without building a torch.cuda.Stream, and `check_tensor` tests the
common case in one expression before it works out which message to raise.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "sparkl_tpu_torch")
SOURCES = ("fused_kernels.cu", "particle_physics.cuh", "scatter_walk.cuh", "window_kernels.cu",
           "probe_kernels.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -fmad=false keeps the kernels' rounding that of the plain versions (no
# contraction of a*b+c); never --use_fast_math (expf/logf/sinf, sqrtf).
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
# The library's C launchers by name, resolved once when it loads.
_fns = {}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # slots, ints, nchunks, tab_f, tab_i, m_count, out, max_chunks, dt, ox, oy,
    # oz, h, invd, d_coeff, rx, ry, rz, dim, opts, stream
    "sparkl_p2g_fused": [_VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _F, _F, _F, _F, _F,
                         _F, _F, _I, _I, _I, _I, _I, _VP],
    # rows, first, nchunks, out, max_blocks, width, kmax, stream
    "sparkl_merge_blocks": [_VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    # rows, order, starts, out, n_rows, width, stream
    "sparkl_merge_scatter": [_VP, _VP, _VP, _VP, _I, _I, _VP],
    # slots, ints, nchunks, out, max_chunks, ox, oy, oz, h, invd, d_coeff, rx,
    # ry, rz, dim, stream
    "sparkl_mass_p2g_fused": [_VP, _VP, _VP, _VP, _I, _F, _F, _F, _F, _F, _F,
                              _I, _I, _I, _I, _VP],
    # slots, ints, windows, nchunks, out, max_chunks, ox, oy, oz, h, invd,
    # d_coeff, rx, ry, rz, dim, stream
    "sparkl_mass_g2p_fused": [_VP, _VP, _VP, _VP, _VP, _I, _F, _F, _F, _F, _F,
                              _F, _I, _I, _I, _I, _VP],
    # slots, ints, fields, corners, nchunks, tab_f, tab_i, m_count, max_chunks,
    # dt, ox, oy, oz, h, invd, d_coeff, rx, ry, rz, dim, n_win, opts, stream
    "sparkl_g2p_fused": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _F, _F, _F, _F,
                         _F, _F, _F, _I, _I, _I, _I, _I, _I, _VP],
    # order2, shifts, out, max_chunks, c, stream
    "sparkl_src_rows_from_order": [_VP, _VP, _VP, _I, _I, _VP],
    # slots, ints, src, origin, out_f, out_i, max_chunks, dim, r_cumd, stream
    "sparkl_permute_slots": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    # gathered, gathered_i, target, out_f, out_i, max_chunks, k_src, nf, ni, c,
    # stream
    "sparkl_permute_chunks": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
    # e, cand, boxes, out, max_chunks, kn, r2, dim, work, stream
    "sparkl_eigen_pool": [_VP, _VP, _VP, _VP, _I, _I, _F, _I, _VP, _VP],
    # e, boxes, max_chunks, dim, stream
    "sparkl_eigen_boxes": [_VP, _VP, _I, _I, _VP],
    # slot_data, out, max_chunks, dim, with_psi, ox, oy, oz, h, invd, stream
    "sparkl_p2g_windows": [_VP, _VP, _I, _I, _I, _F, _F, _F, _F, _F, _VP],
    # slot_data, windows, out, max_chunks, dim, with_psi, ox, oy, oz, h, invd,
    # stream
    "sparkl_g2p_windows": [_VP, _VP, _VP, _I, _I, _I, _F, _F, _F, _F, _F, _VP],
    # x, out, rows, r, n_ops, transcend, stream
    "sparkl_vreg_chain": [_VP, _VP, _I, _I, _I, _I, _VP],
    # x, out, d_count, nf, field_major, stream
    "sparkl_layout_read": [_VP, _VP, _I, _I, _I, _VP],
    "sparkl_layout_rw": [_VP, _VP, _I, _I, _I, _VP],
}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path():
    return os.path.join(BUILD_DIR, f"libsparkl_{_digest()}.so")


def build():
    """Compile the library if it is not built yet; returns (path, compiler
    log). The log holds ptxas's registers / shared memory per kernel."""
    path = library_path()
    log_path = path + ".log"
    if os.path.exists(path):
        with open(log_path) as f:
            return path, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = [name for name in SOURCES if name.endswith(".cu")]
        objs = [os.path.join(tmp, name + ".o") for name in units]
        procs = [
            subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, os.path.join(_CSRC, name)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(units, objs)
        ]
        log = ""
        failed = []
        try:
            for name, proc in zip(units, procs):
                out, _ = proc.communicate(timeout=600)
                log += f"== {name}\n{out}"
                if proc.returncode != 0:
                    failed.append(f"{name} ({proc.returncode})")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
        lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", lib, *objs],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(lib, path)
    return path, log


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                # A prototype binds faster per call than a function with
                # argtypes set (~0.1 µs an argument on the host).
                _fns[name] = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)((name, lib))
            _lib = lib
        return _lib


def check_tensor(name, t, dtype, shape, device):
    """Raise unless `t` is a contiguous tensor of this dtype, shape and device."""
    if (isinstance(t, torch.Tensor) and t.dtype == dtype and t.shape == shape
            and t.device == device and t.is_contiguous()):
        return
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def route(device):
    """'cpu' (plain version) or 'cuda' (kernel); anything else raises."""
    if device.type in ("cpu", "cuda"):
        return device.type
    raise NotImplementedError(f"no kernel route for device {device}")


def raw_stream(index):
    """The raw handle of the current CUDA stream on device `index` (a CUDA
    graph's capture stream while one is captured)."""
    return torch._C._cuda_getCurrentRawStream(index)


def stream_ptr(device):
    """raw_stream of a torch.device."""
    return raw_stream(device.index)


def launch(name, *args):
    """Call the library's C launcher `name` (building and loading the
    library on first use); raise if the launch was refused."""
    fn = _fns.get(name)
    if fn is None:
        library()
        fn = _fns[name]
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
