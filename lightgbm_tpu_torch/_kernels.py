"""Build, load and count the port's hand-written CUDA kernels.

Every kernel source in ``csrc/`` has a plain C interface. At first use (never
at import: a machine without ``nvcc`` must still import the package) each
source is compiled by ``nvcc`` for Hopper into a shared library named after a
hash of its source and flags, under ``.torch_kernels/`` beside the package
(listed in ``.gitignore``), and loaded with ``ctypes``. Pointers and the
stream travel as ``c_void_p``, ints as ``c_int`` / ``c_longlong``. Kernels
launch on PyTorch's current stream and allocate nothing; the Python wrappers
allocate outputs and scratch with ``torch.empty`` / ``torch.zeros``.

``LAUNCHES`` counts kernel launches by kernel name (:func:`launch` adds one
each time a wrapper launches its kernel) and ``PLAIN_CALLS`` counts calls of
the plain PyTorch versions, so a run can show which path it took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / ".torch_kernels"
CUDA_HOME_DEFAULT = Path("/usr/local/cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# kernel name -> (source file, {C function: argtypes})
KERNELS = {
    "histogram": ("histogram.cu", {
        "lgbt_hist_dense": [_P, _L, _P, _I, _I, _I, _I, _I, _P, _P],
        "lgbt_hist_records": [_P, _P, _L, _L, _P, _I, _I, _I, _I, _I, _P,
                              _P],
    }),
    "fused_split": ("fused_split.cu", {
        "lgbt_fused_split": [_I, _P, _P, _I, _L, _I, _P, _P, _I, _P, _I, _P,
                             _P],
    }),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
PLAIN_CALLS: Dict[str, int] = {name: 0 for name in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def nvcc() -> str:
    """Path of ``nvcc``; raises ``RuntimeError`` where there is none."""
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(Path(os.environ[env]) / "bin" / "nvcc")
    cands.append(CUDA_HOME_DEFAULT / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "the CUDA kernels of lightgbm_tpu_torch need nvcc (CUDA toolkit, "
        "sm_90a) to build, and none was found (CUDA_HOME, "
        "/usr/local/cuda/bin, PATH); CPU tensors use the plain PyTorch "
        "versions instead")


def _lib_path(name: str) -> Path:
    src = (CSRC / KERNELS[name][0]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. Returns build seconds per
    kernel (0.0 for a library already on disk)."""
    names = list(KERNELS if names is None else names)
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).is_file()}
    out = {n: 0.0 for n in names}
    if not todo:
        return out
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [exe, *NVCC_FLAGS, "-o", tmp, str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        _, err = proc.communicate()
        out[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{err}")
        else:
            os.replace(tmp, path)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in KERNELS[name][1].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def launch(name: str, fn: str, device, *args) -> None:
    """Call C entry ``fn`` of kernel library ``name`` with ``args`` and the
    current stream of ``device``, with ``device`` made current (the C side
    launches on the current device). Counts the launch and raises if the
    entry returns a CUDA error code."""
    import torch
    lib = library(name)
    LAUNCHES[name] += 1
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args,
                               torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError_t {err}")
