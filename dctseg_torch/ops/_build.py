"""Build and load the port's CUDA kernels.

Every ``dctseg_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
an object file (one ``nvcc`` per source, all started together), and the
objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``.  The library lives under ``dctseg_torch/_build/``,
named by a hash of the sources and flags, so it is built once at first use
and rebuilt whenever a source changes.  Nothing here runs at import time:
the CPU-only test machines import the kernel modules without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
last_build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the port's CUDA "
        "kernels cannot be built")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if the library for these sources is missing;
    return its path."""
    global last_build_log
    sources = _sources()
    lib_path = BUILD_DIR / f"libdctseg_kernels_{_digest(sources)}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        last_build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{last_build_log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    return lib_path


_vp, _int, _long = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    # (x, out_ab, partial, counter, n, s, c, fine, splits, rows_per_split,
    #  eps, dtype, vec, stream)
    "dctseg_fusednorm_stats": [_vp, _vp, _vp, _vp, _int, _long, _int, _int,
                               _int, _long, ctypes.c_float, _int, _int, _vp],
    # (x, ab, residual, out, n, s, c, act, slope, dtype, vec, stream)
    "dctseg_fusednorm_apply": [_vp, _vp, _vp, _vp, _int, _long, _int, _int,
                               ctypes.c_float, _int, _int, _vp],
    # (q, k, v, out, bh, n, n2, d, scale, dtype, stream)
    "dctseg_attention_fwd": [_vp, _vp, _vp, _vp, _int, _int, _int, _int,
                             ctypes.c_float, _int, _vp],
}


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.dctseg_cuda_error_string.argtypes = [_int]
            handle.dctseg_cuda_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(dtype) -> int:
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"kernel does not take dtype {dtype}")
    return code


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream, where the C entries launch.
    That stream belongs to the current device, so ``t`` must lie there."""
    current = torch.cuda.current_device()
    if t.device.index != current:
        raise ValueError(f"tensor on {t.device}, but the current CUDA device "
                         f"is cuda:{current}; kernels launch on the current "
                         "device")
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if err:
        name = lib().dctseg_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name}) at launch")
