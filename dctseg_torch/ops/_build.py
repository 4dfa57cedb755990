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

import contextlib
import ctypes
import hashlib
import importlib
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
    # (int64 args: x, residual, out, ab, partial, tickets, generations, n,
    #  s, c, f, blocks, rows_per_block, act, dtype, vec, fused, staged,
    #  amax; eps, slope, stream)
    "dctseg_fusednorm": [_vp, ctypes.c_float, ctypes.c_float, _vp],
    # (the int64 args of dctseg_fusednorm, then the sums; eps, slope,
    #  count, phase, stream)
    "dctseg_fusednorm_ext": [_vp, ctypes.c_float, ctypes.c_float,
                             ctypes.c_float, _int, _vp],
    # (dtype, vec, fused, residual, amax, &blocks, &stage_bytes)
    "dctseg_fusednorm_coresident": [_int, _int, _int, _int, _int,
                                    ctypes.POINTER(_int),
                                    ctypes.POINTER(_int)],
    # (int64 args: q, k, v, out, b, h, n, n2, d, 9 strides, dtype, kernel;
    #  scale, stream)
    "dctseg_attention_fwd": [_vp, ctypes.c_float, _vp],
    # (int64 args: q, k, v, out, table, ids, bw, h, n, d, nw, ws, 9 strides,
    #  2 table strides, dtype; scale, stream)
    "dctseg_window_attention_fwd": [_vp, ctypes.c_float, _vp],
    # (int64 args: x, windows, out, out2, weight, bias, rows, c, route, d, h,
    #  w, dp, hp, wp, wd, wh, ww, sd, sh, sw, dtype, vectors a lane, lanes;
    #  eps, stream)
    "dctseg_layer_norm": [_vp, ctypes.c_float, _vp],
    # (x, out, a, d, b, stream)
    "dctseg_minplus_pass": [_vp, _vp, _long, _int, _long, _vp],
    # (x, out, rows, d, stream)
    "dctseg_minplus_pass_minor": [_vp, _vp, _long, _int, _vp],
    # (int64 args: values, cuts, ranks, counts, tickets, bounds, out, c, m,
    #  t, k, pass, last, narrow; vmax, stream)
    "dctseg_orderstats": [_vp, ctypes.c_float, _vp],
    # (int64 args: x, out, n, d, h, w, c, in_dtype, out_dtype, vec, grid;
    #  stream)
    "dctseg_space_to_depth": [_vp, _vp],
    # (int64 args: xq, wq, stats, sw, bias, out, n, d, h, w, ci, od, oh, ow,
    #  co, k, sd, sh, sw, pd, ph, pw, out_dtype, vec; stream)
    "dctseg_int8_conv3d": [_vp, _vp],
    # (int64 args: x, q, stats, n, dtype, vec, grid, route, amax slots,
    #  slot count, workspace; stream)
    "dctseg_quantize": [_vp, _vp],
    # (dtype, vec, &blocks)
    "dctseg_quantize_coresident": [_int, _int, ctypes.POINTER(_int)],
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
    That stream belongs to the current device, so ``t`` must lie there.
    Read through torch's raw bindings: the public calls cost several
    microseconds of host time per launch."""
    index = t.get_device()
    current = torch._C._cuda_getDevice()
    if index != current:
        raise ValueError(f"tensor on {t.device}, but the current CUDA device "
                         f"is cuda:{current}; kernels launch on the current "
                         "device")
    return torch._C._cuda_getCurrentRawStream(index)


def alignment(*ptrs: int) -> int:
    """The largest of 32, 16, 8, 4, 2, 1 bytes that divides every address
    in ``ptrs``."""
    low = 0
    for p in ptrs:
        low |= p
    low &= 31
    return low & -low if low else 32


# Stores of kernel workspaces that a caller owns, innermost last
# (owned_workspaces)
_owners: list = []


@contextlib.contextmanager
def owned_workspaces(store: dict):
    """Inside, the kernels keep the workspaces they make or grow in
    ``store`` instead of their modules' shared caches, for as long as the
    caller keeps ``store``.  A CUDA graph captures the workspaces'
    addresses: the engine runs a graph's warm-up and capture inside a store
    of the graph's own, so that no other call reallocates or shares
    them."""
    _owners.append(store)
    try:
        yield store
    finally:
        _owners.pop()


def workspaces(cache: dict) -> dict:
    """Where a kernel module keeps its workspaces: ``cache`` (its own, by
    (device, stream)), or inside :func:`owned_workspaces` the owner's
    dict for that module."""
    return _owners[-1].setdefault(id(cache), {}) if _owners else cache


def refuse_in_capture(what: str) -> None:
    """Raise if the current stream is capturing a CUDA graph: ``what``
    (allocating or zeroing a workspace) belongs in the warm-up, and a
    capture would bake in an address that a later call could free."""
    if (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(f"{what} during CUDA graph capture: warm up on "
                           "the capture stream first")


# The kernel wrappers that count their launches on CUDA tensors in a
# ``.launches`` attribute, by module of ``dctseg_torch.ops``; two also count
# them by kernel or route in a dict (BY_KIND).  The modules import this one,
# so the functions are looked up when first read.
COUNTED = {
    "attention": ("fused_attention", "fused_window_attention"),
    "fusednorm": ("fused_instance_norm_act", "fused_instance_norm_act_amax",
                  "fused_norm_stats", "fused_norm_apply",
                  "fused_norm_stats_amax", "fused_norm_apply_amax"),
    "minplus": ("minplus_pass",),
    "orderstats": ("count_leq", "masked_order_stats"),
    "quant": ("quantize_absmax", "quantize_from_amax", "quantize_amax",
              "int8_conv3d"),
    "relayout": ("space_to_depth",),
    "layernorm": ("layer_norm_to_windows", "windows_residual_layer_norm",
                  "layer_norm"),
}
BY_KIND = ("kernel_launches", "routes")


def counted_ops() -> list:
    """The functions of :data:`COUNTED`."""
    return [getattr(importlib.import_module(f"dctseg_torch.ops.{module}"),
                    name)
            for module, names in COUNTED.items() for name in names]


def launch_counts() -> dict:
    """Every launch counter's value, keyed (function, attribute, kind):
    ``(fn, "launches", None)``, and per kernel or route
    ``(fn, "routes", route)``."""
    out = {}
    for fn in counted_ops():
        out[fn, "launches", None] = fn.launches
        for attr in BY_KIND:
            for kind, n in getattr(fn, attr, {}).items():
                out[fn, attr, kind] = n
    return out


def launches_since(before: dict) -> dict:
    """The counters that moved since ``before`` (a :func:`launch_counts`),
    by how much."""
    return {k: n - before[k] for k, n in launch_counts().items()
            if n != before[k]}


def add_launches(increase: dict, times: int = 1) -> None:
    """Add ``times`` x ``increase`` (a :func:`launches_since`) to the
    counters: a CUDA graph's replay runs the launches its capture counted."""
    for (fn, attr, kind), n in increase.items():
        if kind is None:
            setattr(fn, attr, getattr(fn, attr) + n * times)
        else:
            getattr(fn, attr)[kind] += n * times


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if err:
        name = lib().dctseg_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name}) at launch")
