"""Trilinear upsampling matching ``F.interpolate(mode='trilinear',
align_corners=False)``, as three separable interpolation matmuls in f32
(the JAX package's ``dctseg/ops/resize.py``)."""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake


@functools.lru_cache(maxsize=32)
def _interp_matrix(n_in: int, scale: int) -> np.ndarray:
    """(n_out, n_in) linear-interpolation matrix, half-pixel centers."""
    n_out = n_in * scale
    w = np.zeros((n_out, n_in), dtype=np.float32)
    for i in range(n_out):
        src = (i + 0.5) / scale - 0.5
        lo = int(np.floor(src))
        frac = src - lo
        lo_c = min(max(lo, 0), n_in - 1)
        hi_c = min(max(lo + 1, 0), n_in - 1)
        w[i, lo_c] += 1.0 - frac
        w[i, hi_c] += frac
    return w


_DEVICE_MATRICES: dict = {}


def _device_matrix(n_in: int, scale: int, device: torch.device
                   ) -> torch.Tensor:
    """:func:`_interp_matrix` on ``device``, copied there once: a forward
    captured in a CUDA graph may not copy from pageable host memory."""
    key = (n_in, scale, device)
    found = _DEVICE_MATRICES.get(key)
    if found is None:
        # a normal tensor even when the first call runs under
        # inference_mode, so that training can use the cached matrix
        with torch.inference_mode(False):
            found = torch.from_numpy(_interp_matrix(n_in, scale)).to(device)
        # under torch.export the matrix is fake: it becomes a constant of
        # the exported program and must not serve later eager calls
        if not is_fake(found):
            _DEVICE_MATRICES[key] = found
    return found


def trilinear_upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Upsample an NDHWC tensor spatially by an integer factor."""
    _, d, h, w, _ = x.shape
    dtype = x.dtype
    x = x.float()

    def mat(n):
        return _device_matrix(n, scale, x.device)

    x = torch.einsum("od,bdhwc->bohwc", mat(d), x)
    x = torch.einsum("oh,bdhwc->bdowc", mat(h), x)
    x = torch.einsum("ow,bdhwc->bdhoc", mat(w), x)
    return x.to(dtype)
