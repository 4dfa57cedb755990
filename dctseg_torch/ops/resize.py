"""Trilinear upsampling matching ``F.interpolate(mode='trilinear',
align_corners=False)``, as three separable interpolation matmuls in f32
(the JAX package's ``dctseg/ops/resize.py``)."""

from __future__ import annotations

import functools

import numpy as np
import torch


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


def trilinear_upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Upsample an NDHWC tensor spatially by an integer factor."""
    _, d, h, w, _ = x.shape
    dtype = x.dtype
    x = x.float()

    def mat(n):
        return torch.from_numpy(_interp_matrix(n, scale)).to(x.device)

    x = torch.einsum("od,bdhwc->bohwc", mat(d), x)
    x = torch.einsum("oh,bdhwc->bdowc", mat(h), x)
    x = torch.einsum("ow,bdhwc->bdhoc", mat(w), x)
    return x.to(dtype)
