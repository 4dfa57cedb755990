"""Host z-score statistics of the loader, in numpy.

The JAX package computes these in C++ (``dctseg/native/edge_map.cc``,
built by g++ -O3 -march=native) when a compiler exists.  These functions
reproduce that arithmetic exactly, so the two loaders give the same bits:

  * the nonzero values are summed in float64 in memory order, one value at
    a time (a sequential cumulative sum; numpy's own sum is pairwise);
  * the variance sumsq/n - mean^2 is rounded ONCE: the native build fuses
    it into one multiply-subtract (``vfnmadd`` on an FMA host), so it is
    computed here exactly, as a fraction, and rounded to float64;
  * ``normalize_inplace`` rounds mean and 1/(std + 1e-8) to float32 and
    computes (x - mean) * inv in float32; ``zscore_nonzero`` computes it in
    float64 and rounds the result.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Tuple

import numpy as np


def _moments(values: np.ndarray) -> Tuple[float, float]:
    """(mean, std) of the nonzero entries of a flat float32 array, in its
    order."""
    v = values[values != 0].astype(np.float64)
    if v.size == 0:
        return 0.0, 0.0
    n = v.size
    mean = float(np.cumsum(v)[-1]) / n
    sumsq = float(np.cumsum(v * v)[-1])
    var = float(Fraction(sumsq / n) - Fraction(mean) ** 2)
    return mean, math.sqrt(max(var, 0.0))


def nonzero_stats(chan: np.ndarray) -> Tuple[float, float]:
    """(mean, std) over the nonzero elements of a contiguous float32 array
    (C or Fortran order: the sum runs in memory order)."""
    return _moments(np.ravel(np.asarray(chan, np.float32), order="K"))


def normalize_inplace(chan: np.ndarray, mean: float, std: float) -> None:
    """In-place nonzero z-score of a float32 array; zeros stay (+)0."""
    inv = np.float32(1.0 / (std + 1e-8))
    chan[...] = np.where(chan != 0, (chan - np.float32(mean)) * inv,
                         np.float32(0))


def zscore_nonzero(img: np.ndarray) -> np.ndarray:
    """Per-modality z-score over nonzero voxels of an (..., M) volume;
    zeros stay zero."""
    img = np.ascontiguousarray(img, np.float32)
    out = np.zeros_like(img)
    for m in range(img.shape[-1]):
        chan = img[..., m]
        mean, std = _moments(chan.reshape(-1))
        inv = 1.0 / (std + 1e-8)
        out[..., m] = np.where(chan != 0, (chan.astype(np.float64) - mean)
                               * inv, 0.0).astype(np.float32)
    return out
