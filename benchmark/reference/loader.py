"""The training loader's arithmetic in NumPy: what the batches of a B=1
training epoch hold, worked out from the dataset's files.

  * the epoch's order: a permutation of the list seeded by seed + epoch;
  * each item's random crop origin: uniform over the valid offsets of the
    depth-padded volume, drawn from a generator seeded by (seed, epoch,
    index);
  * per modality a z-score over the whole volume's nonzero voxels (the
    mean and the variance of those voxels in float64, the variance rounded
    once), applied to the crop in float32; zeros stay zero.  Where the
    dataset keeps a preprocessed-volume cache, the statistics are held in
    float32 and the scale 1 / (std + 1e-8) is worked out from them;
  * the label with BraTS 4 as 3, and the 8-valued edge map: per region the
    morphological gradient (6-connectivity dilation and not erosion, the
    outside counted as background), coded {1}=1 {2}=2 {4}=4 {1,2}=6
    {1,4}=7 {2,4}=8 {1,2,4}=5.
"""

from __future__ import annotations

import gzip
import math
import os
import struct
from fractions import Fraction
from typing import List, Tuple

import numpy as np

NIFTI_TYPES = {2: np.uint8, 4: np.int16, 16: np.float32}
_EDGE_CODE = {1: 1, 2: 2, 4: 4, 3: 6, 5: 7, 6: 8, 7: 5}


def read_nifti(path: str) -> np.ndarray:
    """The voxel array of a single-file little-endian NIfTI-1 (.nii.gz)."""
    with gzip.open(path, "rb") as f:
        raw = f.read()
    ndim, *dims = struct.unpack_from("<8h", raw, 40)
    code = struct.unpack_from("<h", raw, 70)[0]
    offset = int(struct.unpack_from("<f", raw, 108)[0])
    shape = tuple(dims[:ndim])
    data = np.frombuffer(raw, NIFTI_TYPES[code], math.prod(shape), offset)
    return data.reshape(shape, order="F")


def load_case(root: str, name: str, modalities) -> Tuple[List[np.ndarray],
                                                         np.ndarray]:
    """(float32 channels, uint8 raw label) of one case directory."""
    d = os.path.join(root, name)
    chans = [read_nifti(os.path.join(d, f"{name}_{m}.nii.gz")).astype(
        np.float32) for m in modalities]
    return chans, read_nifti(os.path.join(d, f"{name}_seg.nii.gz")).astype(
        np.uint8)


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    return np.random.default_rng(seed + epoch).permutation(n)


def zscore_stats(chan: np.ndarray) -> Tuple[float, float]:
    v = chan[chan != 0].astype(np.float64)
    if v.size == 0:
        return 0.0, 0.0
    mean = float(v.sum()) / v.size
    var = float(Fraction(float((v * v).sum()) / v.size) - Fraction(mean) ** 2)
    return mean, math.sqrt(max(var, 0.0))


def boundary(mask: np.ndarray) -> np.ndarray:
    """Dilation and not erosion with the 6-neighbourhood; outside is
    background."""
    p = np.pad(mask, 1)
    core = (slice(1, -1),) * 3
    dil, ero = mask.copy(), mask.copy()
    for axis in range(3):
        for shift in (-1, 1):
            sl = list(core)
            sl[axis] = slice(1 + shift, p.shape[axis] - 1 + shift)
            nb = p[tuple(sl)]
            dil |= nb
            ero &= nb
    return dil & ~ero


def edge_map(target: np.ndarray) -> np.ndarray:
    bits = np.zeros(target.shape, np.uint8)
    for label, bit in ((1, 1), (2, 2), (3, 4)):
        bits[boundary(target == label)] |= bit
    out = np.zeros(target.shape, np.uint8)
    for pattern, code in _EDGE_CODE.items():
        out[bits == pattern] = code
    return out


def train_item(chans, label, crop, pad_depth, seed, epoch, index,
               stats32: bool = False):
    """(x (crop..., M) float32, target uint8, edge uint8) of one item;
    ``stats32``: the statistics held in float32, as a cache keeps them."""
    rng = np.random.default_rng((seed, epoch, int(index)))
    padded = (chans[0].shape[0], chans[0].shape[1], pad_depth)
    o = tuple(int(rng.integers(0, p - c + 1)) for p, c in zip(padded, crop))
    d_hi = min(o[2] + crop[2], chans[0].shape[2])
    n = d_hi - o[2]
    win = (slice(o[0], o[0] + crop[0]), slice(o[1], o[1] + crop[1]),
           slice(o[2], d_hi))
    x = np.zeros(tuple(crop) + (len(chans),), np.float32)
    for m, c in enumerate(chans):
        mean, std = zscore_stats(c)
        if stats32:
            mean, std = np.float32(mean), np.float32(std)
        block = np.ascontiguousarray(c[win], np.float32)
        inv = np.float32(1.0 / (std + 1e-8))
        x[:, :, :n, m] = np.where(block != 0,
                                  (block - np.float32(mean)) * inv,
                                  np.float32(0))
    target = np.zeros(tuple(crop), np.uint8)
    target[:, :, :n] = label[win]
    target[target == 4] = 3
    return x, target, edge_map(target)
