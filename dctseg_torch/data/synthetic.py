"""Synthetic BraTS-like volumes for tests, benchmarks and dataset-free runs.

Generates nested ellipsoidal "tumors" (edema containing core containing
enhancing rim) over 4 correlated noise modalities, at the raw BraTS geometry
(240x240x155, labels {0,1,2,4}) or any requested size.  Can also materialize
a fake on-disk BraTS-layout dataset (NIfTI files + train.txt/valid.txt) to
exercise the real loading path end-to-end.

The port's copy of the JAX package's ``dctseg/data/synthetic.py``: from the
same seed it gives the same volumes, bit for bit.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np


# cache the default synthetic samples (~156MB each): with maxsize below the
# dataset size every epoch regenerates every volume
@functools.lru_cache(maxsize=16)
def make_volume_channels(seed: int,
                         shape: Tuple[int, int, int] = (240, 240, 155),
                         num_modalities: int = 4,
                         hardness: str = "simple"):
    """Returns (channels: tuple of M contiguous (H, W, D) float32 arrays,
    label (H, W, D) uint8 with raw BraTS values {0, 1, 2, 4}).  Results are
    cached; callers must not mutate the returned arrays.

    hardness='hard' generates multi-focal, lobed (non-ellipsoidal) lesions
    with off-center necrosis and weaker intensity contrast — closer to real
    glioma morphology than the nested ellipsoids of 'simple'."""
    img, label = _make_volume_impl(seed, shape, num_modalities, hardness)
    chans = tuple(np.ascontiguousarray(img[..., m])
                  for m in range(num_modalities))
    return chans, label


def make_volume(seed: int, shape: Tuple[int, int, int] = (240, 240, 155),
                num_modalities: int = 4, hardness: str = "simple"):
    """Returns (image (H, W, D, M) float32, label (H, W, D) uint8 with raw
    BraTS values {0, 1, 2, 4})."""
    chans, label = make_volume_channels(seed, shape, num_modalities,
                                        hardness)
    return np.stack(chans, axis=-1), label


def _make_volume_impl(seed, shape, num_modalities, hardness="simple"):
    rng = np.random.default_rng(seed)
    h, w, d = shape
    ii = np.arange(h, dtype=np.float32)[:, None, None]
    jj = np.arange(w, dtype=np.float32)[None, :, None]
    kk = np.arange(d, dtype=np.float32)[None, None, :]

    def edist(center, radii):
        return np.sqrt(((ii - center[0]) / radii[0]) ** 2
                       + ((jj - center[1]) / radii[1]) ** 2
                       + ((kk - center[2]) / radii[2]) ** 2)

    def lobed_dist(center, radii):
        """Ellipsoidal distance warped by low-frequency angular lobes, so
        isosurfaces are irregular (multi-lobed) rather than smooth."""
        dx = (ii - center[0]) / radii[0]
        dy = (jj - center[1]) / radii[1]
        dz = (kk - center[2]) / radii[2]
        r = np.sqrt(dx * dx + dy * dy + dz * dz) + 1e-6
        theta = np.arccos(np.clip(dz / r, -1, 1))
        phi = np.arctan2(dy, dx)
        warp = np.ones_like(r)
        for _ in range(3):
            lt, lp = rng.integers(1, 4), rng.integers(1, 4)
            amp = 0.10 + 0.15 * rng.random()
            ph = 2 * np.pi * rng.random()
            warp += amp * np.sin(lt * theta + ph) * np.cos(lp * phi)
        return r / np.maximum(warp, 0.4)

    label = np.zeros(shape, np.uint8)
    if hardness == "hard":
        # 1-3 foci; each a lobed lesion with its own nested sub-regions and
        # an off-center (realistically eccentric) necrotic core
        for _ in range(int(rng.integers(1, 4))):
            center = np.array([h, w, d]) * (0.30 + 0.40 * rng.random(3))
            radii = np.array([h, w, d]) * (0.05 + 0.09 * rng.random(3))
            dist = lobed_dist(center, radii)
            label[dist < 1.0] = 2               # edema
            label[dist < 0.55 + 0.2 * rng.random()] = 4  # enhancing
            core_c = center + radii * (0.3 * rng.random(3) - 0.15)
            core = lobed_dist(core_c, radii * (0.25 + 0.15 * rng.random()))
            label[(core < 1.0) & (label == 4)] = 1  # eccentric necrosis
    else:
        center = np.array([h, w, d]) * (0.35 + 0.3 * rng.random(3))
        radii = np.array([h, w, d]) * (0.08 + 0.10 * rng.random(3))
        dist = edist(center, radii)
        label[dist < 1.0] = 2                   # edema
        label[dist < 0.7] = 4                   # enhancing
        label[dist < 0.4] = 1                   # necrotic core

    # brain mask: big ellipsoid; outside is exactly zero (z-score over
    # nonzero voxels relies on this)
    bcenter = np.array([h, w, d]) * 0.5
    bradii = np.array([h, w, d]) * np.array([0.45, 0.45, 0.48])
    brain = edist(bcenter, bradii) < 1.0

    img = np.zeros(shape + (num_modalities,), np.float32)
    base = rng.normal(0.0, 1.0, shape).astype(np.float32)
    # 'hard': weaker lesion contrast + a smooth bias field (MRI-like
    # intensity inhomogeneity) so boundaries are not trivially separable
    contrast = 0.45 if hardness == "hard" else 1.0
    bias = 1.0
    if hardness == "hard":
        g = np.array([rng.normal(0, 0.1) for _ in range(3)], np.float32)
        bias = 1.0 + g[0] * (ii / h - 0.5) + g[1] * (jj / w - 0.5) \
            + g[2] * (kk / d - 0.5)
    for m in range(num_modalities):
        level = 400.0 + 200.0 * m
        tex = 0.5 * base + rng.normal(0, 0.5, shape).astype(np.float32)
        mod = level + 80.0 * tex
        mod += contrast * (30.0 * (m + 1)) * (label == 2)
        mod += contrast * (60.0 * (m + 1)) * (label == 4)
        mod -= contrast * (40.0 * (m + 1)) * (label == 1)
        img[..., m] = np.where(brain, mod * bias, 0.0)
    label = np.where(brain, label, 0).astype(np.uint8)
    return img, label


def write_fake_dataset(root: str, num_train: int = 2, num_valid: int = 1,
                       shape: Tuple[int, int, int] = (240, 240, 155),
                       modalities=("flair", "t1", "t1ce", "t2"),
                       seed: int = 0, affine: np.ndarray = None,
                       hardness: str = "simple") -> None:
    """Materialize a BraTS2018-layout dataset:
    root/<case>/<case>_<modality>.nii.gz + _seg.nii.gz, plus list files.

    Default affine matches the BraTS SRI24 atlas orientation (LPS-flipped
    RAS, 1mm isotropic) so affine propagation is exercised non-trivially."""
    from dctseg_torch.data import nifti

    if affine is None:
        affine = np.array([[-1., 0., 0., 0.], [0., -1., 0., 239.],
                           [0., 0., 1., 0.], [0., 0., 0., 1.]], np.float32)
    names = [f"SYN_{seed}_{i:03d}" for i in range(num_train + num_valid)]
    for i, name in enumerate(names):
        case_dir = os.path.join(root, name)
        os.makedirs(case_dir, exist_ok=True)
        chans, label = make_volume_channels(seed * 1000 + i, shape,
                                            len(modalities), hardness)
        for m, mod in enumerate(modalities):
            nifti.save(chans[m],
                       os.path.join(case_dir, f"{name}_{mod}.nii.gz"),
                       affine=affine)
        nifti.save(label, os.path.join(case_dir, f"{name}_seg.nii.gz"),
                   affine=affine)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names[:num_train]) + "\n")
    with open(os.path.join(root, "valid.txt"), "w") as f:
        f.write("\n".join(names[num_train:]) + "\n")
