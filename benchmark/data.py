"""The benchmark's inputs: synthetic multi-modal brain MRI volumes.

Serving takes z-scored volumes as the evaluate driver hands them to the
engine: (240, 240, 160, 4) float32, the brain an ellipsoid of noisy tissue
with a brighter lesion, zero outside it and in the five slices of depth
padding.  Training reads a dataset root as BraTS ships it: per case four
int16 modalities and a uint8 segmentation {0, 1, 2, 4} at 240x240x155,
each a single-file gzipped NIfTI-1, and a ``train.txt`` list.

Volumes are made on the device from a seed in a few large calls.
"""

from __future__ import annotations

import gzip
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

MODALITIES = ("flair", "t1", "t1ce", "t2")


def _ellipsoid(shape, center, radii, device) -> torch.Tensor:
    """Squared normalised distance from ``center`` over a grid."""
    axes = [((torch.arange(n, device=device, dtype=torch.float32) - c) / r)
            .square() for n, c, r in zip(shape, center, radii)]
    return (axes[0][:, None, None] + axes[1][None, :, None]
            + axes[2][None, None, :])


def _case(g, shape, device):
    """(modalities (M, H, W, D) float32 with zero background, label
    (H, W, D) uint8 {0, 1, 2, 4}) of one synthetic case."""
    u = torch.rand(12, generator=g, device=device).tolist()
    dims = torch.tensor(shape, dtype=torch.float32)
    brain = _ellipsoid(shape, (dims * 0.5).tolist(),
                       (dims * torch.tensor([0.42, 0.45, 0.46])).tolist(),
                       device) < 1.0
    center = (dims * (0.35 + 0.3 * torch.tensor(u[:3]))).tolist()
    radii = (dims * (0.08 + 0.08 * torch.tensor(u[3:6]))).tolist()
    dist = _ellipsoid(shape, center, radii, device)
    label = torch.zeros(shape, dtype=torch.uint8, device=device)
    label[dist < 1.0] = 2
    label[dist < 0.55] = 4
    label[dist < 0.25] = 1
    label[~brain] = 0
    noise = torch.randn((len(MODALITIES),) + tuple(shape), generator=g,
                        device=device)
    level = torch.tensor([0.0, 1.0, 2.0, 3.0], device=device)[
        :, None, None, None]
    lesion = ((label == 2).float() + 2.0 * (label == 4).float()
              - (label == 1).float())
    img = 400.0 + 150.0 * level + 60.0 * noise + 40.0 * (level + 1) * lesion
    return torch.where(brain, img, 0.0), label


def serve_volumes(seed: int, count: int, shape, device) -> List[torch.Tensor]:
    """``count`` z-scored (1, H, W, D_padded, 4) float32 volumes in host
    memory, made from ``seed``; ``shape`` = (H, W, D, D_padded)."""
    g = torch.Generator(device=device).manual_seed(seed)
    h, w, d, dp = shape
    out = []
    for _ in range(count):
        img, _ = _case(g, (h, w, d), device)
        nz = img != 0
        n = nz.sum(dim=(1, 2, 3), keepdim=True)
        mean = img.sum(dim=(1, 2, 3), keepdim=True) / n
        var = ((img - mean).square() * nz).sum(dim=(1, 2, 3),
                                                keepdim=True) / n
        z = torch.where(nz, (img - mean) / var.sqrt(), 0.0)
        vol = torch.zeros((1, h, w, dp, z.shape[0]), device=device)
        vol[0, :, :, :d] = z.permute(1, 2, 3, 0)
        out.append(vol.cpu())
    return out


def write_nifti(path: str, data: np.ndarray) -> None:
    """A single-file little-endian NIfTI-1 (.nii.gz) of int16 or uint8
    voxels, 1 mm isotropic."""
    code = {np.dtype(np.int16): 4, np.dtype(np.uint8): 2}[data.dtype]
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, data.ndim, *data.shape,
                     *([1] * (7 - data.ndim)))
    struct.pack_into("<hh", hdr, 70, code, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *([1.0] * 8))
    struct.pack_into("<fff", hdr, 108, 352.0, 1.0, 0.0)
    struct.pack_into("<hh", hdr, 252, 1, 1)
    struct.pack_into("<12f", hdr, 280, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0)
    hdr[344:348] = b"n+1\x00"
    tmp = f"{path}.partial"
    with gzip.open(tmp, "wb", compresslevel=1) as f:
        f.write(bytes(hdr))
        f.write(np.asfortranarray(data).tobytes(order="F"))
    os.replace(tmp, path)


def case_names(cases: int) -> List[str]:
    return [f"BENCH_{i:03d}" for i in range(cases)]


def write_dataset(root: str, seed: int, cases: int, list_length: int,
                  shape, device) -> None:
    """``cases`` synthetic BraTS cases under ``root`` and a ``train.txt``
    of ``list_length`` entries that cycle over them.  A root whose list is
    already there is left as it is."""
    listing = os.path.join(root, "train.txt")
    if os.path.exists(listing):
        return
    g = torch.Generator(device=device).manual_seed(seed)
    names = case_names(cases)
    jobs = []
    with ThreadPoolExecutor(max_workers=4) as pool:
        for name in names:
            img, label = _case(g, tuple(shape), device)
            img = img.round().to(torch.int16).cpu().numpy()
            label = label.cpu().numpy()
            d = os.path.join(root, name)
            os.makedirs(d, exist_ok=True)
            for m, mod in enumerate(MODALITIES):
                jobs.append(pool.submit(
                    write_nifti, os.path.join(d, f"{name}_{mod}.nii.gz"),
                    img[m]))
            jobs.append(pool.submit(
                write_nifti, os.path.join(d, f"{name}_seg.nii.gz"), label))
        for j in jobs:
            j.result()
    with open(listing + ".partial", "w") as f:
        f.write("\n".join(names[i % cases] for i in range(list_length))
                + "\n")
    os.replace(listing + ".partial", listing)
