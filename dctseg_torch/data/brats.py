"""BraTS dataset: 4-modality NIfTI loading, normalization, cropping, edge
maps (the JAX package's ``dctseg/data/brats.py``).

  * item layout (train):  x (128,128,128,4) z-scored,
                          target (128^3) uint8 {0,1,2,3} (raw BraTS 4 -> 3),
                          edge (128^3) codes {0,1,2,4..8},
                          missing_modal (4,) int8 presence mask
  * item layout (full):   x (240,240,160,4) zero-padded in depth,
                          target (240,240,155)
  * ``drop_modal`` randomly zeroes modalities.

Normalization: per-modality z-score over that modality's nonzero voxels;
background stays exactly zero.  When ``root`` is empty, volumes come from
the synthetic generator instead of disk, so every entry point runs
dataset-free.  ``x`` leaves the loader as a CPU torch tensor in
``DataConfig.transfer_dtype`` (bf16 by torch's round-to-nearest-even cast);
targets and edges stay numpy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from dctseg_torch.config import DataConfig
from dctseg_torch.data import nifti, synthetic
from dctseg_torch.data.edge import make_edge_map
from dctseg_torch.data.stats import (nonzero_stats, normalize_inplace,
                                     zscore_nonzero)

__all__ = ["Sample", "BraTSDataset", "zscore_nonzero", "BraDataSet128",
           "BraDataSet", "BraDataSet128Test"]


@dataclasses.dataclass
class Sample:
    x: torch.Tensor               # (D, H, W, M) in the transfer dtype
    target: Optional[np.ndarray]  # (D, H, W) uint8 in {0,1,2,3}
    edge: Optional[np.ndarray]    # (D, H, W) uint8 edge codes
    missing_modal: np.ndarray     # (M,) int8 presence mask
    name: str = ""
    path: str = ""
    affine: Optional[np.ndarray] = None  # 4x4 voxel->world of the source;
    # exported submissions carry it
    source_shape: Optional[tuple] = None  # raw (H, W, D) of the source
    crop_origin: Optional[tuple] = None   # crop offset in padded source
    # geometry; with source_shape it lets crop-strategy predictions be
    # re-embedded into source geometry for submission export


class BraTSDataset:
    """The reference's BraDataSet128 / BraDataSet / BraDataSet128Test.

    mode:
      'train' — random crop, with target+edge
      'valid' — deterministic center crop, with target+edge+path
      'full'  — full padded volume (for sliding-window tiling), target at
                native 155 depth
    """

    def __init__(self, list_file: str = "", root: str = "",
                 mode: str = "train", drop_modal: bool = False,
                 cfg: Optional[DataConfig] = None):
        self.cfg = cfg or DataConfig()
        self.root = root
        self.mode = mode
        self.drop_modal = drop_modal
        self.synthetic = not root
        if self.synthetic:
            n = self.cfg.synthetic_num_samples
            self.names = [f"SYN_{i:03d}" for i in range(n)]
        else:
            with open(list_file) as f:
                self.names = [ln.strip() for ln in f if ln.strip()]
        self._rng = np.random.default_rng(self.cfg.seed)

    def __len__(self) -> int:
        return len(self.names)

    # ---- raw IO ----

    def _load_raw(self, idx: int):
        """Returns (channels: list of (H, W, D) float32 arrays, label raw
        {0,1,2,4}, path, affine, stats: (M, 2) nonzero mean/std or None).
        Channels stay separate, so the crop path never materializes the
        full 4-modality volume."""
        if self.synthetic:
            seed = idx + (0 if self.mode == "train"
                          else self.cfg.synthetic_valid_seed_offset)
            chans, label = synthetic.make_volume_channels(
                seed, self.cfg.input_shape, len(self.cfg.modalities),
                hardness=self.cfg.synthetic_hardness)
            return list(chans), label, "", np.eye(4, dtype=np.float32), None
        if self.cfg.cache_dir:
            return self._load_cached(idx)
        chans, label, path, affine = self._load_nifti(idx)
        return chans, label, path, affine, None

    def _load_nifti(self, idx: int):
        name = self.names[idx]
        case_dir = os.path.join(self.root, name)
        chans, affine = [], None
        for mod in self.cfg.modalities:
            p = os.path.join(case_dir, f"{name}_{mod}.nii.gz")
            if not os.path.exists(p):
                p = p[:-3]  # allow uncompressed .nii
            img = nifti.load(p)
            if affine is None:
                affine = img.affine
            chans.append(np.asarray(img.data, np.float32))
        seg_p = os.path.join(case_dir, f"{name}_seg.nii.gz")
        if not os.path.exists(seg_p):
            seg_p = seg_p[:-3]
        label = (np.asarray(nifti.load(seg_p).data, np.uint8)
                 if os.path.exists(seg_p) else
                 np.zeros(chans[0].shape, np.uint8))
        return chans, label, case_dir + os.sep, affine

    # ---- preprocessed-volume cache ----

    def _cache_paths(self, name: str):
        d = self.cfg.cache_dir
        return (os.path.join(d, name + ".img.npy"),
                os.path.join(d, name + ".seg.npy"),
                os.path.join(d, name + ".meta.npz"))

    def _load_cached(self, idx: int):
        """Decode each case's NIfTI files once into mmap-able .npy plus the
        per-modality nonzero z-score statistics; later loads read the crop's
        pages only and skip the full-volume statistics scan."""
        name = self.names[idx]
        pimg, pseg, pmeta = self._cache_paths(name)
        path = os.path.join(self.root, name) + os.sep
        if all(os.path.exists(p) for p in (pimg, pseg, pmeta)):
            img = np.load(pimg, mmap_mode="r")
            label = np.load(pseg, mmap_mode="r")
            meta = np.load(pmeta)
            return ([img[m] for m in range(img.shape[0])], label, path,
                    meta["affine"].astype(np.float32),
                    meta["stats"].astype(np.float32))

        chans, label, path, affine = self._load_nifti(idx)
        stats = np.array([nonzero_stats(np.ascontiguousarray(c, np.float32))
                          for c in chans], np.float32)
        os.makedirs(self.cfg.cache_dir, exist_ok=True)
        # atomic publish: concurrent loader workers may race on one case
        tmp = f".{os.getpid()}.tmp"
        np.save(pimg + tmp, np.stack(chans).astype(np.float32))
        np.save(pseg + tmp, np.asarray(label, np.uint8))
        np.savez(pmeta + tmp, affine=affine, stats=stats)
        for p in (pimg, pseg):
            os.replace(p + tmp + ".npy", p)
        os.replace(pmeta + tmp + ".npz", pmeta)
        return chans, label, path, affine, stats

    # ---- assembly ----

    def _wire(self, x: np.ndarray) -> torch.Tensor:
        """The assembled volume as a CPU tensor in the transfer dtype; the
        bf16 cast rounds to nearest even and runs here, in the loader
        thread, overlapping device work."""
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        if self.cfg.transfer_dtype == "bfloat16":
            return t.to(torch.bfloat16)
        return t

    def _pad_depth(self, img):
        pad_d = self.cfg.pad_depth - img.shape[2]
        if pad_d > 0:
            img = np.pad(img, ((0, 0), (0, 0), (0, pad_d), (0, 0)))
        return img

    def _crop_origin(self, shape, rng: Optional[np.random.Generator]):
        ch, cw, cd = self.cfg.crop_size
        max_off = (shape[0] - ch, shape[1] - cw, shape[2] - cd)
        if rng is None:  # center crop
            return tuple(m // 2 for m in max_off)
        return tuple(int(rng.integers(0, m + 1)) for m in max_off)

    def _missing_modal(self, rng: Optional[np.random.Generator]) -> np.ndarray:
        m = len(self.cfg.modalities)
        present = np.ones((m,), np.int8)
        for i in self.cfg.missing_modalities:  # deterministic eval dropout
            present[i] = 0
        if self.drop_modal and rng is not None:
            # drop a random non-empty proper subset (keep >= 1 modality)
            n_drop = int(rng.integers(0, m))
            if n_drop:
                drop = rng.choice(m, size=n_drop, replace=False)
                present[drop] = 0
        return present

    def get(self, idx: int, rng: Optional[np.random.Generator] = None
            ) -> Sample:
        chans, label, path, affine, stats = self._load_raw(idx)
        present = self._missing_modal(rng)

        def chan_stats(m, c):
            return tuple(stats[m]) if stats is not None else nonzero_stats(c)

        if self.mode == "full":
            out_chans = []
            for m, c in enumerate(chans):
                c = np.array(c, np.float32, order="C")  # writable copy
                if present[m]:
                    normalize_inplace(c, *chan_stats(m, c))
                else:
                    c[:] = 0.0
                out_chans.append(c)
            img = self._pad_depth(np.stack(out_chans, axis=-1))
            target = np.where(label == 4, 3, label).astype(np.uint8)
            return Sample(x=self._wire(img), target=target, edge=None,
                          missing_modal=present, name=self.names[idx],
                          path=path, affine=affine,
                          source_shape=tuple(label.shape),
                          crop_origin=(0, 0, 0))

        # crop path: z-score statistics come from the FULL volume but
        # normalization is applied to the crop only
        ch, cw, cd = self.cfg.crop_size
        padded = (chans[0].shape[0], chans[0].shape[1], self.cfg.pad_depth)
        crop_rng = rng if self.mode == "train" else None
        o = self._crop_origin(padded, crop_rng)
        raw_d = chans[0].shape[2]
        d_hi = min(o[2] + cd, raw_d)          # crop may reach into padding
        d_len = d_hi - o[2]

        x = np.zeros((ch, cw, cd, len(chans)), np.float32)
        for m, c in enumerate(chans):
            if not present[m]:
                continue
            mean, std = chan_stats(m, c)
            block = np.ascontiguousarray(
                c[o[0]:o[0] + ch, o[1]:o[1] + cw, o[2]:d_hi], np.float32)
            normalize_inplace(block, mean, std)
            x[:, :, :d_len, m] = block

        target = np.zeros((ch, cw, cd), np.uint8)
        target[:, :, :d_len] = \
            label[o[0]:o[0] + ch, o[1]:o[1] + cw, o[2]:d_hi]
        target[target == 4] = 3

        if self.mode == "train" and rng is not None:
            if self.cfg.augment_flip:
                for ax in range(3):
                    if rng.random() < 0.5:
                        x = np.flip(x, axis=ax)
                        target = np.flip(target, axis=ax)
            a = self.cfg.augment_intensity
            if a > 0.0:
                scale = rng.uniform(1 - a, 1 + a, size=x.shape[-1])
                shift = rng.uniform(-a, a, size=x.shape[-1])
                nz = x != 0
                x = np.where(nz, x * scale.astype(np.float32)
                             + shift.astype(np.float32), 0.0)
            target = np.ascontiguousarray(target)

        edge = make_edge_map(target)
        return Sample(x=self._wire(x), target=target, edge=edge,
                      missing_modal=present, name=self.names[idx],
                      path=path, affine=affine,
                      source_shape=tuple(label.shape), crop_origin=o)

    def __getitem__(self, idx: int) -> Sample:
        rng = self._rng if self.mode == "train" else None
        return self.get(idx, rng)


# Aliases matching the reference loader names
def BraDataSet128(list_file, root, mode="train", drop_modal=False, cfg=None):
    return BraTSDataset(list_file, root, mode, drop_modal, cfg)


def BraDataSet(list_file, root, mode="full", drop_modal=False, cfg=None):
    return BraTSDataset(list_file, root, "full", drop_modal, cfg)


def BraDataSet128Test(list_file, root, mode="full", drop_modal=False,
                      cfg=None):
    return BraTSDataset(list_file, root, "full", drop_modal, cfg)
