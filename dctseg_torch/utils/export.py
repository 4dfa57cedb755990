"""Host-side exporters: per-slice and per-volume CSVs, PNG slices, NIfTI
submissions (the JAX package's ``dctseg/utils/export.py``).

Standard library only: the CSVs go through ``csv`` with the header and
values pandas writes, and the PNGs through ``zlib`` and ``struct``.
"""

from __future__ import annotations

import csv
import os
import struct
import zlib
from typing import Dict, List, Sequence

import numpy as np

from dctseg_torch import metrics
from dctseg_torch.data import nifti

# fixed RGB palette of the reference's renderer
PALETTE = {1: (250, 250, 149), 2: (244, 130, 128), 3: (97, 136, 200)}


def _cell(v) -> str:
    return "" if v is None else str(v)


def _append_csv(path: str, header: Sequence[str], rows: List[Dict]) -> None:
    """Append rows to a CSV, writing the header first if the file is new."""
    new = not os.path.exists(path)
    if new:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        if new:
            w.writerow(header)
        w.writerows([_cell(r.get(k)) for k in header] for r in rows)


def export_per_slice_csv(out_dir: str, name: str, output: np.ndarray,
                         label: np.ndarray, modal: str = "Our") -> None:
    """Per-slice WT/TC/ET dice, one CSV per sort key.  output/label:
    (H, W, D) int."""
    rows = []
    for frame in range(output.shape[2]):
        li = label[:, :, frame]
        if li.max() > 0:
            d = metrics.softmax_output_dice(output[:, :, frame], li)
            rows.append({"name": f"{name}_{frame}", "wt": d[0], "tc": d[1],
                         "et": d[2], "sum": d[0] * d[1] * d[2]})
    base = os.path.join(out_dir, name, "predict", name)
    os.makedirs(base, exist_ok=True)
    for key in ("wt", "tc", "et"):
        rows.sort(key=lambda r: r[key])
        _append_csv(os.path.join(base, f"{modal}_{name}_{key}.csv"),
                    ("name", "wt", "tc", "et", "sum"), rows)


def export_volume_summary_csv(path: str, rows: List[Dict]) -> None:
    """Per-volume summary: dice, their product, predicted and ground-truth
    voxel counts per raw label."""
    _append_csv(path, ("name", "wt", "tc", "et", "sum", "pre_1", "pre_2",
                       "pre_4", "gt_1", "gt_2", "gt_4"), rows)


def export_checkpoint_sweep_csv(path: str, name: str, wt: float, tc: float,
                                et: float) -> None:
    """Append one checkpoint's mean dice (the reference's checkpoint
    sweep)."""
    _append_csv(path, ("name", "wt", "tc", "et"),
                [{"name": name, "wt": wt, "tc": tc, "et": et}])


def render_label_slice(label2d: np.ndarray) -> np.ndarray:
    """(H, W) int labels -> (H, W, 3) uint8 with the reference palette."""
    img = np.zeros(label2d.shape + (3,), np.uint8)
    for cls, rgb in PALETTE.items():
        img[label2d == cls] = rgb
    return img


def write_png(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG (no filtering, zlib level 6)."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xffffffff))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb, np.uint8).reshape(h, -1)],
                          axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def export_png_slices(out_dir: str, name: str, output: np.ndarray,
                      label: np.ndarray, modal: str = "Our") -> None:
    """Per-slice PNGs for prediction and ground truth."""
    pred_dir = os.path.join(out_dir, name, "predict")
    lab_dir = os.path.join(out_dir, name, "label")
    os.makedirs(pred_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    for frame in range(output.shape[2]):
        write_png(os.path.join(pred_dir, f"{modal}_pre_{frame}.png"),
                  render_label_slice(output[:, :, frame]))
        write_png(os.path.join(lab_dir, f"{modal}_label_{frame}.png"),
                  render_label_slice(label[:, :, frame]))


def export_nifti_segmentation(path: str, output: np.ndarray,
                              affine: np.ndarray = None,
                              remap_3_to_4: bool = True) -> None:
    """BraTS submission export: labels {0,1,2,3} -> {0,1,2,4}."""
    seg = output.astype(np.uint8)
    if remap_3_to_4:
        seg = np.where(seg == 3, 4, seg).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    nifti.save(seg, path, affine=affine)
