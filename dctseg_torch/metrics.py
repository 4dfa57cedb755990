"""Evaluation metrics: Dice / mIoU composites and HD95, on the host (numpy
and scipy) and on the device (:class:`DeviceMetrics`).

Composites over BraTS regions (labels after the 4 -> 3 remap):
  WT (whole tumor)     = label > 0
  TC (tumor core)      = label in {1, 3}
  ET (enhancing tumor) = label == 3

HD95 follows medpy's ``hd95`` on scipy: surface extraction by binary
erosion, Euclidean distance transform, one 95th percentile of the pooled
symmetric surface distances; degenerate masks (empty or full, either side)
give 0, as the reference's ConfusionMatrix guard does.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from scipy import ndimage as _ndi

from dctseg_torch.device import resolve_device
from dctseg_torch.ops import edt


def dice_score(o, t, eps: float = 1e-8) -> float:
    """2|o*t| / (|o|+|t|+eps) on boolean arrays."""
    o = np.asarray(o)
    t = np.asarray(t)
    num = 2.0 * (o * t).sum() + eps
    den = o.sum() + t.sum() + eps
    return float(num / den)


def miou_score(o, t, eps: float = 1e-8) -> float:
    """|o&t| / |o|t|."""
    o = np.asarray(o).astype(bool)
    t = np.asarray(t).astype(bool)
    num = (o & t).sum() + eps
    den = (o | t).sum() + eps
    return float(num / den)


def _composites(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return x > 0, (x == 1) | (x == 3), x == 3


def softmax_output_dice(output: np.ndarray, target: np.ndarray) -> List[float]:
    """[WT, TC, ET] dice."""
    return [dice_score(o, t)
            for o, t in zip(_composites(output), _composites(target))]


def softmax_output_miou(output: np.ndarray, target: np.ndarray) -> List[float]:
    """[WT, TC, ET] mIoU."""
    return [miou_score(o, t)
            for o, t in zip(_composites(output), _composites(target))]


def softmax_miou_score(output: np.ndarray, target: np.ndarray) -> List[float]:
    """Per-label (1, 2, 3) mIoU."""
    return [miou_score(output == c, target == c) for c in (1, 2, 3)]


def _surface(mask: np.ndarray, connectivity: int = 1) -> np.ndarray:
    footprint = _ndi.generate_binary_structure(mask.ndim, connectivity)
    eroded = _ndi.binary_erosion(mask, structure=footprint, iterations=1)
    return mask & ~eroded


def _surface_distances(test: np.ndarray, reference: np.ndarray,
                       voxel_spacing=None, connectivity: int = 1) -> np.ndarray:
    """Distances from each surface voxel of ``test`` to the nearest surface
    voxel of ``reference`` (medpy's __surface_distances)."""
    test_border = _surface(test, connectivity)
    ref_border = _surface(reference, connectivity)
    dt = _ndi.distance_transform_edt(~ref_border, sampling=voxel_spacing)
    return dt[test_border]


def _degenerate(test: np.ndarray, reference: np.ndarray) -> bool:
    return (not test.any() or test.all()
            or not reference.any() or reference.all())


def hausdorff_distance_95(test, reference, voxel_spacing=None,
                          connectivity: int = 1,
                          nan_for_nonexisting: bool = False) -> float:
    """Symmetric 95th-percentile Hausdorff distance, medpy-exact: both
    directed surface-distance sets are pooled and one 95th percentile is
    taken.  Degenerate inputs (either mask empty or full) give 0 (or NaN
    when asked)."""
    test = np.asarray(test).astype(bool)
    reference = np.asarray(reference).astype(bool)
    if _degenerate(test, reference):
        return float("nan") if nan_for_nonexisting else 0.0
    d1 = _surface_distances(test, reference, voxel_spacing, connectivity)
    d2 = _surface_distances(reference, test, voxel_spacing, connectivity)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def hausdorff_distance(test, reference, voxel_spacing=None,
                       connectivity: int = 1,
                       nan_for_nonexisting: bool = False) -> float:
    """Max symmetric surface distance."""
    test = np.asarray(test).astype(bool)
    reference = np.asarray(reference).astype(bool)
    if _degenerate(test, reference):
        return float("nan") if nan_for_nonexisting else 0.0
    d1 = _surface_distances(test, reference, voxel_spacing, connectivity)
    d2 = _surface_distances(reference, test, voxel_spacing, connectivity)
    return float(max(d1.max(), d2.max()))


def cal_hausdorff(output: np.ndarray, target: np.ndarray,
                  batched_call_shape: bool = True) -> List[float]:
    """[WT, TC, ET] HD95.

    ``batched_call_shape`` reproduces how the reference calls medpy: with
    the masks' leading batch-1 axis, where the 4-D cross-footprint erosion
    erodes everything along the size-1 axis, so the "surfaces" are the full
    masks and HD95 is the pooled 95th percentile of all-voxel distances.
    The reference's headline numbers include this quirk, so it is the
    default; False gives the corrected 3-D surface-distance metric."""
    if batched_call_shape:
        output, target = np.asarray(output), np.asarray(target)
        if output.ndim == 3:
            output, target = output[None], target[None]
    return [hausdorff_distance_95(o, t)
            for o, t in zip(_composites(output), _composites(target))]


# Upper bound on any squared voxel distance for volumes up to 256 per axis:
# 3 * 255^2 + 1; exact in f32 and far below edt.INF.
VMAX = float(3 * 255 ** 2 + 1)


def composite_masks(x: torch.Tensor) -> torch.Tensor:
    """(D, H, W) labels -> (3, D, H, W) bool WT, TC, ET masks."""
    return torch.stack([x > 0, (x == 1) | (x == 3), x == 3])


def borders(o: torch.Tensor, t: torch.Tensor, batched_call_shape: bool):
    """The HD95 borders of composite masks: the masks themselves under the
    reference's batched-call quirk, their surfaces otherwise."""
    if batched_call_shape:
        return o, t
    return edt.surface(o), edt.surface(t)


def pooled_distances(ob: torch.Tensor, tb: torch.Tensor):
    """Pooled squared distances of HD95 for the three composites.

    ``ob``/``tb``: (3, D, H, W) bool borders of prediction and target.
    Returns the (3, 2N) float32 pool -- distances from each border voxel of
    one side to the other side's border, ``edt.INF`` elsewhere -- and the
    (3,) count of its finite entries.  Both EDTs run as one (6, D, H, W)
    transform."""
    d = edt.squared_edt(torch.cat([tb, ob]))
    d1 = torch.where(ob, d[:3], edt.INF)
    d2 = torch.where(tb, d[3:], edt.INF)
    pooled = torch.cat([d1.reshape(3, -1), d2.reshape(3, -1)], -1)
    return pooled, ob.sum((1, 2, 3)) + tb.sum((1, 2, 3))


def percentile_ranks(n: torch.Tensor) -> torch.Tensor:
    """Device twin of numpy's percentile index arithmetic: (..., 2) int32
    ranks floor / ceil of float64(0.95) * (max(n, 1) - 1).

    With m = max(n, 1) - 1 = 20q + r (exact int32): 0.95*m = 19q + 0.95*r,
    where for r = 0 the float64 product rounds to exactly 19q, and for r in
    [1, 19] 0.95*r is at least 0.05 from any integer, so float32 brackets as
    float64 does: k_lo = 19q + floor(0.95 r), k_hi = k_lo + (r != 0)."""
    m = torch.clamp(n.to(torch.int32), min=1) - 1
    q, r = m // 20, m % 20
    k_lo = 19 * q + torch.floor(
        torch.tensor(0.95, dtype=torch.float32, device=n.device)
        * r.to(torch.float32)).to(torch.int32)
    k_hi = torch.where(r == 0, k_lo, k_lo + 1)
    return torch.stack([k_lo, k_hi], dim=-1)


class DeviceMetrics:
    """Dice / mIoU / HD95 computed on the device, equal to the host
    functions above: Dice and mIoU come from exact integer voxel counts
    divided on the host in float64; HD95 runs the exact squared EDT
    (``ops/edt.py``) on the device, finds the two bracketing order
    statistics of the pooled surface-distance multiset by integer search,
    and finishes with a float64 sqrt and numpy's two-sided lerp on the host.

    Every volume, degenerate or not, runs the same device work (both EDTs,
    stacked into one (6, D, H, W) transform, and the whole search), and the
    results come back as ONE packed int32 vector: one fetch per volume.
    ``device`` defaults to the GPU (raises if there is none; pass
    ``device='cpu'`` for the CPU).

    ``batched_call_shape`` mirrors :func:`cal_hausdorff`: True reproduces
    the reference's full-mask "surfaces", False the corrected metric.
    """

    def __init__(self, batched_call_shape: bool = True,
                 use_hd95: bool = True, device=None):
        self.batched_call_shape = batched_call_shape
        self.use_hd95 = use_hd95
        self.device = resolve_device(device)

    def _input(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=self.device, dtype=torch.int32)

    def packed(self, output, target) -> torch.Tensor:
        """The device program: one int32 vector on the device,
        [counts (4x3), degenerate (3), n (3), order stats (3x2 with
        HD95)]."""
        output, target = self._input(output), self._input(target)
        if output.dim() == 4:          # strip an incoming batch-1 axis
            output, target = output[0], target[0]
        o = composite_masks(output)
        t = composite_masks(target)
        dims = (1, 2, 3)
        o_sum, t_sum = o.sum(dims), t.sum(dims)
        inter, union = (o & t).sum(dims), (o | t).sum(dims)
        size = o[0].numel()
        degenerate = ((o_sum == 0) | (o_sum == size)
                      | (t_sum == 0) | (t_sum == size))
        parts = [torch.stack([o_sum, t_sum, inter, union]).reshape(-1),
                 degenerate, torch.zeros(3, dtype=torch.int32,
                                         device=self.device)]
        if self.use_hd95:
            pooled, n = pooled_distances(
                *borders(o, t, self.batched_call_shape))
            vs = edt.masked_order_stats(pooled, percentile_ranks(n), VMAX)
            parts[2] = n
            parts.append(vs.reshape(-1))
        return torch.cat([p.to(torch.int32) for p in parts])

    def __call__(self, output, target) -> dict:
        """``output``/``target``: integer label volumes (D, H, W) or
        (1, D, H, W), numpy or torch.  Returns {'dice': [wt, tc, et],
        'miou': [...], 'hd95': [...]}."""
        packed = self.packed(output, target).cpu().numpy()
        counts = packed[:12].reshape(4, 3).astype(np.float64)
        degenerate = packed[12:15].astype(bool)
        o_sum, t_sum, inter, union = counts
        eps = 1e-8
        dice = ((2.0 * inter + eps) / (o_sum + t_sum + eps)).tolist()
        miou = ((inter + eps) / (union + eps)).tolist()
        if not self.use_hd95:
            return {"dice": dice, "miou": miou, "hd95": [0.0, 0.0, 0.0]}
        n = packed[15:18].astype(np.int64)
        # numpy's percentile index in float64; the bracketing ranks were
        # found on the device (see percentile_ranks), so only the
        # interpolation fraction is needed here
        idx = 0.95 * (np.maximum(n, 1) - 1).astype(np.float64)
        k_lo = np.floor(idx).astype(np.int32)
        vs = packed[18:24].reshape(3, 2).astype(np.float64)
        hd = []
        for c in range(3):
            if degenerate[c]:
                hd.append(0.0)
                continue
            a, b = np.sqrt(vs[c, 0]), np.sqrt(vs[c, 1])
            t_frac = idx[c] - k_lo[c]
            # numpy's _lerp: the two-sided form
            val = a + (b - a) * t_frac
            if t_frac >= 0.5:
                val = b - (b - a) * (1 - t_frac)
            hd.append(float(val))
        return {"dice": dice, "miou": miou, "hd95": hd}
