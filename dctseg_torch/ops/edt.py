"""Exact Euclidean distance transform and the order-statistic search of
HD95, on the device (the JAX package's ``dctseg/ops/edt.py``).

The transform is separable: with f0 = 0 on foreground and ``INF``
elsewhere, three 1-D min-plus passes give the exact squared Euclidean
distance d^2(x) = min_y ||x - y||^2 over foreground y.  All squared
distances are integers <= 3 * 255^2 < 2^24, so float32 arithmetic is exact
and, after a float64 sqrt on the host, matches scipy's EDT bit for bit.

There is no ``impl`` switch: the device picks the route.  On a CUDA tensor
``squared_edt`` runs its passes through the min-plus kernel
(``ops/minplus.py``) and ``masked_order_stats`` runs the m-ary search over
the count kernel (``ops/orderstats.py``); on a CPU tensor the same code runs
the kernels' plain versions.  ``binary_search_order_stats`` is the search's
oracle, used only to check it.
"""

from __future__ import annotations

import math

import torch

from dctseg_torch.ops import minplus, orderstats

# Sentinel for "no foreground": exact in f32 (< 2^24) and, after three
# passes each adding <= (D-1)^2 (D <= 256), still exact and larger than any
# true squared distance.
INF = 1.0e7


def squared_edt(mask: torch.Tensor) -> torch.Tensor:
    """Exact squared Euclidean distance to the nearest True voxel, over the
    LAST THREE axes of a bool tensor (leading axes are batch).  All-False
    masks give :data:`INF` everywhere."""
    f = torch.where(mask, torch.zeros((), device=mask.device),
                    torch.full((), INF, device=mask.device))
    return minplus.squared_edt_3d(f)


def erode_cross(mask: torch.Tensor) -> torch.Tensor:
    """Binary erosion with the 3-D cross (6-connectivity) footprint over the
    last three axes, as ``scipy.ndimage.binary_erosion`` with
    ``generate_binary_structure(3, 1)`` and border_value=0 (array-edge
    voxels erode away)."""
    out = mask.clone()
    nd = mask.dim()
    for axis in (nd - 3, nd - 2, nd - 1):
        d = mask.shape[axis]
        lo = torch.zeros_like(mask)               # lo[i] = mask[i - 1]
        lo.narrow(axis, 1, d - 1).copy_(mask.narrow(axis, 0, d - 1))
        hi = torch.zeros_like(mask)               # hi[i] = mask[i + 1]
        hi.narrow(axis, 0, d - 1).copy_(mask.narrow(axis, 1, d - 1))
        out &= lo & hi
    return out


def surface(mask: torch.Tensor) -> torch.Tensor:
    """Surface voxels: mask minus its cross-erosion (medpy's border
    extraction in ``__surface_distances``)."""
    return mask & ~erode_cross(mask)


def binary_search_order_stats(values: torch.Tensor, ks: torch.Tensor,
                              vmax: float) -> torch.Tensor:
    """k-th smallest (0-based) of the entries below ``vmax``: values
    (..., N) f32, ks (..., K) int -> (..., K) f32.  Integer binary search
    over [0, vmax], exact for integer-valued distances: the oracle of the
    m-ary search."""
    ks = ks.to(device=values.device, dtype=torch.int32)
    lo = torch.zeros(ks.shape, dtype=torch.float32, device=values.device)
    hi = torch.full(ks.shape, float(vmax), dtype=torch.float32,
                    device=values.device)
    iters = int(math.ceil(math.log2(float(vmax) + 2.0)))
    v = values[..., None, :]                                 # (..., 1, N)
    for _ in range(iters):
        mid = torch.floor((lo + hi) / 2)
        cnt = (v <= mid[..., None]).sum(-1, dtype=torch.int32)
        ok = cnt >= ks + 1                     # k-th smallest <= mid
        lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
    return hi


# k-th smallest entry below vmax: the m-ary search over the count kernel
masked_order_stats = orderstats.masked_order_stats
