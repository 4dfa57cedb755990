"""8-valued composite edge labels (the JAX package's ``dctseg/data/edge.py``,
its scipy path).

Per-voxel codes say which region boundaries pass through a voxel:
    {1}->1  {2}->2  {4}->4  {1,2}->6  {1,4}->7  {2,4}->8  {1,2,4}->5  {}->0
so the loss decode's positive set per region is
    region 1: {1, 5, 6, 7}   region 2: {2, 5, 6, 8}   region 4: {4, 5, 7, 8}

Boundaries are the morphological gradient of each region mask (dilation AND
NOT erosion, 6-connectivity), so boundaries of adjacent regions coincide and
the composite codes 5-8 occur.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi

# region id -> bit, and (bit pattern of {1,2,4}) -> code
_BIT = {1: 1, 2: 2, 3: 4}  # label 3 holds original BraTS label 4
_CODE = {0: 0, 1: 1, 2: 2, 4: 4, 3: 6, 5: 7, 6: 8, 7: 5}


def region_boundary(mask: np.ndarray, connectivity: int = 1) -> np.ndarray:
    """Morphological gradient of a boolean mask."""
    structure = ndi.generate_binary_structure(mask.ndim, connectivity)
    dil = ndi.binary_dilation(mask, structure=structure)
    ero = ndi.binary_erosion(mask, structure=structure)
    return dil & ~ero


def make_edge_map(label: np.ndarray) -> np.ndarray:
    """(D, H, W) int labels {0,1,2,3} -> uint8 edge codes
    {0,1,2,4,5,6,7,8}."""
    bits = np.zeros(label.shape, np.uint8)
    for region, bit in _BIT.items():
        bits[region_boundary(label == region)] |= bit
    out = np.zeros(label.shape, np.uint8)
    for pattern, code in _CODE.items():
        if pattern:
            out[bits == pattern] = code
    return out


def decode_edge_map(edge: np.ndarray) -> dict:
    """Inverse mapping: edge codes -> per-region boolean boundary masks."""
    return {
        "01": np.isin(edge, (1, 5, 6, 7)),
        "02": np.isin(edge, (2, 5, 6, 8)),
        "04": np.isin(edge, (4, 5, 7, 8)),
    }
