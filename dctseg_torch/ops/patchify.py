"""Patchify / unpatchify between NDHWC feature volumes and token sequences
(the JAX package's ``dctseg/ops/patchify.py``).

The token of grid cell (g0, g1, g2) is the flattened (C, p0, p1, p2) block
(channel-major within the token); tokens are row-major over the grid.
"""

from __future__ import annotations

from typing import Tuple

import torch


def patchify(x: torch.Tensor, patch: Tuple[int, int, int]) -> torch.Tensor:
    """(B, D0, D1, D2, C) -> (B, N, C*p0*p1*p2)."""
    b, d0, d1, d2, c = x.shape
    p0, p1, p2 = patch
    g0, g1, g2 = d0 // p0, d1 // p1, d2 // p2
    x = x.reshape(b, g0, p0, g1, p1, g2, p2, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, g0 * g1 * g2, c * p0 * p1 * p2)


def unpatchify(tokens: torch.Tensor, channels: int,
               image_size: Tuple[int, int, int],
               patch: Tuple[int, int, int]) -> torch.Tensor:
    """(B, N, C*p0*p1*p2) -> (B, D0, D1, D2, C); inverse of patchify."""
    b, n, t = tokens.shape
    p0, p1, p2 = patch
    g0, g1, g2 = (image_size[0] // p0, image_size[1] // p1,
                  image_size[2] // p2)
    if n != g0 * g1 * g2 or t != channels * p0 * p1 * p2:
        raise ValueError(f"tokens {tuple(tokens.shape)} do not tile "
                         f"{image_size} x {channels} by {patch}")
    x = tokens.reshape(b, g0, g1, g2, channels, p0, p1, p2)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, g0 * p0, g1 * p1, g2 * p2, channels)
