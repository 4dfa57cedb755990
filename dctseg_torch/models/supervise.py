"""Deep-supervision heads producing per-region 2-class probability maps
(the JAX package's ``dctseg/models/supervise.py``).

Semantic head: conv(C->32) -> conv(32->2) -> trilinear x8 -> softmax.
Edge head: conv(C->8) -> conv(8->2) -> trilinear x4 -> softmax.  Conv names
are the reference's (``supervise_label_1`` / ``down_label_1``, with an
``edge_`` prefix in the edge heads).
"""

from __future__ import annotations

import torch
from torch import nn

from dctseg_torch.models.layers import Conv3d
from dctseg_torch.ops.resize import trilinear_upsample

REGIONS = ("01", "02", "04")


class SuperviseHead(nn.Module):
    def __init__(self, in_channels, mid_channels, upsample_scale, edge,
                 dtype, generator=None):
        super().__init__()
        self.scale = upsample_scale
        self.prefix = "edge_" if edge else ""
        for r in REGIONS:
            i = r[1]
            self.add_module(f"{self.prefix}supervise_label_{i}", Conv3d(
                in_channels, mid_channels, dtype=dtype, generator=generator))
            self.add_module(f"{self.prefix}down_label_{i}", Conv3d(
                mid_channels, 2, dtype=dtype, generator=generator))

    def forward(self, fea_01, fea_02, fea_04):
        out = {}
        for r, fea in zip(REGIONS, (fea_01, fea_02, fea_04)):
            i = r[1]
            y = getattr(self, f"{self.prefix}supervise_label_{i}")(fea)
            y = getattr(self, f"{self.prefix}down_label_{i}")(y)
            y = trilinear_upsample(y.float(), self.scale)
            out[r] = torch.softmax(y, dim=-1)
        return out
