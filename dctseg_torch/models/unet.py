"""3D UNet encoder and decoder of ClsWiseFormer, direct path (the JAX
package's ``dctseg/models/unet.py`` with ``s2d=False``, ``s2d_half=False``).

Encoder (reference ``Unet``): InitConv, [EnBlock x2 -> stride-2 EnDown] x3,
EnBlock x2 -> stride-1 widening conv.  Decoder (reference ``Decoder``):
1x1 conv, EnBlock2 x2, then 3x [DeUp_Cat + DeBlock x2], 1x1 endconv and an
f32 softmax over classes.  EnBlock is pre-activation (IN -> ReLU -> conv),
EnBlock2/DeBlock post-activation (conv -> IN -> LReLU, residual on the last
norm).  Submodule names are the reference's, so its checkpoints load.
"""

from __future__ import annotations

import torch
from torch import nn

from dctseg_torch.models.layers import Conv3d, ConvTranspose3d
from dctseg_torch.ops.fusednorm import fused_instance_norm_act
from dctseg_torch.ops.norms import instance_norm, leaky_relu


def _norm_act(x: torch.Tensor, eps: float, act: str, fused: bool,
              residual: torch.Tensor | None = None) -> torch.Tensor:
    """InstanceNorm + activation (+ residual): the fused kernel, or the
    JAX package's plain composition (norm, cast, activation, add)."""
    if fused:
        return fused_instance_norm_act(
            x.contiguous(), x.shape[-1], eps, act=act,
            residual=None if residual is None else residual.contiguous())
    y = instance_norm(x, eps)
    y = torch.relu(y) if act == "relu" else leaky_relu(y)
    return y + residual if residual is not None else y


class _EnBlock(nn.Module):
    """Pre-activation residual block: [IN -> ReLU -> conv3] x2 + skip."""

    def __init__(self, channels, dtype, eps, fused_norms, generator):
        super().__init__()
        self.eps, self.fused = eps, fused_norms
        self.conv1 = Conv3d(channels, channels, dtype=dtype,
                            generator=generator)
        self.conv2 = Conv3d(channels, channels, dtype=dtype,
                            generator=generator)

    def forward(self, x):
        y = _norm_act(x, self.eps, "relu", self.fused)
        y = self.conv1(y)
        y = _norm_act(y, self.eps, "relu", self.fused)
        return self.conv2(y) + x


class _EnBlock2(nn.Module):
    """Post-activation residual block: [conv3 -> IN -> LeakyReLU] x2, the
    skip added after the last activation (DeBlock is identical)."""

    def __init__(self, channels, dtype, eps, fused_norms, generator):
        super().__init__()
        self.eps, self.fused = eps, fused_norms
        self.conv1 = Conv3d(channels, channels, dtype=dtype,
                            generator=generator)
        self.conv2 = Conv3d(channels, channels, dtype=dtype,
                            generator=generator)

    def forward(self, x):
        y = _norm_act(self.conv1(x), self.eps, "lrelu", self.fused)
        return _norm_act(self.conv2(y), self.eps, "lrelu", self.fused,
                         residual=x)


def _named_conv(**kw) -> nn.ModuleDict:
    """A conv under the reference's ``<block>.conv`` name."""
    return nn.ModuleDict({"conv": Conv3d(**kw)})


class UnetEncoder(nn.Module):
    """Returns (x1_1, x2_1, x3_1, bottleneck) like the reference's
    ``Unet.forward``.  InitConv's spatial dropout runs only in training and
    is absent here."""

    def __init__(self, in_channels, base_channels, dtype, eps, fused_norms,
                 generator=None):
        super().__init__()
        b0 = base_channels

        def block(c):
            return _EnBlock(c, dtype, eps, fused_norms, generator)

        def conv(i, o, stride):
            return _named_conv(in_channels=i, out_channels=o, stride=stride,
                               dtype=dtype, generator=generator)

        self.InitConv = conv(in_channels, b0, 1)
        self.EnBlock1, self.EnBlock1_1 = block(b0), block(b0)
        self.EnDown1 = conv(b0, 2 * b0, 2)
        self.EnBlock2_1, self.EnBlock2_2 = block(2 * b0), block(2 * b0)
        self.EnDown2 = conv(2 * b0, 4 * b0, 2)
        self.EnBlock3_1, self.EnBlock3_2 = block(4 * b0), block(4 * b0)
        self.EnDown3 = conv(4 * b0, 8 * b0, 2)
        self.EnBlock4_1, self.EnBlock4_2 = block(8 * b0), block(8 * b0)
        self.EnDown_4 = conv(8 * b0, 16 * b0, 1)   # stride-1 widening conv

    def forward(self, x):
        x = self.InitConv["conv"](x)
        x1_1 = self.EnBlock1_1(self.EnBlock1(x))
        x = self.EnDown1["conv"](x1_1)
        x2_1 = self.EnBlock2_2(self.EnBlock2_1(x))
        x = self.EnDown2["conv"](x2_1)
        x3_1 = self.EnBlock3_2(self.EnBlock3_1(x))
        x = self.EnDown3["conv"](x3_1)
        x4_1 = self.EnBlock4_2(self.EnBlock4_1(x))
        return x1_1, x2_1, x3_1, self.EnDown_4["conv"](x4_1)


class DeUpCat(nn.Module):
    """1x1 conv -> transpose-conv x2 upsample -> concat skip -> 1x1 conv.
    The reference names the transpose conv ``conv2``."""

    def __init__(self, in_channels, skip_channels, out_channels, dtype,
                 generator=None):
        super().__init__()
        o = out_channels
        self.conv1 = Conv3d(in_channels, o, kernel_size=1, padding=0,
                            dtype=dtype, generator=generator)
        self.conv2 = ConvTranspose3d(o, o, dtype=dtype, generator=generator)
        self.conv3 = Conv3d(skip_channels + o, o, kernel_size=1, padding=0,
                            dtype=dtype, generator=generator)

    def forward(self, x, skip):
        y = self.conv2(self.conv1(x))
        return self.conv3(torch.cat([skip, y], dim=-1))


class Decoder(nn.Module):
    """UNet decoder with deep skips; returns f32 softmax class probs."""

    def __init__(self, embedding_dim, num_classes, base_channels, dtype, eps,
                 fused_norms, generator=None):
        super().__init__()
        e, b0 = embedding_dim, base_channels

        def block(c):
            return _EnBlock2(c, dtype, eps, fused_norms, generator)

        self.down_channel = Conv3d(e, e // 2, kernel_size=1, padding=0,
                                   dtype=dtype, generator=generator)
        self.Enblock8_1, self.Enblock8_2 = block(e // 2), block(e // 2)
        self.DeUp4 = DeUpCat(e // 2, 4 * b0, e // 4, dtype, generator)
        self.DeBlock4, self.DeBlock4_1 = block(e // 4), block(e // 4)
        self.DeUp3 = DeUpCat(e // 4, 2 * b0, e // 8, dtype, generator)
        self.DeBlock3, self.DeBlock3_1 = block(e // 8), block(e // 8)
        self.DeUp2 = DeUpCat(e // 8, b0, e // 16, dtype, generator)
        self.DeBlock2, self.DeBlock2_1 = block(e // 16), block(e // 16)
        self.endconv = Conv3d(e // 16, num_classes, kernel_size=1, padding=0,
                              dtype=dtype, generator=generator)

    def forward(self, x1_1, x2_1, x3_1, x):
        x8 = self.Enblock8_2(self.Enblock8_1(self.down_channel(x)))
        y4 = self.DeBlock4_1(self.DeBlock4(self.DeUp4(x8, x3_1)))
        y3 = self.DeBlock3_1(self.DeBlock3(self.DeUp3(y4, x2_1)))
        y2 = self.DeBlock2_1(self.DeBlock2(self.DeUp2(y3, x1_1)))
        return torch.softmax(self.endconv(y2).float(), dim=-1)
