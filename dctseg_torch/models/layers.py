"""Building blocks with the JAX package's semantics (``dctseg/models/
layers.py``), on NDHWC activations.

Parameters are held in f32 in PyTorch's own layouts (conv (O, I, k, k, k),
transpose conv (I, O, k, k, k), linear (O, I)) and cast to the compute dtype
at each call, as flax's ``param_dtype=f32, dtype=bf16`` does.  The convs run
on the permuted NCDHW view of the NDHWC activation -- channels_last_3d
memory, which cuDNN takes as it is -- and hand back NDHWC.

Init follows ``torch_kernel_init``: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with
fan_in = in_channels * prod(kernel) (for the transpose conv too, as flax
counts it), zero biases.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dctseg_torch.ops.norms import instance_norm, layer_norm, leaky_relu


def _uniform_(t: torch.Tensor, fan_in: int, generator) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


class Conv3d(nn.Module):
    """3D convolution on NDHWC with torch-style explicit padding."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               k, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        _uniform_(self.weight, in_channels * k ** 3, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv3d(ncdhw(x.to(self.dtype)), self.weight.to(self.dtype),
                     self.bias.to(self.dtype), self.stride, self.padding)
        return ndhwc(y)


class ConvTranspose3d(nn.Module):
    """``nn.ConvTranspose3d(k=2, s=2)`` upsampling on NDHWC."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 2, stride: int = 2,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        k = kernel_size
        self.stride, self.dtype = stride, dtype
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels,
                                               k, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        _uniform_(self.weight, in_channels * k ** 3, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose3d(ncdhw(x.to(self.dtype)),
                               self.weight.to(self.dtype),
                               self.bias.to(self.dtype), self.stride)
        return ndhwc(y)


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        _uniform_(self.weight, in_features, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor, rows: slice = slice(None)
                ) -> torch.Tensor:
        """``rows`` selects output features (a slice of the weight rows)."""
        b = self.bias[rows].to(self.dtype) if self.bias is not None else None
        return F.linear(x.to(self.dtype), self.weight[rows].to(self.dtype), b)


class LayerNorm(nn.Module):
    """Affine LayerNorm over the last axis, computed in f32."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class InstanceNormAct(nn.Module):
    """InstanceNorm3d (no affine) + LeakyReLU(0.01), plain ops."""

    def __init__(self, eps: float = 1e-5, negative_slope: float = 0.01):
        super().__init__()
        self.eps, self.negative_slope = eps, negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(instance_norm(x, self.eps), self.negative_slope)
