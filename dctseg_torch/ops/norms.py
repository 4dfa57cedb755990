"""Normalization primitives with the reference's PyTorch semantics, on
NDHWC tensors (the JAX package's ``dctseg/ops/norms.py``).

Statistics are f32 E[x^2] - mean^2, clamped at 0, as in the JAX package,
so that both packages round alike.
"""

from __future__ import annotations

import torch


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free InstanceNorm over an NDHWC tensor (reduce D,H,W per
    (B, C)); ``torch.nn.InstanceNorm3d`` defaults."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2, 3), keepdim=True)
    sq = x32.square().mean(dim=(1, 2, 3), keepdim=True)
    var = torch.clamp(sq - mean.square(), min=0.0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with affine params, computed in f32."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """torch nn.LeakyReLU default slope 0.01 (x >= 0 keeps x)."""
    return torch.where(x >= 0, x, negative_slope * x)
