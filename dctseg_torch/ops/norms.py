"""Normalization primitives with the reference's PyTorch semantics, on
NDHWC tensors (the JAX package's ``dctseg/ops/norms.py``).

Statistics are f32 E[x^2] - mean^2, clamped at 0, as in the JAX package,
so that both packages round alike; the same formula lets a D-sharded
volume reduce its statistics with one all-reduce of (sum x, sum x^2).
"""

from __future__ import annotations

import math

import torch

from dctseg_torch.parallel import spatial


def normalize(x32: torch.Tensor, axes: tuple, eps: float) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) with statistics over ``axes`` of the
    f32 tensor ``x32``.  On a D slab under ``parallel.spatial.sharded`` the
    sums of x and x^2 are summed over the space group first and divided by
    the whole volume's count."""
    shard = spatial.active()
    if shard is None:
        mean = x32.mean(dim=axes, keepdim=True)
        sq = x32.square().mean(dim=axes, keepdim=True)
    else:
        sums = spatial.reduce_stats(torch.stack([
            x32.sum(dim=axes, keepdim=True),
            x32.square().sum(dim=axes, keepdim=True)]), shard)
        count = math.prod(x32.shape[a] for a in axes) * shard.size
        mean, sq = sums[0] / count, sums[1] / count
    var = torch.clamp(sq - mean.square(), min=0.0)
    return (x32 - mean) * torch.rsqrt(var + eps)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free InstanceNorm over an NDHWC tensor (reduce D,H,W per
    (B, C)); ``torch.nn.InstanceNorm3d`` defaults."""
    return normalize(x.float(), (1, 2, 3), eps).to(x.dtype)


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
