"""Fused InstanceNorm + activation (+ residual): the port of the TPU kernel
``dctseg/ops/pallas/fusednorm.py`` ``fused_instance_norm_act``.

On a CUDA tensor the wrapper launches the hand-written kernel of
``dctseg_torch/csrc/fusednorm.cu`` (a stats pass and an apply pass) or
raises; on a CPU tensor it runs the plain PyTorch version below, which
follows the kernel's order of operations: f32 per-lane sums, offsets
folded onto fine channels, y = x*a + b, activation in f32, cast, then the
residual added in the output dtype.  (The JAX package's XLA twin casts
before the activation; the two differ only where a bf16 rounding crosses
zero.)
"""

from __future__ import annotations

import math

import torch

from dctseg_torch.ops import _build

ACTS = {"none": 0, "relu": 1, "lrelu": 2}
_THREADS = 256          # csrc/fusednorm.cu kThreads
_STATS_BLOCKS = 528     # stats-pass blocks to aim for: 4 per SM on 132 SMs


def _act(y: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    if act == "relu":
        return torch.clamp(y, min=0.0)
    if act == "lrelu":
        return torch.where(y >= 0, y, slope * y)
    return y


def fused_instance_norm_act_plain(x: torch.Tensor, fine_channels: int,
                                  eps: float = 1e-5, act: str = "none",
                                  slope: float = 0.01,
                                  residual: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device, any layout)."""
    n, cb = x.shape[0], x.shape[-1]
    o = cb // fine_channels
    xr = x.reshape(n, -1, cb).float()
    s = xr.sum(dim=1).reshape(n, o, fine_channels).sum(dim=1)
    sq = xr.square().sum(dim=1).reshape(n, o, fine_channels).sum(dim=1)
    cnt = float(xr.shape[1] * o)
    mean = s / cnt
    var = torch.clamp(sq / cnt - mean.square(), min=0.0)
    a = torch.rsqrt(var + eps)
    b = -mean * a
    # lane o*C + c carries fine channel c
    a = a.repeat(1, o)[:, None, :]
    b = b.repeat(1, o)[:, None, :]
    y = _act(xr * a + b, act, slope).to(x.dtype).reshape(x.shape)
    return y + residual if residual is not None else y


def _check(x, fine_channels, act, residual):
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; expected one of {list(ACTS)}")
    if x.dim() < 3 or x.shape[-1] % fine_channels:
        raise ValueError(
            f"x must be (N, *spatial, C) with fine_channels | C; got "
            f"{tuple(x.shape)}, fine_channels={fine_channels}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError("residual must match x in shape, dtype and device")


def fused_instance_norm_act(x: torch.Tensor, fine_channels: int,
                            eps: float = 1e-5, act: str = "none",
                            slope: float = 0.01,
                            residual: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """InstanceNorm (affine-free, per fine channel) + activation (+ residual
    added after the activation).

    ``x``: (N, *spatial, C), C = O * fine_channels, lane o*fine_channels + c
    belonging to fine channel c.  ``act``: 'none' | 'relu' | 'lrelu'.
    On CUDA, ``x`` and ``residual`` must be contiguous (channels last).
    """
    _check(x, fine_channels, act, residual)
    if x.device.type == "cpu":
        return fused_instance_norm_act_plain(x, fine_channels, eps, act,
                                             slope, residual)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch(x, fine_channels, eps, act, slope, residual)


fused_instance_norm_act.launches = 0   # kernel launches on CUDA tensors


def _launch(x, fine_channels, eps, act, slope, residual):
    if not x.is_contiguous() or (residual is not None
                                 and not residual.is_contiguous()):
        raise ValueError("the fusednorm kernel takes contiguous "
                         "(N, *spatial, C) tensors (channels last)")
    dtype = _build.dtype_code(x.dtype)
    n, c = x.shape[0], x.shape[-1]
    s = x.numel() // (n * c)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    vec = 16 // x.element_size()
    ptrs = [x.data_ptr(), out.data_ptr()] + (
        [residual.data_ptr()] if residual is not None else [])
    if c % vec or any(p % 16 for p in ptrs):
        vec = 1
    groups = c // vec
    if groups > _THREADS:
        raise ValueError(f"fusednorm kernel takes C <= {_THREADS * vec} "
                         f"channels here; got C={c}")
    rows_per_iter = _THREADS // groups
    splits = max(1, min(math.ceil(_STATS_BLOCKS / n),
                        math.ceil(s / rows_per_iter)))
    rows_per_split = math.ceil(s / splits)
    splits = math.ceil(s / rows_per_split)

    lib = _build.lib()
    stream = _build.stream_of(x)
    ab = torch.empty((n, 2, c), device=x.device, dtype=torch.float32)
    partial = torch.empty((n, splits, 2, c), device=x.device,
                          dtype=torch.float32)
    counter = torch.zeros((n,), device=x.device, dtype=torch.int32)
    _build.check(lib.dctseg_fusednorm_stats(
        x.data_ptr(), ab.data_ptr(), partial.data_ptr(), counter.data_ptr(),
        n, s, c, fine_channels, splits, rows_per_split, eps, dtype, vec,
        stream), "fusednorm stats")
    fused_instance_norm_act.launches += 1
    _build.check(lib.dctseg_fusednorm_apply(
        x.data_ptr(), ab.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        out.data_ptr(), n, s, c, ACTS[act], slope, dtype, vec, stream),
        "fusednorm apply")
    fused_instance_norm_act.launches += 1
    return out
