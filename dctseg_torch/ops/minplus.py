"""Min-plus passes of the exact squared EDT: the port of the TPU kernel
``dctseg/ops/pallas/minplus.py`` (``minplus_sublane``, ``squared_edt_3d``).

On a CUDA tensor ``minplus_pass`` launches the hand-written kernel of
``dctseg_torch/csrc/minplus.cu`` or raises; on a CPU tensor it runs the
plain PyTorch version below.  Every value is an integer below 2^24, exact
in float32, and min is order-independent, so the two are bit-identical.
"""

from __future__ import annotations

import torch

from dctseg_torch.ops import _build

MAX_D = 256          # csrc/minplus.cu kMaxD; edt.INF stays exact up to it
_TILE_B = 32         # csrc/minplus.cu kTileB
_CHUNK_BYTES = 1 << 30


def minplus_pass_plain(x: torch.Tensor) -> torch.Tensor:
    """out[a, i, b] = min_j x[a, j, b] + (i - j)^2 on an (A, D, B) float32
    tensor: the broadcast-and-min of the JAX package's ``_minplus_pass``.
    Output rows go in chunks, so the (A, rows, D, B) transient stays under
    1 GiB (unchunked, one 240-long pass over (3, 240, 240, 155) needs
    25.7 GB)."""
    a, d, b = x.shape
    j = torch.arange(d, dtype=torch.float32, device=x.device)
    rows = max(1, _CHUNK_BYTES // max(1, 4 * a * d * b))
    out = torch.empty_like(x)
    for i0 in range(0, d, rows):
        cost = torch.square(j[i0:i0 + rows, None] - j[None, :])  # (rows, D)
        out[:, i0:i0 + rows] = torch.amin(
            x[:, None, :, :] + cost[None, :, :, None], dim=2)
    return out


def _launch(x: torch.Tensor) -> torch.Tensor:
    a, d, b = x.shape
    if a * -(-b // _TILE_B) > 0x7fffffff:
        raise ValueError(f"(A, D, B) = {tuple(x.shape)} needs more blocks "
                         "than one launch takes")
    out = torch.empty_like(x)
    lib = _build.lib()
    stream = _build.stream_of(x)
    _build.check(lib.dctseg_minplus_pass(x.data_ptr(), out.data_ptr(), a, d,
                                         b, stream), "minplus")
    minplus_pass.launches += 1
    return out


def minplus_pass(x: torch.Tensor) -> torch.Tensor:
    """One min-plus pass along axis 1 of a contiguous (A, D, B) float32
    tensor, D <= 256."""
    if x.dim() != 3 or x.dtype != torch.float32 or min(x.shape) < 1:
        raise ValueError(f"expected a non-empty (A, D, B) float32 tensor; "
                         f"got {tuple(x.shape)} {x.dtype}")
    if x.shape[1] > MAX_D:
        raise ValueError(f"pass length {x.shape[1]} above {MAX_D}")
    if x.device.type == "cpu":
        return minplus_pass_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("the min-plus kernel takes a contiguous tensor")
    return _launch(x)


minplus_pass.launches = 0   # kernel launches on CUDA tensors


def squared_edt_3d(f: torch.Tensor) -> torch.Tensor:
    """Exact squared EDT over the last three axes of an initialised cost
    volume ``f`` (0 on foreground, ``edt.INF`` elsewhere); leading axes are
    batch.  Three passes, ordered as in the TPU kernel's caller so that each
    pass runs along a non-minor axis of a contiguous view (min-plus passes
    commute, so the order does not change the result):

      1. along X on (A, X, Y*Z);
      2. transpose to (A, Z, Y, X), along Y on (A*Z, Y, X);
      3. along Z on (A, Z, Y*X), transpose back.
    """
    shp = f.shape
    x_, y_, z_ = shp[-3:]
    if f.numel() == 0:
        return f.float()
    f = f.reshape(-1, x_, y_, z_).float().contiguous()
    a = f.shape[0]
    f = minplus_pass(f.reshape(a, x_, y_ * z_)).reshape(a, x_, y_, z_)
    f = f.permute(0, 3, 2, 1).contiguous()                    # (A, Z, Y, X)
    f = minplus_pass(f.reshape(a * z_, y_, x_)).reshape(a, z_, y_, x_)
    f = minplus_pass(f.reshape(a, z_, y_ * x_)).reshape(a, z_, y_, x_)
    return f.permute(0, 3, 2, 1).reshape(shp)
