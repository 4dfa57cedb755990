"""Min-plus passes of the exact squared EDT: the port of the TPU kernel
``dctseg/ops/pallas/minplus.py`` (``minplus_sublane``, ``squared_edt_3d``).

On a CUDA tensor ``minplus_pass`` and ``minplus_pass_minor`` launch the
hand-written lower-envelope kernel of ``dctseg_torch/csrc/minplus.cu`` or
raise; on a CPU tensor they run the plain PyTorch versions below.  The
kernel takes integer values in [0, 2^24 - (D - 1)^2] held in float32, as
the EDT's are (``ops/edt.py``); on them every sum is exact and min is
order-independent, so kernel and plain version are bit-identical.
"""

from __future__ import annotations

import torch

from dctseg_torch.ops import _build

MAX_D = 256          # csrc/minplus.cu kMaxD; edt.INF stays exact up to it
_TILE = 32           # csrc/minplus.cu kCols: columns or rows per block
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


def minplus_pass_minor_plain(x: torch.Tensor) -> torch.Tensor:
    """out[r, i] = min_j x[r, j] + (i - j)^2 on an (R, D) float32 tensor:
    the plain pass on the transposed (1, D, R) view."""
    return minplus_pass_plain(x.t()[None])[0].t().contiguous()


def _check(x: torch.Tensor, ndim: int, form: str) -> None:
    if x.dim() != ndim or x.dtype != torch.float32 or min(x.shape) < 1:
        raise ValueError(f"expected a non-empty {form} float32 tensor; "
                         f"got {tuple(x.shape)} {x.dtype}")
    if x.shape[1] > MAX_D:
        raise ValueError(f"pass length {x.shape[1]} above {MAX_D}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("the min-plus kernel takes a contiguous tensor")


def minplus_pass(x: torch.Tensor) -> torch.Tensor:
    """One min-plus pass along axis 1 of a contiguous (A, D, B) float32
    tensor, D <= 256."""
    _check(x, 3, "(A, D, B)")
    if x.device.type == "cpu":
        return minplus_pass_plain(x)
    a, d, b = x.shape
    if a * -(-b // _TILE) > 0x7fffffff:
        raise ValueError(f"(A, D, B) = {tuple(x.shape)} needs more blocks "
                         "than one launch takes")
    out = torch.empty_like(x)
    _build.check(_build.lib().dctseg_minplus_pass(
        x.data_ptr(), out.data_ptr(), a, d, b, _build.stream_of(x)),
        "minplus")
    minplus_pass.launches += 1
    return out


def minplus_pass_minor(x: torch.Tensor) -> torch.Tensor:
    """One min-plus pass along the minor axis of a contiguous (R, D) float32
    tensor, D <= 256: the kernel stages 32 rows at a time and transposes
    them in shared memory, so no transposed copy is made."""
    _check(x, 2, "(R, D)")
    if x.device.type == "cpu":
        return minplus_pass_minor_plain(x)
    r, d = x.shape
    if -(-r // _TILE) > 0x7fffffff:
        raise ValueError(f"(R, D) = {tuple(x.shape)} needs more blocks "
                         "than one launch takes")
    out = torch.empty_like(x)
    _build.check(_build.lib().dctseg_minplus_pass_minor(
        x.data_ptr(), out.data_ptr(), r, d, _build.stream_of(x)), "minplus")
    minplus_pass.launches += 1
    return out


# kernel launches on CUDA tensors, of both layouts
minplus_pass.launches = 0


def squared_edt_3d(f: torch.Tensor) -> torch.Tensor:
    """Exact squared EDT over the last three axes of an initialised cost
    volume ``f`` (0 on foreground, ``edt.INF`` elsewhere); leading axes are
    batch.  Three passes, each along its own axis of a view of the
    contiguous (A, X, Y, Z) volume, with no transposed copy:

      1. along X on (A, X, Y*Z);
      2. along Y on (A*X, Y, Z);
      3. along Z on (A*X*Y, Z), the minor axis.

    The TPU kernel's caller transposes to (A, Z, Y, X) instead; min-plus
    passes commute and every value is exact, so the result is the same.
    """
    shp = f.shape
    x_, y_, z_ = shp[-3:]
    if f.numel() == 0:
        return f.float()
    f = f.reshape(-1, x_, y_, z_).float().contiguous()
    a = f.shape[0]
    f = minplus_pass(f.reshape(a, x_, y_ * z_))
    f = minplus_pass(f.reshape(a * x_, y_, z_))
    return minplus_pass_minor(f.reshape(a * x_ * y_, z_)).reshape(shp)
