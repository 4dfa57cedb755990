"""K9: LayerNorm over the channels of token rows, with the Swin block's
padding, cyclic shift and window partition in its own addressing.

It replaces no TPU kernel (the JAX package has no Swin model): it replaces
the torch sequence around Swin UNETR's window attention
(``models/swin_unetr.py``, MONAI's ``SwinTransformerBlock``), in which every
pass (the norm on an f32 copy, the casts, ``F.pad``, ``torch.roll``, the
window partition and its reverse, the residual add) reads and writes every
token row.  Three routes, each an operator in ``ops/library.py``'s
namespace and each launching ``layer_norm_kernel`` of
``dctseg_torch/csrc/layernorm.cu`` on a CUDA tensor (or raising); on a CPU
tensor each runs its plain version below, today's exact torch sequence:

  * :func:`layer_norm_to_windows` (``torch.ops.dctseg.layer_norm_to_windows``):
    a block's norm1 written straight into K8's input, the (B * nW, N, C)
    windows over the grid padded to the window, rolled by -shift;
    padding rows are zeros (MONAI pads after the norm);
  * :func:`windows_residual_layer_norm`
    (``torch.ops.dctseg.windows_residual_layer_norm``): the attention's
    output windows back onto the grid (reverse, roll back, crop), added to
    the block's input x in f32 and rounded once, returned with norm2 of
    that rounded sum;
  * :func:`layer_norm` (``torch.ops.dctseg.layer_norm``): rows in place
    (PatchMerging's norm, the parameter-free ``proj_out``).

Statistics and the affine in f32 (the weight and bias f32, or None), the
output rounded once to the input's dtype: the plain versions' f32 norm
rounds the same f32 values, so the two differ only by the order of the f32
sums.  ``window`` and ``shift`` are the block's as ``get_window_size`` gives
them for this grid (each shift below its window).  Inference only: the
operators have no gradient.

Launches on CUDA tensors count in each wrapper's ``.launches``: one
wrapper, one route.
"""

from __future__ import annotations

import array
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dctseg_torch.ops import _build, library

ROUTES = ("to_windows", "windows_residual", "plain")
# vectors a lane (csrc/layernorm.cu pick_v) and channels a lane, at most
# (kMaxPerLane)
LANE_VECTORS = (1, 2, 3, 4, 6, 8, 12, 16, 24)
MAX_PER_LANE = 96
PROJ_EPS = 1e-5     # MONAI's proj_out: F.layer_norm's default eps


def plan_lanes(c: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(V, G): the row's 16-byte vectors split over G lanes, V a lane; G
    the largest power of two up to 32 that divides them.  Raises where the
    kernel has no instantiation for the width."""
    elem = torch.finfo(dtype).bits // 8
    vec = 16 // elem
    if c % vec:
        raise ValueError(f"K9 takes rows of whole 16-byte vectors; {c} "
                         f"channels of {dtype}")
    nv = c // vec
    lanes = min(32, nv & -nv)
    v = nv // lanes
    if v not in LANE_VECTORS or v * vec > MAX_PER_LANE:
        raise ValueError(f"K9 has no kernel for {c} channels of {dtype}")
    return v, lanes


# ---- plain versions: today's torch sequence ----

def window_partition(x: torch.Tensor, window) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * nW, wd * wh * ww, C), windows in (d, h, w)
    order, batch major."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.view(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, c)


def window_reverse(windows: torch.Tensor, window, dims) -> torch.Tensor:
    """The inverse of :func:`window_partition` onto (B, D, H, W, C)."""
    b, d, h, w = dims
    wd, wh, ww = window
    x = windows.view(b, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def padded(grid: Sequence[int], window: Sequence[int]) -> Tuple[int, ...]:
    """Each side of ``grid`` up to a multiple of its window."""
    return tuple(-(-n // wn) * wn for n, wn in zip(grid, window))


def layer_norm_plain(x: torch.Tensor, weight: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], eps: float
                     ) -> torch.Tensor:
    """F.layer_norm over the channels of an f32 copy, cast back."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias,
                        eps).to(x.dtype)


def layer_norm_to_windows_plain(x, weight, bias, eps, window, shift):
    """norm1, zero padding at the end of D, H and W, the roll by -shift,
    the window partition."""
    d, h, w = x.shape[1:4]
    y = layer_norm_plain(x, weight, bias, eps)
    pads = [p - n for n, p in zip((d, h, w), padded((d, h, w), window))]
    if any(pads):
        y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    if any(shift):
        y = torch.roll(y, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
    return window_partition(y, window)


def windows_residual_layer_norm_plain(windows, x, weight, bias, eps, window,
                                      shift):
    """The window reverse, the roll back, the crop, x + y in x's dtype,
    and norm2 of that sum: (x + y, norm2(x + y))."""
    b, d, h, w = x.shape[:4]
    y = window_reverse(windows, window, (b,) + padded((d, h, w), window))
    if any(shift):
        y = torch.roll(y, shifts=tuple(shift), dims=(1, 2, 3))
    x = x + y[:, :d, :h, :w]
    return x, layer_norm_plain(x, weight, bias, eps)


# ---- the kernel ----

def _check_affine(x, weight, bias):
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.shape != (x.shape[-1],)
                              or t.dtype != torch.float32
                              or t.device != x.device):
            raise ValueError(f"K9's {name} must be f32 ({x.shape[-1]},) on "
                             f"x's device; got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")


def _check_grid(x, window, shift):
    if x.dim() != 5 or len(window) != 3 or len(shift) != 3:
        raise ValueError(f"expected x (B, D, H, W, C), a window and a shift "
                         f"of three sides; got {tuple(x.shape)}, {window}, "
                         f"{shift}")
    if not all(1 <= wn and 0 <= s < wn for wn, s in zip(window, shift)):
        raise ValueError(f"each shift lies in [0, window): {window}, {shift}")


def _launch(route, x, out, out2, windows, weight, bias, eps, window, shift):
    """One K9 launch; ``out`` (and ``out2``) fresh contiguous outputs."""
    c = x.shape[-1]
    v, lanes = plan_lanes(c, x.dtype)
    rows = out.numel() // c
    if rows == 0:
        return
    if route == "plain":
        grid, window, shift = (1, 1, 1), (1, 1, 1), (0, 0, 0)
    else:
        grid = x.shape[1:4]
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    if _build.alignment(*(ptr(t) for t in (x, out, out2, windows, weight,
                                           bias))) < 16:
        raise ValueError("K9 reads and writes 16-byte vectors: its tensors "
                         "must start on 16-byte boundaries")
    args = array.array("q", (
        x.data_ptr(), ptr(windows), out.data_ptr(), ptr(out2), ptr(weight),
        ptr(bias), rows, c, ROUTES.index(route), *grid,
        *padded(grid, window), *window, *shift, _build.dtype_code(x.dtype),
        v, lanes))
    _build.check(_build.lib().dctseg_layer_norm(
        args.buffer_info()[0], eps, _build.stream_of(x)), f"K9 {route}")


def _to_windows_shape(x, window):
    b, d, h, w, c = x.shape
    dp, hp, wp = padded((d, h, w), window)
    nw = (dp // window[0]) * (hp // window[1]) * (wp // window[2])
    return (b * nw, window[0] * window[1] * window[2], c)


def _to_windows_cuda(x, weight, bias, eps, window, shift):
    x = x.contiguous()
    out = x.new_empty(_to_windows_shape(x, window))
    _launch("to_windows", x, out, None, None, weight, bias, eps, window,
            shift)
    layer_norm_to_windows.launches += 1
    return out


def _to_windows_fake(x, weight, bias, eps, window, shift):
    return x.new_empty(_to_windows_shape(x, window))


def _residual_cuda(windows, x, weight, bias, eps, window, shift):
    x, windows = x.contiguous(), windows.contiguous()
    out, out2 = torch.empty_like(x), torch.empty_like(x)
    _launch("windows_residual", x, out, out2, windows, weight, bias, eps,
            window, shift)
    windows_residual_layer_norm.launches += 1
    return out, out2


def _residual_fake(windows, x, weight, bias, eps, window, shift):
    return torch.empty_like(x), torch.empty_like(x)


def _plain_cuda(x, weight, bias, eps):
    x = x.contiguous()
    out = torch.empty_like(x)
    _launch("plain", x, out, None, None, weight, bias, eps, None, None)
    layer_norm.launches += 1
    return out


def _plain_fake(x, weight, bias, eps):
    return torch.empty_like(x)


_TO_WINDOWS_OP = library.define(
    "layer_norm_to_windows",
    "(Tensor x, Tensor? weight, Tensor? bias, float eps, int[] window, "
    "int[] shift) -> Tensor",
    cuda=_to_windows_cuda, cpu=layer_norm_to_windows_plain,
    fake=_to_windows_fake)
_RESIDUAL_OP = library.define(
    "windows_residual_layer_norm",
    "(Tensor windows, Tensor x, Tensor? weight, Tensor? bias, float eps, "
    "int[] window, int[] shift) -> (Tensor, Tensor)",
    cuda=_residual_cuda, cpu=windows_residual_layer_norm_plain,
    fake=_residual_fake)
_PLAIN_OP = library.define(
    "layer_norm",
    "(Tensor x, Tensor? weight, Tensor? bias, float eps) -> Tensor",
    cuda=_plain_cuda, cpu=layer_norm_plain, fake=_plain_fake)


def layer_norm_to_windows(x: torch.Tensor, weight: Optional[torch.Tensor],
                          bias: Optional[torch.Tensor], eps: float,
                          window: Sequence[int], shift: Sequence[int]
                          ) -> torch.Tensor:
    """K9's ``to_windows`` route: x (B, D, H, W, C) -> the (B * nW, N, C)
    windows of norm(x) over the grid padded to ``window``, rolled by
    -``shift``, zero rows in the padding."""
    _check_grid(x, window, shift)
    _check_affine(x, weight, bias)
    return library.call(_TO_WINDOWS_OP, x, weight, bias, eps, list(window),
                        list(shift))


def windows_residual_layer_norm(windows: torch.Tensor, x: torch.Tensor,
                                weight: Optional[torch.Tensor],
                                bias: Optional[torch.Tensor], eps: float,
                                window: Sequence[int], shift: Sequence[int]
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's ``windows_residual`` route: ``windows`` (B * nW, N, C) back onto
    x's (B, D, H, W, C) grid, x + y rounded once to x's dtype, and norm of
    that sum: returns (x + y, norm(x + y))."""
    _check_grid(x, window, shift)
    _check_affine(x, weight, bias)
    if windows.shape != _to_windows_shape(x, window) or \
            windows.dtype != x.dtype or windows.device != x.device:
        raise ValueError(f"windows must be {_to_windows_shape(x, window)} "
                         f"in x's dtype and device; got "
                         f"{tuple(windows.shape)} {windows.dtype}")
    return library.call(_RESIDUAL_OP, windows, x, weight, bias, eps,
                        list(window), list(shift))


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """K9's ``plain`` route: LayerNorm over the last axis of x."""
    _check_affine(x, weight, bias)
    return library.call(_PLAIN_OP, x, weight, bias, eps)


# kernel launches on CUDA tensors, one counter a route
layer_norm_to_windows.launches = 0
windows_residual_layer_norm.launches = 0
layer_norm.launches = 0
