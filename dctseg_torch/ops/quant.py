"""Dynamic int8 post-training quantization of the convs (the JAX package's
``dctseg/ops/quant.py``), with its two kernels for the H100.

  * weights: symmetric per-output-channel int8 (absmax / 127), computed from
    the f32 parameters (or once, under ``Predictor(fold_params=True)``), so
    checkpoints stay f32 and ``ModelConfig(quantize=...)`` is a pure
    execution strategy;
  * activations: dynamic symmetric per-tensor int8, the scale computed on
    the card at each call (K7, ``csrc/quantize.cu``);
  * the conv: s8 x s8 -> s32, exact, dequantized as ``acc * (sx * sw[c])``
    and cast to the activation's dtype, the bias added after the cast (K6,
    ``csrc/int8conv.cu``, an implicit GEMM on the tensor cores).

The arithmetic follows JAX's op order exactly, so on the CPU the port equals
``dctseg.ops.quant.conv3d_int8`` bit for bit.  Quantization is inference
only: rounding has a zero gradient, the Trainer rejects quantized configs,
and the two operators' backward raises.

Each kernel is the operator ``torch.ops.dctseg.quantize_absmax`` /
``torch.ops.dctseg.int8_conv3d`` (``ops/library.py``): on a CUDA tensor it
launches the kernel or raises, on a CPU tensor it runs the plain PyTorch
version beside it.  ``quantize_absmax`` hands the scale back in a two-float
``stats`` tensor (amax, sx) on the card, which ``int8_conv3d`` reads there:
no host sync sits inside a quantized conv.
"""

from __future__ import annotations

import array
import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from dctseg_torch.ops import _build, library

_QMAX = 127.0

# Op classes the quantize spec can address:
#   conv3  -- 3^3 stride-1 convs (the dense s2d stages, >= 64-channel direct
#             stages and their stride-2 downsampling conv): plain "int8";
#   pw     -- pointwise (1x1x1) convs;
#   deconv -- the s2d transpose-conv upsample (a 1x1 conv on the coarse grid);
#   down   -- the stride-2 downsampling convs on the s2d view.
OP_CLASSES = ("conv3", "pw", "deconv", "down")

# Opt-in spatial gate of the small direct decoder convs
# (``layers.Conv3d(spatial_gate=True)``): below this many voxels per item
# they stay float.  0 leaves it inert, the JAX package's shipped setting.
MIN_SPATIAL_ELEMS = 0


def spatial_ok(x: torch.Tensor) -> bool:
    """True when x (NDHWC) is large enough for dynamic int8 to pay."""
    return math.prod(int(s) for s in x.shape[1:-1]) >= MIN_SPATIAL_ELEMS


def enabled(quantize: str, op: str) -> bool:
    """True when the quantize spec routes op class ``op`` through int8.

    Spec grammar: ``"none"``/empty (nothing), ``"int8"`` (conv3 only),
    ``"int8+pw+deconv"`` (conv3 plus the listed classes), ``"int8_all"``
    (every class).  Unknown tokens raise, so a misspelt spec fails instead
    of running float."""
    if op not in OP_CLASSES:
        raise ValueError(f"unknown quantize op class {op!r}; "
                         f"expected one of {OP_CLASSES}")
    if not quantize or quantize == "none":
        return False
    head, *extras = quantize.split("+")
    if head not in ("int8", "int8_all"):
        raise ValueError(f"unknown quantize spec {quantize!r}; expected "
                         "'none', 'int8[+pw][+deconv][+down]' or 'int8_all'")
    for tok in extras:
        if tok not in OP_CLASSES:
            raise ValueError(f"unknown quantize op class {tok!r} in spec "
                             f"{quantize!r}; expected one of {OP_CLASSES}")
    if head == "int8_all":
        return True
    return op == "conv3" or op in extras


def weight_scales(w: torch.Tensor) -> torch.Tensor:
    """Symmetric per-output-channel scales of a (Co, ...) weight."""
    amax = w.float().abs().amax(dim=tuple(range(1, w.dim())))
    return torch.clamp(amax, min=1e-12) / _QMAX


def quantize_symmetric(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round-half-even symmetric int8 quantization (``scale`` broadcasts)."""
    return torch.clamp(torch.round(t.float() / scale), -_QMAX, _QMAX
                       ).to(torch.int8)


def prepare_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (Co, Ci, k, k, k) float weight -> (wq, sw): the int8 weight in K6's
    layout (Co, k, k, k, Ci), contiguous, and the f32 scales (Co,)."""
    sw = weight_scales(w)
    wq = quantize_symmetric(w, sw.view(-1, *([1] * (w.dim() - 1))))
    return wq.permute(0, 2, 3, 4, 1).contiguous(), sw


def _triple(stride) -> Tuple[int, int, int]:
    if isinstance(stride, int):
        return (stride,) * 3
    stride = tuple(int(s) for s in stride)
    if len(stride) != 3:
        raise ValueError(f"expected one stride or three, got {stride}")
    return stride


def _pairs(padding) -> Tuple[Tuple[int, int], ...]:
    """int, (lo, hi), or three (lo, hi) pairs -> three (lo, hi) pairs."""
    if isinstance(padding, int):
        return ((padding, padding),) * 3
    padding = tuple(padding)
    if len(padding) == 2 and all(isinstance(p, int) for p in padding):
        return (tuple(padding),) * 3
    pairs = tuple((int(lo), int(hi)) for lo, hi in padding)
    if len(pairs) != 3:
        raise ValueError(f"expected three (lo, hi) pairs, got {padding}")
    return pairs


def out_shape(x_shape, w_shape, stride, padding) -> Tuple[int, ...]:
    """(N, D', H', W', Co) of the conv of an (N, D, H, W, Ci) input with a
    (Co, k, k, k, Ci) weight."""
    n, co, k = x_shape[0], w_shape[0], w_shape[1]
    spatial = tuple((size + lo + hi - k) // s + 1 for size, s, (lo, hi)
                    in zip(x_shape[1:4], stride, padding))
    return (n, *spatial, co)


# ---- the plain versions ----

def quantize_absmax_plain(x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xq, stats): x quantized to int8 with the per-tensor scale sx, and
    stats = [amax, sx] (float32).  A NaN in x propagates into both."""
    xf = x.float()
    amax = xf.abs().amax()
    sx = torch.clamp(amax, min=1e-12) / _QMAX
    xq = torch.clamp(torch.round(xf / sx), -_QMAX, _QMAX).to(torch.int8)
    return xq, torch.stack([amax, sx])


def int8_conv3d_plain(xq: torch.Tensor, stats: torch.Tensor,
                      wq: torch.Tensor, sw: torch.Tensor, bias, stride,
                      padding, out_dtype: torch.dtype) -> torch.Tensor:
    """K6's function in plain PyTorch: the accumulation as a float64 conv of
    the int8 values (exact: |acc| < 2^53, where float32's 2^24 would not
    hold at Ci >= 64), then JAX's dequantization order, then the bias in
    the output dtype.  NDHWC in and out; ``wq`` in K6's layout."""
    (dl, dh), (hl, hh), (wl, wh) = _pairs(padding)
    xc = F.pad(xq.permute(0, 4, 1, 2, 3).double(), (wl, wh, hl, hh, dl, dh))
    acc = F.conv3d(xc, wq.permute(0, 4, 1, 2, 3).double(),
                   stride=_triple(stride)).to(torch.int32)
    y = (acc.permute(0, 2, 3, 4, 1).float() * (stats[1] * sw)).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y.contiguous()


# ---- K7: the activation's absmax and quantize ----

THREADS = 256               # csrc/quantize.cu and csrc/int8conv.cu kThreads
H100_SMS = 132
QUANT_BLOCKS_PER_SM = 8     # 2,048 resident threads per SM
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}


def plan_quantize(numel: int, dtype: torch.dtype, aligned: int
                  ) -> Tuple[int, int]:
    """(vec, grid) of K7 on ``numel`` elements at an address aligned to
    ``aligned`` bytes: the widest of 8, 4, 2, 1 elements that reads at most
    16 bytes, divides numel and fits the address; one thread a vector up
    to QUANT_BLOCKS_PER_SM blocks per SM."""
    size = _ITEMSIZE[dtype]
    vec = next(v for v in (8, 4, 2, 1) if v * size <= 16 and numel % v == 0
               and aligned % (v * size) == 0)
    blocks = math.ceil(numel // vec / THREADS)
    return vec, max(1, min(blocks, H100_SMS * QUANT_BLOCKS_PER_SM))


def _quantize_launch(x: torch.Tensor):
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError("the quantize kernel takes a non-empty contiguous "
                         "tensor")
    code = _build.dtype_code(x.dtype)
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    stats = torch.empty(2, dtype=torch.float32, device=x.device)
    vec, grid = plan_quantize(x.numel(), x.dtype,
                              _build.alignment(x.data_ptr()))
    args = array.array("q", (x.data_ptr(), xq.data_ptr(), stats.data_ptr(),
                             x.numel(), code, vec, grid))
    _build.check(_build.lib().dctseg_quantize_absmax(
        args.buffer_info()[0], _build.stream_of(x)), "quantize_absmax")
    quantize_absmax.launches += 2
    return xq, stats


def _quantize_fake(x):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty((2,), dtype=torch.float32))


_QUANTIZE_OP = library.define(
    "quantize_absmax", "(Tensor x) -> (Tensor, Tensor)",
    cuda=_quantize_launch, cpu=quantize_absmax_plain, fake=_quantize_fake)


def quantize_absmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xq, stats): K7 on a CUDA tensor (contiguous, float32, bfloat16 or
    float16), its plain version on a CPU tensor."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {x.device}")
    return library.call(_QUANTIZE_OP, x)


quantize_absmax.launches = 0    # kernel launches on CUDA tensors (2 a call)


# ---- K6: the int8 implicit-GEMM conv ----

# csrc/int8conv.cu: the output tile (rows of M = voxels, columns of N =
# output channels), the K depth of a stage in bytes
TILE_M, TILE_N, TILE_K = 128, 64, 64


class Int8ConvPlan(NamedTuple):
    """How one K6 call runs: ``grid`` = (M tiles, N tiles) blocks, each
    gathering its tiles ``vec`` bytes at a time."""
    vec: int
    grid: Tuple[int, int]


def plan_int8_conv(x_shape, w_shape, out_spatial, aligned: int
                   ) -> Int8ConvPlan:
    """K6's launch plan for an (N, D, H, W, Ci) input, a (Co, k, k, k, Ci)
    weight and output extents (D', H', W'), both pointers aligned to
    ``aligned`` bytes: the widest of 16, 8, 4 bytes that divides Ci and the
    alignment (so that a gathered run never crosses a tap), one block per
    TILE_M x TILE_N output tile."""
    ci, co = x_shape[-1], w_shape[0]
    vec = next((v for v in (16, 8, 4) if ci % v == 0 and aligned % v == 0),
               None)
    if vec is None:
        raise ValueError(f"the int8 conv kernel takes Ci a multiple of 4 on "
                         f"4-byte aligned tensors; got Ci={ci}, "
                         f"alignment {aligned}")
    m = x_shape[0] * math.prod(out_spatial)
    return Int8ConvPlan(vec, (math.ceil(m / TILE_M), math.ceil(co / TILE_N)))


def _check_conv_args(xq, stats, wq, sw, bias, out_dtype):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError("the int8 conv takes int8 activations and weights")
    if xq.dim() != 5 or wq.dim() != 5 or wq.shape[4] != xq.shape[4] or \
            not wq.shape[1] == wq.shape[2] == wq.shape[3]:
        raise ValueError(f"expected xq (N, D, H, W, Ci) and wq (Co, k, k, k, "
                         f"Ci); got {tuple(xq.shape)} and {tuple(wq.shape)}")
    if stats.shape != (2,) or stats.dtype != torch.float32 or \
            sw.shape != (wq.shape[0],) or sw.dtype != torch.float32:
        raise ValueError("expected float32 stats (2,) and scales (Co,)")
    if bias is not None and (bias.shape != (wq.shape[0],)
                             or bias.dtype != out_dtype):
        raise ValueError(f"expected a ({wq.shape[0]},) bias of {out_dtype}")


def _conv_launch(xq, stats, wq, sw, bias, stride, padding, out_dtype):
    _check_conv_args(xq, stats, wq, sw, bias, out_dtype)
    tensors = [xq, stats, wq, sw] + ([bias] if bias is not None else [])
    if any(t.device != xq.device for t in tensors) or \
            not all(t.is_contiguous() for t in tensors):
        raise ValueError("the int8 conv kernel takes contiguous tensors on "
                         "one device")
    code = _build.dtype_code(out_dtype)
    pads = _pairs([padding[0:2], padding[2:4], padding[4:6]])
    shape = out_shape(xq.shape, wq.shape, stride, pads)
    if min(shape) < 1:
        raise ValueError(f"empty conv output {shape}")
    plan = plan_int8_conv(xq.shape, wq.shape, shape[1:4],
                          _build.alignment(xq.data_ptr(), wq.data_ptr()))
    out = torch.empty(shape, dtype=out_dtype, device=xq.device)
    args = array.array("q", (
        xq.data_ptr(), wq.data_ptr(), stats.data_ptr(), sw.data_ptr(),
        0 if bias is None else bias.data_ptr(), out.data_ptr(),
        *xq.shape, *shape[1:], wq.shape[1], *stride,
        *(lo for lo, _ in pads), code, plan.vec))
    _build.check(_build.lib().dctseg_int8_conv3d(
        args.buffer_info()[0], _build.stream_of(xq)), "int8_conv3d")
    int8_conv3d.launches += 1
    return out


def _conv_cpu(xq, stats, wq, sw, bias, stride, padding, out_dtype):
    _check_conv_args(xq, stats, wq, sw, bias, out_dtype)
    return int8_conv3d_plain(xq, stats, wq, sw, bias, stride,
                             [padding[0:2], padding[2:4], padding[4:6]],
                             out_dtype)


def _conv_fake(xq, stats, wq, sw, bias, stride, padding, out_dtype):
    pads = _pairs([padding[0:2], padding[2:4], padding[4:6]])
    return xq.new_empty(out_shape(xq.shape, wq.shape, stride, pads),
                        dtype=out_dtype)


_CONV_OP = library.define(
    "int8_conv3d",
    "(Tensor xq, Tensor stats, Tensor wq, Tensor sw, Tensor? bias, "
    "int[] stride, int[] padding, ScalarType out_dtype) -> Tensor",
    cuda=_conv_launch, cpu=_conv_cpu, fake=_conv_fake)


def int8_conv3d(xq: torch.Tensor, stats: torch.Tensor, wq: torch.Tensor,
                sw: torch.Tensor, bias, stride, padding,
                out_dtype: torch.dtype) -> torch.Tensor:
    """K6 on CUDA tensors (its plain version on CPU tensors): the int8
    conv of ``xq`` (N, D, H, W, Ci) with ``wq`` (Co, k, k, k, Ci),
    dequantized with ``stats[1] * sw`` into ``out_dtype``, plus ``bias``
    (None, or (Co,) in ``out_dtype``).  ``padding``: an int, one (lo, hi)
    pair, or a pair per spatial dim."""
    if xq.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {xq.device}")
    pads = [p for pair in _pairs(padding) for p in pair]
    return library.call(_CONV_OP, xq, stats, wq, sw, bias,
                        list(_triple(stride)), pads, out_dtype)


int8_conv3d.launches = 0        # kernel launches on CUDA tensors


# ---- the conv as the model calls it ----

def conv3d_int8_prepared(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                         stride=1, padding=1, bias=None) -> torch.Tensor:
    """The dynamically quantized conv of a float NDHWC ``x`` with a weight
    already quantized by :func:`prepare_weight`: K7, then K6, the result in
    x's dtype, ``bias`` added after the cast."""
    xq, stats = quantize_absmax(x.contiguous())
    b = None if bias is None else bias.to(x.dtype)
    return int8_conv3d(xq, stats, wq, sw, b, stride, padding, x.dtype)


def conv3d_int8(x: torch.Tensor, w: torch.Tensor, stride=1,
                padding: Sequence = ((1, 1),) * 3, bias=None) -> torch.Tensor:
    """``dctseg.ops.quant.conv3d_int8`` in the port's layouts: NDHWC ``x``,
    a float (Co, Ci, k, k, k) ``w``, the result in x's dtype (plus
    ``bias``, added after the cast as the JAX model adds it)."""
    wq, sw = prepare_weight(w)
    return conv3d_int8_prepared(x, wq, sw, stride, padding, bias)
