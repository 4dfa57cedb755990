"""Dynamic int8 post-training quantization of the convs (the JAX package's
``dctseg/ops/quant.py``), with its two kernels for the H100.

  * weights: symmetric per-output-channel int8 (absmax / 127), computed from
    the f32 parameters (or once, under ``Predictor(fold_params=True)``), so
    checkpoints stay f32 and ``ModelConfig(quantize=...)`` is a pure
    execution strategy;
  * activations: dynamic symmetric per-tensor int8, the scale computed on
    the card at each call (K7, ``csrc/quantize.cu``): in one read of x
    where the fused norm that wrote x reported its absmax
    (``fusednorm.fused_instance_norm_act_amax``), else in one launch that
    reads x twice.  Over a mesh (``parallel.spatial.scaled``) the absmax
    slots, the fused norm's or K7's ``amax`` route's, are MAX-reduced over
    the ranks before the quantize, so the scale is the whole logical
    tensor's, as under the JAX package's GSPMD; on a D slab the conv then
    exchanges the int8 halo (:func:`conv3d_int8_prepared`);
  * the conv: s8 x s8 -> s32, exact, dequantized as ``acc * (sx * sw[c])``
    and cast to the activation's dtype, the bias added after the cast (K6,
    ``csrc/int8conv.cu``, an implicit GEMM on the tensor cores).

The arithmetic follows JAX's op order exactly, so on the CPU the port equals
``dctseg.ops.quant.conv3d_int8`` bit for bit.  Quantization is inference
only: rounding has a zero gradient, the Trainer rejects quantized configs,
and the two operators' backward raises.

Each kernel is an operator, ``torch.ops.dctseg.quantize_absmax``,
``torch.ops.dctseg.quantize_from_amax`` and ``torch.ops.dctseg.quantize_amax``
(K7's three routes) and
``torch.ops.dctseg.int8_conv3d`` (``ops/library.py``): on a CUDA tensor it
launches the kernel or raises, on a CPU tensor it runs the plain PyTorch
version beside it.  K7 hands the scale back in a two-float ``stats``
tensor (amax, sx) on the card, which ``int8_conv3d`` reads there: no host
sync sits inside a quantized conv.
"""

from __future__ import annotations

import array
import ctypes
import functools
import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from dctseg_torch.ops import _build, library
from dctseg_torch.parallel import spatial

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


def over_qmax(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division on every device, as JAX's eager op and
    K7 divide: PyTorch's CUDA kernel multiplies by the reciprocal of a
    Python-number divisor, which rounds some quotients an ulp away."""
    return t / t.new_full((), _QMAX)


def weight_scales(w: torch.Tensor) -> torch.Tensor:
    """Symmetric per-output-channel scales of a (Co, ...) weight."""
    amax = w.float().abs().amax(dim=tuple(range(1, w.dim())))
    return over_qmax(torch.clamp(amax, min=1e-12))


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

def _quantize_with(xf: torch.Tensor, amax: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    sx = over_qmax(torch.clamp(amax, min=1e-12))
    xq = torch.clamp(torch.round(xf / sx), -_QMAX, _QMAX).to(torch.int8)
    return xq, torch.stack([amax, sx])


def quantize_absmax_plain(x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xq, stats): x quantized to int8 with the per-tensor scale sx, and
    stats = [amax, sx] (float32).  A NaN in x propagates into both."""
    xf = x.float()
    return _quantize_with(xf, xf.abs().amax())


def quantize_from_amax_plain(x: torch.Tensor, amax: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_absmax_plain` of an x whose absmax is the max of
    ``amax`` (float32 slots, such as a fused norm's per-sample absmax)."""
    return _quantize_with(x.float(), amax.float().abs().amax())


def quantize_amax_plain(x: torch.Tensor) -> torch.Tensor:
    """max |x| as a one-element float32 tensor (a NaN propagates)."""
    return x.float().abs().amax().reshape(1)


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

THREADS = 256               # csrc/quantize.cu kThreads
H100_SMS = 132
QUANT_BLOCKS_PER_SM = 8     # 2,048 resident threads per SM
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
# K7's routes (csrc/quantize.cu), one launch a call each: "from_amax", one
# read of x whose absmax the fused norm that wrote it reported; "grid", one
# cooperative launch that finds the absmax itself (x read twice); "amax",
# the absmax alone, for a collective to reduce over a mesh before
# from_amax (the grid route's launch cannot hold one)
QUANT_ROUTES = ("from_amax", "grid", "amax")


class QuantPlan(NamedTuple):
    """How one K7 call runs: ``route``, ``vec`` elements a thread moves at
    a time, ``grid`` blocks."""
    route: str
    vec: int
    grid: int


def quant_width(numel: int, dtype: torch.dtype, aligned: int) -> int:
    """The widest of 8, 4, 2, 1 elements that reads at most 16 bytes,
    divides numel and fits an address aligned to ``aligned`` bytes."""
    size = _ITEMSIZE[dtype]
    return next(v for v in (8, 4, 2, 1) if v * size <= 16
                and numel % v == 0 and aligned % (v * size) == 0)


def plan_quantize(numel: int, dtype: torch.dtype, aligned: int,
                  route: str = "grid",
                  max_blocks: int = H100_SMS * QUANT_BLOCKS_PER_SM
                  ) -> QuantPlan:
    """K7's plan on ``numel`` elements at an address aligned to
    ``aligned`` bytes: :func:`quant_width`'s vectors, one thread a vector,
    at most ``max_blocks`` blocks (on the grid route, the blocks the card
    holds at once: they wait for each other)."""
    if route not in QUANT_ROUTES:
        raise ValueError(f"unknown quantize route {route!r}; expected one "
                         f"of {QUANT_ROUTES}")
    vec = quant_width(numel, dtype, aligned)
    blocks = math.ceil(numel // vec / THREADS)
    return QuantPlan(route, vec, max(1, min(blocks, max_blocks)))


_quant_workspaces: dict = {}     # (device index, stream) -> int32 [3]
_quant_coresident: dict = {}     # (device index, dtype code, vec) -> blocks
# the int64 arguments of csrc/quantize.cu dctseg_quantize, in order
QUANT_ARGS = ("x", "xq", "stats", "numel", "dtype", "vec", "grid", "route",
              "amax", "slots", "workspace")


def quant_coresident(device: int, dtype: torch.dtype, vec: int) -> int:
    """The blocks of the grid route's kernel that CUDA device ``device``
    holds at once, for ``dtype`` at ``vec``: an occupancy query, once per
    device, dtype and width."""
    key = (device, _build.dtype_code(dtype), vec)
    found = _quant_coresident.get(key)
    if found is None:
        blocks = ctypes.c_int(0)
        _build.check(_build.lib().dctseg_quantize_coresident(
            key[1], vec, ctypes.byref(blocks)), "quantize occupancy")
        found = _quant_coresident[key] = blocks.value
    return found


def quantize_args(plan: QuantPlan, x: int, xq: int, stats: int, numel: int,
                  dtype: torch.dtype, amax: int, slots: int,
                  workspace: int) -> array.array:
    """K7's int64 arguments (:data:`QUANT_ARGS`) for a call of ``plan``:
    the addresses of x, xq and stats (route amax: 0, and its one-slot
    output), x's size and dtype, the plan, the absmax slots (route
    from_amax) and the workspace (routes grid and amax; 0 elsewhere).
    Nothing in them changes between two calls on the same tensors, so a
    CUDA graph may capture a call."""
    return array.array("q", (
        x, xq, stats, numel, _build.dtype_code(dtype), plan.vec, plan.grid,
        QUANT_ROUTES.index(plan.route), amax, slots, workspace))


def _quantize_launch(x: torch.Tensor, amax: torch.Tensor | None = None,
                     route: str | None = None):
    """K7 on a CUDA tensor: the from_amax route where ``amax`` is given,
    else the grid route, or the amax route where ``route`` says so (then
    only x's absmax, a float32 (1,) tensor, is returned)."""
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError("the quantize kernel takes a non-empty contiguous "
                         "tensor")
    if amax is not None and (amax.dtype != torch.float32 or amax.dim() != 1
                             or amax.numel() == 0
                             or amax.device != x.device
                             or not amax.is_contiguous()):
        raise ValueError("amax must be a non-empty contiguous float32 "
                         "vector on x's device")
    _build.dtype_code(x.dtype)   # refuses a dtype K7 does not take
    route = route or ("from_amax" if amax is not None else "grid")
    aligned = _build.alignment(x.data_ptr())
    device, stream = x.get_device(), _build.stream_of(x)
    max_blocks = H100_SMS * QUANT_BLOCKS_PER_SM
    ws = 0
    if route != "from_amax":
        if route == "grid":
            max_blocks = quant_coresident(
                device, x.dtype, quant_width(x.numel(), x.dtype, aligned))
        cache = _build.workspaces(_quant_workspaces)
        found = cache.get((device, stream))
        if found is None:
            _build.refuse_in_capture("making the quantize workspace")
            # zeroed once; each call leaves its words at zero but the
            # generation, which counts up
            found = cache[device, stream] = torch.zeros(
                3, dtype=torch.int32, device=x.device)
        ws = found.data_ptr()
    plan = plan_quantize(x.numel(), x.dtype, aligned, route, max_blocks)
    xq = (None if route == "amax"
          else torch.empty(x.shape, dtype=torch.int8, device=x.device))
    stats = torch.empty(1 if route == "amax" else 2, dtype=torch.float32,
                        device=x.device)
    args = quantize_args(plan, x.data_ptr(), 0 if xq is None
                         else xq.data_ptr(), stats.data_ptr(),
                         x.numel(), x.dtype,
                         0 if amax is None else amax.data_ptr(),
                         0 if amax is None else amax.numel(), ws)
    _build.check(_build.lib().dctseg_quantize(args.buffer_info()[0], stream),
                 "quantize")
    {"from_amax": quantize_from_amax, "grid": quantize_absmax,
     "amax": quantize_amax}[route].launches += 1
    return stats if xq is None else (xq, stats)


def _amax_launch(x: torch.Tensor) -> torch.Tensor:
    return _quantize_launch(x, route="amax")


def _quantize_fake(x, amax=None):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty((2,), dtype=torch.float32))


def _amax_fake(x):
    return x.new_empty((1,), dtype=torch.float32)


_QUANTIZE_OP = library.define(
    "quantize_absmax", "(Tensor x) -> (Tensor, Tensor)",
    cuda=_quantize_launch, cpu=quantize_absmax_plain, fake=_quantize_fake)
_FROM_AMAX_OP = library.define(
    "quantize_from_amax", "(Tensor x, Tensor amax) -> (Tensor, Tensor)",
    cuda=_quantize_launch, cpu=quantize_from_amax_plain,
    fake=_quantize_fake)
_AMAX_OP = library.define(
    "quantize_amax", "(Tensor x) -> Tensor", cuda=_amax_launch,
    cpu=quantize_amax_plain, fake=_amax_fake)


def _check_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {x.device}")


def quantize_absmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xq, stats): K7's grid route on a CUDA tensor (contiguous, float32,
    bfloat16 or float16), its plain version on a CPU tensor."""
    _check_device(x)
    return library.call(_QUANTIZE_OP, x)


def quantize_from_amax(x: torch.Tensor, amax: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xq, stats) of an x whose absmax is the max of the float32 slots
    ``amax`` (the per-sample absmax the fused norm reports of its output):
    K7's from_amax route on a CUDA tensor, one read of x; the plain version
    on a CPU tensor."""
    _check_device(x)
    return library.call(_FROM_AMAX_OP, x, amax)


def quantize_amax(x: torch.Tensor) -> torch.Tensor:
    """max |x| as a float32 (1,) tensor on x's device, the slot a mesh
    reduces before :func:`quantize_from_amax`: K7's amax route on a CUDA
    tensor (one read of x, one launch), the plain version on a CPU
    tensor."""
    _check_device(x)
    return library.call(_AMAX_OP, x)


quantize_absmax.launches = 0    # grid-route launches on CUDA tensors
quantize_from_amax.launches = 0   # from_amax-route launches
quantize_amax.launches = 0      # amax-route launches


# ---- K6: the int8 implicit-GEMM conv ----

# csrc/int8conv.cu, route "mma_sync": the output tile (rows of M = voxels,
# columns of N = output channels), the K depth of a stage in bytes
TILE_M, TILE_N, TILE_K = 128, 64, 64
# route "tma": the wgmma N widths it instantiates (Co is rounded up to one,
# at most 256 a tile), the bytes of K a stage holds, the dynamic shared
# memory a block may take, the slack that aligns the ring to the 128-byte
# swizzle's 1,024-byte atom, the bytes of a stage's two mbarriers, and the
# deepest ring
TMA_WIDTHS = (32, 64, 128, 256)
STAGE_K = 128
SMEM_BYTES = 232_448
SMEM_ALIGN = 1024
BARRIER_BYTES = 16
MAX_STAGES = 12
TMA_MAX_BOX = 256           # elements a TMA box spans along one dim
TMA_MAX_STRIDE = 8          # TMA's largest element stride
ROUTES = ("mma_sync", "tma")


class Int8ConvPlan(NamedTuple):
    """How one K6 call runs.

    ``route`` "tma": ``grid`` = (blocks,), persistent, walking ``tiles``
    output tiles of ``block`` (z, y, x) output voxels by ``bn`` channels,
    ``m_sub`` m64 blocks per consumer warpgroup (the tile is 128 * m_sub
    voxels); K in units of one tap x ``chunk`` channel bytes, ``group``
    units a stage, in a ring of ``stages``.  Route "mma_sync":
    ``grid`` = (M tiles, N tiles) blocks, each gathering its tiles ``vec``
    bytes at a time."""
    route: str
    grid: Tuple[int, ...]
    vec: int = 0
    tiles: int = 0
    block: Tuple[int, int, int] = (0, 0, 0)
    chunk: int = 0
    bn: int = 0
    m_sub: int = 0
    group: int = 0
    stages: int = 0

    def stage_bytes(self) -> int:
        """Shared memory of one stage of the tma ring: the A and B boxes
        of its units."""
        return (128 * self.m_sub + self.bn) * self.chunk * self.group

    def smem_bytes(self) -> int:
        """Dynamic shared memory of a tma block."""
        return SMEM_ALIGN + self.stages * (self.stage_bytes()
                                           + BARRIER_BYTES)


def tma_block(out_spatial, stride, k: int, voxels: int
              ) -> Tuple[int, int, int]:
    """The (z, y, x) output block of one M tile: powers of two of
    ``voxels`` in all, each spanning at most TMA_MAX_BOX input elements at
    the conv's stride; the block that pads the output least, then whose
    receptive field (k - 1 wider per dim) is smallest, then the widest
    along x, then along y."""
    best = None
    log2 = voxels.bit_length() - 1
    for ez in range(log2 + 1):
        for ey in range(log2 + 1 - ez):
            block = (1 << ez, 1 << ey, 1 << (log2 - ez - ey))
            if any(b * s > TMA_MAX_BOX for b, s in zip(block, stride)):
                continue
            padded = math.prod(math.ceil(o / b) * b
                               for o, b in zip(out_spatial, block))
            halo = math.prod(b + k - 1 for b in block)
            key = (padded, halo, -block[2], -block[1])
            if best is None or key < best[0]:
                best = (key, block)
    return best[1]


def plan_tma(x_shape, w_shape, out_spatial, stride) -> Int8ConvPlan:
    """K6's tma plan (csrc/int8conv.cu): BN = Co rounded up to a wgmma
    width (Co tiles of 256 past it); two m64 blocks per consumer
    warpgroup below BN = 256, one at it; chunks of the widest of 128, 64,
    32 channel bytes that divides Ci (32 where none does: TMA zero-fills
    the chunk past Ci), STAGE_K bytes of K a stage; as deep a ring as
    shared memory holds; one persistent block per SM, or one per tile
    where there are fewer."""
    n, ci, co, k = x_shape[0], x_shape[-1], w_shape[0], w_shape[1]
    bn = next((w for w in TMA_WIDTHS if w >= co), TMA_WIDTHS[-1])
    m_sub = 2 if bn <= 128 else 1
    block = tma_block(out_spatial, stride, k, 128 * m_sub)
    chunk = next((c for c in (128, 64, 32) if ci % c == 0), 32)
    plan = Int8ConvPlan("tma", (1,), block=block, chunk=chunk, bn=bn,
                        m_sub=m_sub, group=STAGE_K // chunk)
    stages = min(MAX_STAGES, (SMEM_BYTES - SMEM_ALIGN)
                 // (plan.stage_bytes() + BARRIER_BYTES))
    tiles = n * math.ceil(co / bn) * math.prod(
        math.ceil(o / b) for o, b in zip(out_spatial, block))
    return plan._replace(grid=(min(tiles, H100_SMS),), tiles=tiles,
                         stages=stages)


def plan_mma_sync(x_shape, w_shape, out_spatial, aligned: int
                  ) -> Int8ConvPlan:
    """K6's mma_sync plan: the widest of 16, 8, 4 bytes that divides Ci
    and the alignment (so that a gathered run never crosses a tap), one
    block per TILE_M x TILE_N output tile."""
    ci, co = x_shape[-1], w_shape[0]
    vec = next((v for v in (16, 8, 4) if ci % v == 0 and aligned % v == 0),
               None)
    if vec is None:
        raise ValueError(f"the int8 conv kernel takes Ci a multiple of 4 on "
                         f"4-byte aligned tensors; got Ci={ci}, "
                         f"alignment {aligned}")
    m = x_shape[0] * math.prod(out_spatial)
    return Int8ConvPlan("mma_sync", (math.ceil(m / TILE_M),
                                     math.ceil(co / TILE_N)), vec=vec)


@functools.lru_cache(maxsize=256)
def plan_int8_conv(x_shape, w_shape, out_spatial, stride, aligned: int
                   ) -> Int8ConvPlan:
    """K6's launch plan for an (N, D, H, W, Ci) input, a (Co, k, k, k, Ci)
    weight, output extents (D', H', W') and the conv's stride, both
    pointers aligned to ``aligned`` bytes.  The route is the shape's: tma
    where Ci is a multiple of 16 (TMA's 16-byte global strides) on
    16-byte aligned pointers at strides up to TMA_MAX_STRIDE, mma_sync
    otherwise."""
    if x_shape[-1] % 16 == 0 and aligned % 16 == 0 and \
            max(stride) <= TMA_MAX_STRIDE:
        return plan_tma(tuple(x_shape), tuple(w_shape), tuple(out_spatial),
                        tuple(stride))
    return plan_mma_sync(x_shape, w_shape, out_spatial, aligned)


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


def conv_args(xq, stats, wq, sw, bias, stride, pads, out_dtype,
              plan: Int8ConvPlan):
    """(out, args): the output K6 writes and its int64 argument array
    (``dctseg_int8_conv3d`` in csrc/int8conv.cu) for one call on
    ``plan``."""
    shape = out_shape(xq.shape, wq.shape, stride, pads)
    out = torch.empty(shape, dtype=out_dtype, device=xq.device)
    args = array.array("q", (
        xq.data_ptr(), wq.data_ptr(), stats.data_ptr(), sw.data_ptr(),
        0 if bias is None else bias.data_ptr(), out.data_ptr(),
        *xq.shape, *shape[1:], wq.shape[1], *stride,
        *(lo for lo, _ in pads), _build.dtype_code(out_dtype),
        ROUTES.index(plan.route), plan.vec, *plan.block, plan.chunk,
        plan.bn, plan.m_sub, plan.group, plan.stages,
        plan.grid[0] if plan.route == "tma" else 0))
    return out, args


def _conv_launch(xq, stats, wq, sw, bias, stride, padding, out_dtype):
    _check_conv_args(xq, stats, wq, sw, bias, out_dtype)
    tensors = [xq, stats, wq, sw] + ([bias] if bias is not None else [])
    if any(t.device != xq.device for t in tensors) or \
            not all(t.is_contiguous() for t in tensors):
        raise ValueError("the int8 conv kernel takes contiguous tensors on "
                         "one device")
    pads = _pairs([padding[0:2], padding[2:4], padding[4:6]])
    shape = out_shape(xq.shape, wq.shape, stride, pads)
    if min(shape) < 1:
        raise ValueError(f"empty conv output {shape}")
    plan = plan_int8_conv(tuple(xq.shape), tuple(wq.shape), shape[1:4],
                          tuple(stride),
                          _build.alignment(xq.data_ptr(), wq.data_ptr()))
    out, args = conv_args(xq, stats, wq, sw, bias, stride, pads, out_dtype,
                          plan)
    _build.check(_build.lib().dctseg_int8_conv3d(
        args.buffer_info()[0], _build.stream_of(xq)), "int8_conv3d")
    int8_conv3d.routes[plan.route] += 1
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
int8_conv3d.routes = dict.fromkeys(ROUTES, 0)   # the launches by route


# ---- the conv as the model calls it ----

def quantize_input(x: torch.Tensor, amax: torch.Tensor | None = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xq, stats) of an int8 conv's float input: K7's from_amax route
    where ``amax`` (x's per-sample absmax, as the fused norm that wrote x
    reports it) is given, else its grid route.  Under a scale group
    (``parallel.spatial.scaled``) x is this rank's part of the tensor:
    its slots (``amax``, or K7's amax route) are MAX-reduced over the
    group, then the from_amax route quantizes x with the whole tensor's
    scale."""
    x = x.contiguous()
    group = spatial.scale_group()
    if group is None:
        if spatial.active() is not None:
            raise RuntimeError("an int8 conv on a D slab takes its scale "
                               "over the mesh: run it under "
                               "parallel.spatial.scaled(mesh.group)")
        return (quantize_absmax(x) if amax is None
                else quantize_from_amax(x, amax))
    slots = quantize_amax(x) if amax is None else amax
    return quantize_from_amax(x, spatial.reduce_amax(slots, group))


def conv3d_int8_prepared(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                         stride=1, padding=1, bias=None,
                         amax: torch.Tensor | None = None,
                         quantized: tuple | None = None) -> torch.Tensor:
    """The dynamically quantized conv of a float NDHWC ``x`` with a weight
    already quantized by :func:`prepare_weight`: K7 (:func:`quantize_input`
    with ``amax``), then K6, the result in x's dtype, ``bias`` added after
    the cast.  ``quantized``: x's (xq, stats) where another conv on the same
    x already computed them (no K7 then).  On a D slab (under
    ``parallel.spatial.sharded``) the int8 xq exchanges the halo the conv
    needs, and K6 pads D by it alone."""
    xq, stats = (quantize_input(x, amax) if quantized is None
                 else quantized)
    b = None if bias is None else bias.to(x.dtype)
    shard = spatial.active()
    if shard is not None:
        (dlo, _), hp, wp = _pairs(padding)
        xq = spatial.conv_halo(xq, shard, wq.shape[1], _triple(stride)[0],
                               dlo)
        padding = ((0, 0), hp, wp)
    return int8_conv3d(xq, stats, wq, sw, b, stride, padding, x.dtype)


def conv3d_int8(x: torch.Tensor, w: torch.Tensor, stride=1,
                padding: Sequence = ((1, 1),) * 3, bias=None) -> torch.Tensor:
    """``dctseg.ops.quant.conv3d_int8`` in the port's layouts: NDHWC ``x``,
    a float (Co, Ci, k, k, k) ``w``, the result in x's dtype (plus
    ``bias``, added after the cast as the JAX model adds it)."""
    wq, sw = prepare_weight(w)
    return conv3d_int8_prepared(x, wq, sw, stride, padding, bias)
