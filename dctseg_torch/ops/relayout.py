"""Space-to-depth relayout with a fused cast: the port of the TPU kernel
``dctseg/ops/pallas/relayout.py`` ``space_to_depth``.

The wrapper calls the operator ``torch.ops.dctseg.space_to_depth``
(``ops/library.py``).  On a CUDA tensor the operator launches the
hand-written kernel of ``dctseg_torch/csrc/relayout.cu`` or raises; on a CPU
tensor it runs the plain PyTorch version below.  The function is a pure
permutation plus a cast, so the two are bit-identical.  Both UNet call
sites run it: the encoder's input and the half-resolution stage's input.
(The JAX model calls the plain relayout there, because XLA fuses it into
the next conv's input gather; eager PyTorch has no such fusion, and the
kernel does the cast and the relayout in one pass where the plain version
takes two.)

The launch plan (:func:`plan_relayout`: the vector width and the grid) is
worked out once per shape, dtypes and alignment; then a launch is one
``ctypes`` call.  The operator's backward is the inverse relayout cast back
to the input's dtype, in plain PyTorch, as the TPU kernel's custom VJP does
it in XLA.
"""

from __future__ import annotations

import array
import math
from typing import NamedTuple

import torch

from dctseg_torch.ops import _build, library
from dctseg_torch.ops import s2d as s2dops
from dctseg_torch.ops._build import alignment

THREADS = 256           # csrc/relayout.cu kThreads
# blocks per SM at most: one thread a vector up to this many, enough
# independent loads in flight to stream from HBM on the H100
BLOCKS_PER_SM = 64
H100_SMS = 132
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}


def space_to_depth_plain(x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``s2d.space_to_depth(x.to(out_dtype))``: the cast, then the
    relayout."""
    return s2dops.space_to_depth(x.to(out_dtype or x.dtype))


class RelayoutPlan(NamedTuple):
    """How one call runs: ``grid`` blocks stride over the output ``vec``
    elements at a time."""
    vec: int
    grid: int


def plan_relayout(shape: tuple, in_dtype: torch.dtype,
                  out_dtype: torch.dtype, aligned: int) -> RelayoutPlan:
    """The launch plan for a contiguous input of ``shape`` (N, D, H, W, C)
    whose address (and the fresh output's) is a multiple of ``aligned``
    bytes (a power of two up to 32): the widest of 8, 4, 2, 1 output
    elements that divides 2C, moves at most 16 bytes of output and finds
    both tensors aligned, over a grid of one thread per vector capped at
    BLOCKS_PER_SM blocks per SM."""
    in_size, out_size = _ITEMSIZE[in_dtype], _ITEMSIZE[out_dtype]
    vec = next(v for v in (8, 4, 2, 1)
               if v * out_size <= 16 and (2 * shape[-1]) % v == 0
               and v * max(in_size, out_size) <= aligned)
    blocks = math.ceil(math.prod(shape) // vec / THREADS)
    return RelayoutPlan(vec, min(blocks, H100_SMS * BLOCKS_PER_SM))


class _Call(NamedTuple):
    """A prepared launch: the plan, the int64 arguments after the two
    pointers, and the C entry."""
    plan: RelayoutPlan
    tail: array.array
    fn: object


_calls: dict = {}      # (shape, in, out, aligned) -> _Call


def _prepare(shape, in_dtype, out_dtype, aligned) -> _Call:
    for dtype in (in_dtype, out_dtype):
        _build.dtype_code(dtype)      # TypeError on a dtype it does not take
    if math.prod(shape) > 0x7fffffff:
        raise ValueError(f"{tuple(shape)} has more elements than one "
                         "launch takes")
    plan = plan_relayout(tuple(shape), in_dtype, out_dtype, aligned)
    tail = array.array("q", (*shape, _build.dtype_code(in_dtype),
                             _build.dtype_code(out_dtype), plan.vec,
                             plan.grid))
    return _Call(plan, tail, _build.lib().dctseg_space_to_depth)


def call_key(x: torch.Tensor, out: torch.Tensor) -> tuple:
    """The key of a call on ``x`` into ``out`` in ``_calls``."""
    return (x.shape, x.dtype, out.dtype,
            alignment(x.data_ptr(), out.data_ptr()))


def _launch(x: torch.Tensor, out_dtype) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("the relayout kernel takes a contiguous "
                         "(N, D, H, W, C) tensor")
    n, d, h, w, c = x.shape
    out = torch.empty((n, d // 2, h // 2, w // 2, 8 * c), dtype=out_dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    key = call_key(x, out)
    call = _calls.get(key)
    if call is None:
        call = _calls[key] = _prepare(*key)
    args = array.array("q", (x.data_ptr(), out.data_ptr()))
    args.extend(call.tail)
    _build.check(call.fn(args.buffer_info()[0], _build.stream_of(x)),
                 "space_to_depth")
    space_to_depth.launches += 1
    return out


def _cpu(x, out_dtype):
    y = space_to_depth_plain(x, out_dtype)
    # a relayout that moves nothing (extents of 2) is a view of x; an
    # operator's output never aliases its input
    return y.clone() if y.untyped_storage().data_ptr() == \
        x.untyped_storage().data_ptr() else y


def _fake(x, out_dtype):
    n, d, h, w, c = x.shape
    return x.new_empty((n, d // 2, h // 2, w // 2, 8 * c), dtype=out_dtype)


def _setup_context(ctx, inputs, output):
    ctx.in_dtype = inputs[0].dtype


def _backward(ctx, g):
    return s2dops.depth_to_space(g).to(ctx.in_dtype), None


_OP = library.define(
    "space_to_depth", "(Tensor x, ScalarType out_dtype) -> Tensor",
    cuda=_launch, cpu=_cpu, fake=_fake, backward=_backward,
    setup_context=_setup_context)


def space_to_depth(x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, D/2, H/2, W/2, 8C) in ``out_dtype`` (None keeps
    x's dtype), offset-major channels; D, H and W must be even.  On CUDA,
    ``x`` must be contiguous and of float32, bfloat16 or float16."""
    if x.dim() != 5 or x.shape[1] % 2 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"expected (N, D, H, W, C) with even D, H, W; got "
                         f"{tuple(x.shape)}")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return library.call(_OP, x, out_dtype or x.dtype)


space_to_depth.launches = 0   # kernel launches on CUDA tensors
