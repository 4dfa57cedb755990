"""Space-to-depth relayout with a fused cast: the port of the TPU kernel
``dctseg/ops/pallas/relayout.py`` ``space_to_depth``.

On a CUDA tensor the wrapper launches the hand-written kernel of
``dctseg_torch/csrc/relayout.cu`` or raises; on a CPU tensor it runs the
plain PyTorch version below.  The function is a pure permutation plus a
cast, so the two are bit-identical.  Both UNet call sites run it: the
encoder's input and the half-resolution stage's input.  (The JAX model calls
the plain relayout there, because XLA fuses it into the next conv's input
gather; eager PyTorch has no such fusion, and the kernel does the cast and
the relayout in one pass where the plain version takes two.)

The gradient is the inverse relayout cast back to the input's dtype, in
plain PyTorch, as the TPU kernel's custom VJP does it in XLA.
"""

from __future__ import annotations

import torch

from dctseg_torch.ops import _build
from dctseg_torch.ops import s2d as s2dops


def space_to_depth_plain(x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``s2d.space_to_depth(x.to(out_dtype))``: the cast, then the
    relayout."""
    return s2dops.space_to_depth(x.to(out_dtype or x.dtype))


def _vector_width(x: torch.Tensor, out: torch.Tensor) -> int:
    """Output elements per thread: the widest of 8, 4, 2, 1 that divides 2C,
    moves at most 16 bytes of output and finds both tensors aligned."""
    c = x.shape[-1]
    for vec in (8, 4, 2, 1):
        if (vec * out.element_size() <= 16 and (2 * c) % vec == 0
                and x.data_ptr() % (vec * x.element_size()) == 0
                and out.data_ptr() % (vec * out.element_size()) == 0):
            return vec
    return 1


def _launch(x: torch.Tensor, out_dtype) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("the relayout kernel takes a contiguous "
                         "(N, D, H, W, C) tensor")
    n, d, h, w, c = x.shape
    out = torch.empty((n, d // 2, h // 2, w // 2, 8 * c), dtype=out_dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    if x.numel() > 0x7fffffff:
        raise ValueError(f"{tuple(x.shape)} has more elements than one "
                         "launch takes")
    vec = _vector_width(x, out)
    lib = _build.lib()
    stream = _build.stream_of(x)
    _build.check(lib.dctseg_space_to_depth(
        x.data_ptr(), out.data_ptr(), n, d, h, w, c,
        _build.dtype_code(x.dtype), _build.dtype_code(out_dtype), vec,
        stream), "space_to_depth")
    space_to_depth.launches += 1
    return out


class _SpaceToDepth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_dtype):
        ctx.in_dtype = x.dtype
        return _launch(x, out_dtype)

    @staticmethod
    def backward(ctx, g):
        return s2dops.depth_to_space(g).to(ctx.in_dtype), None


def space_to_depth(x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, D/2, H/2, W/2, 8C) in ``out_dtype`` (None keeps
    x's dtype), offset-major channels; D, H and W must be even.  On CUDA,
    ``x`` must be contiguous."""
    if x.dim() != 5 or any(s % 2 for s in x.shape[1:4]):
        raise ValueError(f"expected (N, D, H, W, C) with even D, H, W; got "
                         f"{tuple(x.shape)}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return space_to_depth_plain(x, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _build.dtype_code(x.dtype)
    _build.dtype_code(out_dtype)
    return _SpaceToDepth.apply(x, out_dtype)


space_to_depth.launches = 0   # kernel launches on CUDA tensors
