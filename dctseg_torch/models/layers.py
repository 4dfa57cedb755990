"""Building blocks with the JAX package's semantics (``dctseg/models/
layers.py``), on NDHWC activations.

Parameters are held in f32 in PyTorch's own layouts (conv (O, I, k, k, k),
transpose conv (I, O, k, k, k), linear (O, I)) and cast to the compute dtype
at each call, as flax's ``param_dtype=f32, dtype=bf16`` does.  The convs run
on the permuted NCDHW view of the NDHWC activation -- channels_last_3d
memory, which cuDNN takes as it is -- and hand back NDHWC.

Init follows ``torch_kernel_init``: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with
fan_in = in_channels * prod(kernel) (for the transpose conv too, as flax
counts it), zero biases.  ``bias=False`` gives a conv without one (MONAI's
block convs): its ``bias`` is None, and ``prepare`` hands None on.

Folding: the convs derive tensors from their parameters at every call (the
cast to the compute dtype, the s2d weight transforms, the int8 weights).
Each is a :class:`WeightPrep`, whose ``prepare(kind)`` computes them;
:func:`fold` computes them all once, and inside :func:`folded` the convs
take them from that cache (``Predictor(fold_params=True)``).  The cache
holds the same tensors a call would compute, so a folded forward equals the
unfolded one bit for bit.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

from dctseg_torch.ops import quant
from dctseg_torch.ops.norms import instance_norm, layer_norm, leaky_relu
from dctseg_torch.parallel import spatial


def _uniform_(t: torch.Tensor, fan_in: int, generator) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


class Dropout:
    """Dropout with flax's ``nn.Dropout`` semantics: keep each element (or
    each slice, where ``mask_shape`` broadcasts) with probability 1 - rate
    and scale what it keeps by 1 / (1 - rate).  Masks are drawn from
    ``generator`` (``torch.rand(..) < keep``), so one generator seed gives
    one sequence of masks.  ``active=False`` is the eval forward: identity.
    """

    def __init__(self, generator: torch.Generator | None = None,
                 active: bool = True):
        self.generator, self.active = generator, active

    def __call__(self, x: torch.Tensor, rate: float,
                 mask_shape=None) -> torch.Tensor:
        if not self.active or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(tuple(mask_shape or x.shape), device=x.device,
                          generator=self.generator) < keep
        return torch.where(mask, x / keep, x.new_zeros(()))


NO_DROPOUT = Dropout(active=False)


_FOLDED: contextvars.ContextVar = contextvars.ContextVar("dctseg_folded",
                                                        default=None)


class WeightPrep:
    """A module whose forward derives tensors from its parameters:
    ``prepare(kind)`` computes them for ``kind`` ("float" or "int8"),
    ``fold_kinds()`` names the kinds its forward can take."""

    def fold_kinds(self) -> tuple:
        return ("float",)

    def prepare(self, kind: str) -> tuple:
        raise NotImplementedError

    def prepared(self, kind: str) -> tuple:
        """The tensors of ``kind``: from the active fold, or computed."""
        cache = _FOLDED.get()
        hit = None if cache is None else cache.get((self, kind))
        return self.prepare(kind) if hit is None else hit


def fold(model: nn.Module) -> dict:
    """Every WeightPrep's tensors of ``model``, computed once (normal
    tensors without autograd history, whatever mode the caller is in)."""
    with torch.inference_mode(False), torch.no_grad():
        return {(m, kind): m.prepare(kind) for m in model.modules()
                if isinstance(m, WeightPrep) for kind in m.fold_kinds()}


@contextlib.contextmanager
def folded(cache):
    """Run the enclosed forward on the tensors of ``cache`` (a :func:`fold`
    result; None computes them at each call)."""
    token = _FOLDED.set(cache)
    try:
        yield
    finally:
        _FOLDED.reset(token)


class Conv3d(WeightPrep, nn.Module):
    """3D convolution on NDHWC with torch-style explicit padding.

    ``quantize`` (the ModelConfig spec) runs it int8 (``ops/quant.py``) by
    the JAX package's rule (``dctseg/models/layers.py:72-78``): at least 64
    input channels, and k=3 with the conv3 class or k=1 with the pw class;
    with ``spatial_gate`` also only when ``quant.spatial_ok(x)``.  The
    parameters are the same either way."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dtype: torch.dtype = torch.float32, generator=None,
                 quantize: str = "none", spatial_gate: bool = False,
                 bias: bool = True):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               k, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        _uniform_(self.weight, in_channels * k ** 3, generator)
        self.spatial_gate = spatial_gate
        self.int8 = in_channels >= 64 and (
            (k == 3 and quant.enabled(quantize, "conv3"))
            or (k == 1 and quant.enabled(quantize, "pw")))

    def fold_kinds(self) -> tuple:
        if not self.int8:
            return ("float",)
        return ("int8", "float") if self.spatial_gate else ("int8",)

    def prepare(self, kind: str) -> tuple:
        b = None if self.bias is None else self.bias.to(self.dtype)
        if kind == "int8":
            return (*quant.prepare_weight(self.weight), b)
        return self.weight.to(self.dtype), b

    def runs_int8(self, x: torch.Tensor) -> bool:
        """True when the forward on ``x`` runs int8."""
        return self.int8 and (not self.spatial_gate or quant.spatial_ok(x))

    def forward(self, x: torch.Tensor, amax: torch.Tensor | None = None,
                quantized: tuple | None = None) -> torch.Tensor:
        """``amax``: x's per-sample absmax where a fused norm wrote x (the
        int8 conv then quantizes x in one read), else None.  ``quantized``:
        the (xq, stats) of x in this conv's dtype, where convs that read the
        same x share one quantization (:func:`shared_input`)."""
        if x.dtype != self.dtype:
            x, amax = x.to(self.dtype), None   # amax is of the uncast x
        if self.runs_int8(x):
            wq, sw, b = self.prepared("int8")
            return quant.conv3d_int8_prepared(x, wq, sw, self.stride,
                                              self.padding, b, amax,
                                              quantized)
        w, b = self.prepared("float")
        if spatial.active() is not None:
            # a D slab: the halo first (parallel/spatial.py)
            return spatial.conv3d(x, w, b, self.stride,
                                  (self.padding, self.padding))
        return ndhwc(F.conv3d(ncdhw(x), w, b, self.stride, self.padding))


def shared_input(convs, x: torch.Tensor) -> list:
    """Each of ``convs`` (Conv3d) on the same ``x``: where all of them run
    int8 in one dtype, x is quantized once (K7) for all of them."""
    dtype = convs[0].dtype
    if all(c.dtype == dtype and c.runs_int8(x) for c in convs):
        quantized = quant.quantize_input(x.to(dtype))
        return [c(x, quantized=quantized) for c in convs]
    return [c(x) for c in convs]


class ConvTranspose3d(WeightPrep, nn.Module):
    """``nn.ConvTranspose3d(k=2, s=2)`` upsampling on NDHWC."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 2, stride: int = 2,
                 dtype: torch.dtype = torch.float32, generator=None,
                 bias: bool = True):
        super().__init__()
        k = kernel_size
        self.stride, self.dtype = stride, dtype
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels,
                                               k, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        _uniform_(self.weight, in_channels * k ** 3, generator)

    def prepare(self, kind: str) -> tuple:
        return self.weight.to(self.dtype), (
            None if self.bias is None else self.bias.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.prepared("float")
        y = F.conv_transpose3d(ncdhw(x.to(self.dtype)), w, b, self.stride)
        return ndhwc(y)


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        _uniform_(self.weight, in_features, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor, rows: slice = slice(None)
                ) -> torch.Tensor:
        """``rows`` selects output features (a slice of the weight rows)."""
        b = self.bias[rows].to(self.dtype) if self.bias is not None else None
        return F.linear(x.to(self.dtype), self.weight[rows].to(self.dtype), b)


class LayerNorm(nn.Module):
    """Affine LayerNorm over the last axis, computed in f32."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class InstanceNormAct(nn.Module):
    """InstanceNorm3d (no affine) + LeakyReLU(0.01), plain ops."""

    def __init__(self, eps: float = 1e-5, negative_slope: float = 0.01):
        super().__init__()
        self.eps, self.negative_slope = eps, negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(instance_norm(x, self.eps), self.negative_slope)
