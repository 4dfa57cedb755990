"""Space-to-depth execution strategy for the full- and half-resolution UNet
stages (the JAX package's ``dctseg/ops/s2d.py``), in the port's layouts.

Every function here is an exact weight-space transform: the parameters keep
their reference shapes (conv (O, I, k, k, k), transpose conv (I, O, 2, 2, 2))
and the equivalent coarse-grid kernels are built at each call.  The
transforms are gathers through index tables made once per shape from the
JAX package's one-hot axis tables, so they copy weights and never round
them (a matmul with a one-hot table would, under TF32).

Layout: s2d channel index = offset * C + c, offset = (oz * 2 + oy) * 2 + ox
(offset-major), block 2, odd fine kernels.  Activations are NDHWC; convs run
on the permuted NCDHW view, as in ``models/layers.py``.

Derivation of the 3^3 stride-1 SAME conv: with fine output f = 2 Co + o and
fine tap k, the input position 2 Co + (o + k - 1) is 2 (Co + K - 1) + i with
K = floor((o + k - 1) / 2) + 1 in {0, 1, 2} and i in {0, 1}: a coarse 3^3
SAME conv whose kernel W'[o*C+co, i*C+ci, K] = W[co, ci, k] for
k = 2K + i - o - 1 (zero where k is out of range: W' is 1/8 dense).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from dctseg_torch.ops import quant
from dctseg_torch.ops.norms import normalize
from dctseg_torch.parallel import spatial

B = 2          # block size
B3 = B ** 3


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, D/2, H/2, W/2, 8C), offset-major channels."""
    n, d, h, w, c = x.shape
    y = x.reshape(n, d // B, B, h // B, B, w // B, B, c)
    y = y.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return y.reshape(n, d // B, h // B, w // B, B3 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    n, d, h, w, cb = x.shape
    c = cb // B3
    y = x.reshape(n, d, h, w, B, B, B, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return y.reshape(n, d * B, h * B, w * B, c)


def _axis_table(kk: int) -> np.ndarray:
    """One-hot S[K, i, o, k]: coarse tap K picks fine tap k for (in-offset i,
    out-offset o).  kk = fine kernel size (odd)."""
    pad = (kk - 1) // 2
    s = np.zeros((kk, B, B, kk), np.float64)
    for o in range(B):
        for k in range(kk):
            t = o + k - pad              # fine input offset from 2*Co
            K = t // 2 + pad             # coarse tap index
            i = t - 2 * (t // 2)         # input offset within block
            if 0 <= K < kk:
                s[K, i, o, k] = 1.0
    return s


def _fine_table() -> np.ndarray:
    """S[p, o, k] = 1 where p = o + k: the 4^3 stride-2 window tap p of
    output offset o reads fine tap k."""
    s = np.zeros((4, B, 3), np.float64)
    for o in range(B):
        for k in range(3):
            s[o + k, o, k] = 1.0
    return s


def _down_table() -> np.ndarray:
    """S[K, i, k] of the stride-2 pad-1 conv: output offset 0 only."""
    s = np.zeros((2, B, 3), np.float64)
    for k in range(3):
        t = k - 1
        s[t // 2 + 1, t - 2 * (t // 2), k] = 1.0
    return s


@functools.lru_cache(maxsize=None)
def _index_table(kind: str, shape: Tuple[int, ...]) -> np.ndarray:
    """Flat indices into a weight of ``shape`` (port layout) that build the
    transformed kernel, -1 where it is zero (7/8 of a dense conv kernel).
    Made by running the one-hot contraction on the codes 1..n of the
    weight's elements (exact integers in float64)."""
    codes = np.arange(1, int(np.prod(shape)) + 1, dtype=np.float64
                      ).reshape(shape)
    if kind == "conv":
        co, ci, kk = shape[0], shape[1], shape[2]
        s = _axis_table(kk)
        t = np.einsum("aiok,bjpm,clrn,edkmn->opreijldabc", s, s, s, codes,
                      optimize=True)
        t = t.reshape(B3 * co, B3 * ci, kk, kk, kk)
    elif kind == "fine":
        co, ci = shape[:2]
        s = _fine_table()
        t = np.einsum("aok,bpm,cqn,edkmn->opqedabc", s, s, s, codes,
                      optimize=True)
        t = t.reshape(B3 * co, ci, 4, 4, 4)
    elif kind == "down":
        co, ci = shape[:2]
        s = _down_table()
        t = np.einsum("aik,bjm,cln,edkmn->eijldabc", s, s, s, codes,
                      optimize=True)
        t = t.reshape(co, B3 * ci, 2, 2, 2)
    else:
        raise ValueError(f"unknown transform {kind!r}")
    return np.ascontiguousarray(t.astype(np.int64) - 1)


_DEVICE_TABLES: dict = {}


def _gather(w: torch.Tensor, kind: str) -> torch.Tensor:
    """The transformed kernel: its nonzero entries gathered from ``w`` and
    put into zeros.  The backward is a scatter-add over at most 8 copies
    of each weight (never over the zero entries, which would all pile onto
    one address)."""
    key = (kind, tuple(w.shape), w.device)
    entry = _DEVICE_TABLES.get(key)
    if entry is None:
        table = _index_table(kind, tuple(w.shape))
        dst = np.flatnonzero(table >= 0)
        # normal tensors even when the first call runs under
        # inference_mode, so that training can use the cached tables
        with torch.inference_mode(False):
            entry = (torch.from_numpy(dst).to(w.device),
                     torch.from_numpy(table.reshape(-1)[dst]).to(w.device),
                     table.shape)
        # under torch.export the tables are fake: they become constants of
        # the exported program and must not serve later eager calls
        if not is_fake(entry[0]):
            _DEVICE_TABLES[key] = entry
    dst, src, shape = entry
    out = w.new_zeros(int(np.prod(shape)))
    return out.index_put((dst,), w.reshape(-1)[src]).reshape(shape)


def conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) stride-1 SAME fine conv -> (8Co, 8Ci, 3, 3, 3)
    coarse conv."""
    return _gather(w, "conv")


def fine_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) stride-1 SAME fine conv -> (8Co, Ci, 4, 4, 4)
    stride-2 conv on the fine input producing the s2d view: output coarse
    voxel Y, offset o reads fine window 2Y - 1 + p (p in 0..3, padding
    (1, 2)); tap W4[o*Co+co, ci, p] = W[co, ci, p - o] (zero outside
    0 <= p - o <= 2)."""
    if w.shape[2:] != (3, 3, 3):
        raise ValueError(f"fine_conv_kernel takes a 3^3 kernel; got "
                         f"{tuple(w.shape)}")
    return _gather(w, "fine")


def down_kernel(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) stride-2 pad-1 fine conv -> (Co, 8Ci, 2, 2, 2)
    coarse conv with per-axis padding (1, 0); its output lies on the plain
    coarse grid."""
    if w.shape[2:] != (3, 3, 3):
        raise ValueError(f"down_kernel takes a 3^3 kernel; got "
                         f"{tuple(w.shape)}")
    return _gather(w, "down")


def pointwise_kernel(w: torch.Tensor,
                     group_sizes: Sequence[int]) -> torch.Tensor:
    """Fine 1x1 conv on a channel concat of s2d tensors -> coarse 1x1.

    ``group_sizes``: the fine channel count of each concatenated s2d group
    (the input layout is [g0*8 ch, g1*8 ch, ...], each group offset-major);
    their sum is w's input dim.  Block-diagonal per group; the output is
    offset-major 8Co."""
    co, cin = w.shape[:2]
    if sum(group_sizes) != cin:
        raise ValueError(f"group sizes {tuple(group_sizes)} do not add up "
                         f"to {cin} input channels")
    w2 = w.reshape(co, cin)
    blocks, base = [], 0
    for g in group_sizes:
        blk = w2[:, base:base + g]
        blocks.append(torch.block_diag(*([blk] * B3)))   # (8Co, 8g)
        base += g
    return torch.cat(blocks, dim=1).reshape(B3 * co, B3 * cin, 1, 1, 1)


def deconv_kernel(w: torch.Tensor) -> torch.Tensor:
    """(Ci, Co, 2, 2, 2) stride-2 transpose conv -> (8Co, Ci, 1, 1, 1)
    coarse 1x1 conv producing the s2d view.  ``F.conv_transpose3d`` with
    kernel == stride reads tap o for fine output 2 Co + o, so -- unlike the
    JAX transform, whose flax kernel is stored flipped -- no flip here."""
    ci, co = w.shape[:2]
    if w.shape[2:] != (B, B, B):
        raise ValueError(f"deconv_kernel takes a 2^3 kernel; got "
                         f"{tuple(w.shape)}")
    t = w.permute(2, 3, 4, 1, 0).reshape(B3 * co, ci)
    return t.reshape(B3 * co, ci, 1, 1, 1)


def tile_bias(bias: torch.Tensor) -> torch.Tensor:
    """Fine per-channel bias -> s2d channels (offset-major: a plain tile)."""
    return bias.repeat(B3)


def instance_norm_s2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm with statistics per fine channel: reduce over the coarse
    spatial dims and the block offsets (equals ``instance_norm`` on the
    depth_to_space view; f32 statistics as in ``ops/norms.py``, reduced
    over the space group on a D slab)."""
    n, d, h, w, cb = x.shape
    c = cb // B3
    y = normalize(x.reshape(n, d, h, w, B3, c).float(), (1, 2, 3, 4), eps)
    return y.to(x.dtype).reshape(n, d, h, w, cb)


def conv_ndhwc(x: torch.Tensor, w: torch.Tensor, bias, stride: int,
               padding: Tuple[int, int]) -> torch.Tensor:
    """conv3d of an NDHWC tensor with per-axis padding (lo, hi): unequal
    padding goes through ``F.pad``, then ``padding=0``; on a D slab under
    ``parallel.spatial.sharded`` the halo is exchanged first
    (``parallel/spatial.py`` ``conv3d``)."""
    return spatial.conv3d(x, w, bias, stride, padding)


# The backward of the 3^3 stride-1 SAME conv on the s2d view (the JAX
# package's ``CONV3_BWD``, ``dctseg/ops/s2d.py:251``): "xla" is autograd's,
# "explicit" the VJP of :class:`Conv3Explicit`.  Module-level, so that
# tests and benchmarks can flip it.
CONV3_BWD = "xla"


def _conv3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 3^3 stride-1 SAME conv of NDHWC x with the (O, I, 3, 3, 3) w
    cast to x's dtype."""
    return conv_ndhwc(x, w.to(x.dtype), None, 1, (1, 1))


class Conv3Explicit(torch.autograd.Function):
    """The 3^3 stride-1 SAME conv with the JAX package's explicit VJP
    (``dctseg/ops/s2d.py`` ``_conv3_cv_bwd``, :270): dx is the conv of the
    cotangent with the spatially flipped, io-transposed kernel; dW is 27
    shifted (N*Z*Y*X, Ci)^T @ (N*Z*Y*X, Co) products over the padded input,
    accumulated in f32 and cast to w's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv3(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = _conv3(g, w.flip(2, 3, 4).transpose(0, 1))
        n, d, h, wd, ci = x.shape
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
        g2 = g.reshape(-1, g.shape[-1]).float()
        taps = [xp[:, a:a + d, b:b + h, c:c + wd, :].reshape(-1, ci).float()
                .t() @ g2 for a in range(3) for b in range(3)
                for c in range(3)]
        # (27, Ci, Co) -> (Co, Ci, 3, 3, 3)
        dw = torch.stack(taps).reshape(3, 3, 3, ci, -1).permute(4, 3, 0, 1,
                                                                2)
        return dx, dw.to(w.dtype)


def conv3d_s2d(x: torch.Tensor, w8: torch.Tensor, bias=None,
               stride: int = 1, padding: Tuple[int, int] = (1, 1),
               quantize: str = "none") -> torch.Tensor:
    """A conv on the s2d view with a transformed kernel, in x's dtype.
    ``quantize="int8"`` runs it s8 x s8 -> s32 (``ops/quant.py``), the
    scales taken over the transformed kernel and the bias added after the
    cast, as the JAX package does.  With ``CONV3_BWD = "explicit"`` the
    3^3 stride-1 SAME case (outside a space group) runs
    :class:`Conv3Explicit`."""
    if quantize == "int8":
        return quant.conv3d_int8(x, w8, stride, padding, bias)
    if quantize != "none":
        raise ValueError(f"conv3d_s2d takes quantize 'none' or 'int8', got "
                         f"{quantize!r}")
    b = None if bias is None else bias.to(x.dtype)
    if (CONV3_BWD == "explicit" and stride == 1 and padding == (1, 1)
            and w8.shape[2:] == (3, 3, 3) and spatial.active() is None):
        y = Conv3Explicit.apply(x, w8)
        return y if b is None else y + b
    if CONV3_BWD not in ("xla", "explicit"):
        raise ValueError(f"unknown CONV3_BWD {CONV3_BWD!r}")
    return conv_ndhwc(x, w8.to(x.dtype), b, stride, padding)


# The routes of a fine conv on the s2d view: the stride and per-axis padding
# of the conv that its transformed kernel runs, and the quantize class that
# runs it int8 (None: it stays float under any spec, as in the JAX package).
ROUTES = {"dense": (1, (1, 1), "conv3"),   # conv_kernel, 8x the FLOPs
          "fine": (2, (1, 2), None),       # fine_conv_kernel on d2s(x8)
          "down": (1, (1, 0), "down"),     # down_kernel, plain coarse grid
          "pw": (1, (0, 0), "pw"),         # pointwise_kernel
          "deconv": (1, (0, 0), "deconv")}  # deconv_kernel


def conv_route(kernel_size: int, stride: int, strategy: str,
               ci: int) -> str:
    """The route of a fine (Co, ci, k, k, k) conv on the s2d view: "pw" for
    k = 1, "down" for stride 2, else the 3^3 conv under ``strategy``
    (``ModelConfig.conv3_strategy``): "fine" for the fine strategy and for
    "auto" at ci >= 32 (the JAX package's rule), else "dense"."""
    if strategy not in ("dense", "fine", "auto"):
        raise ValueError(f"unknown conv3 strategy {strategy!r}")
    if kernel_size == 1:
        return "pw"
    if stride == 2:
        return "down"
    return ("fine" if strategy == "fine" or (strategy == "auto" and ci >= 32)
            else "dense")


def quantized(route: str, quantize: str) -> bool:
    """True when the spec ``quantize`` runs ``route`` int8 (no channel
    gate on the s2d view, as in the JAX package)."""
    op = ROUTES[route][2]
    return op is not None and quant.enabled(quantize, op)


def prepare(route: str, w: torch.Tensor, bias, dtype: torch.dtype,
            int8: bool, groups: Sequence[int] = ()) -> tuple:
    """The per-call weight work of ``route`` on the fine parameters: the
    transformed kernel and the bias (tiled, except on the down route, whose
    output lies on the plain grid), in ``dtype``: (w8, b8), or with ``int8``
    (wq, sw, b8) by ``quant.prepare_weight``.  The int8 scales are taken
    over the transformed kernel of the weight cast to ``dtype``, as the
    JAX package takes them (the float transforms are gathers, so casting
    before or after them is the same)."""
    src = w.to(dtype) if int8 else w
    if route == "pw":
        w8 = pointwise_kernel(src, tuple(groups) or (w.shape[1],))
    else:
        w8 = {"dense": conv_kernel, "fine": fine_conv_kernel,
              "down": down_kernel, "deconv": deconv_kernel}[route](src)
    b8 = None
    if bias is not None:
        b8 = (bias if route == "down" else tile_bias(bias)).to(dtype)
    if int8:
        return (*quant.prepare_weight(w8), b8)
    return w8.to(dtype), b8


def apply(route: str, x8: torch.Tensor, prepared: tuple,
          amax: torch.Tensor | None = None) -> torch.Tensor:
    """Run ``route``'s conv on the s2d view ``x8`` with the tensors of
    :func:`prepare`: int8 (K7, then K6) when they are (wq, sw, b8), K7 in
    one read of x8 where ``amax`` (x8's per-sample absmax) is given."""
    stride, padding, _ = ROUTES[route]
    if route == "fine":
        x8 = depth_to_space(x8)
    if len(prepared) == 3:
        wq, sw, b8 = prepared
        return quant.conv3d_int8_prepared(x8, wq, sw, stride, padding, b8,
                                          amax)
    w8, b8 = prepared
    return conv3d_s2d(x8, w8, b8, stride, padding)


def conv3d_fine_s2dout(x: torch.Tensor, w4: torch.Tensor,
                       bias=None) -> torch.Tensor:
    """Apply :func:`fine_conv_kernel`'s strided kernel: fine (N, D, H, W, Ci)
    -> s2d view (N, D/2, H/2, W/2, 8Co)."""
    stride, padding, _ = ROUTES["fine"]
    return conv3d_s2d(x, w4, bias, stride, padding)


def conv3x3_s2d(x8: torch.Tensor, w: torch.Tensor, bias=None,
                strategy: str = "dense",
                quantize: str = "none") -> torch.Tensor:
    """The 3^3 stride-1 SAME conv on the s2d view; ``w`` is the fine
    (Co, Ci, 3, 3, 3) kernel, ``bias`` the fine bias (tiled here).

    ``strategy`` (``ModelConfig.conv3_strategy``): "dense" is
    conv_kernel's (8Co, 8Ci, 3, 3, 3) coarse conv (8x the FLOPs); "fine" is
    depth_to_space + fine_conv_kernel's (8Co, Ci, 4, 4, 4) stride-2 conv
    (64/27 = 2.37x the FLOPs); "auto" is :func:`conv_route`'s rule.

    ``quantize`` is the ModelConfig spec: its conv3 class runs the dense
    strategy int8; the fine strategy stays float, as in the JAX package.
    The same route, prepare and apply as ``models/unet.py``'s S2DConv3d."""
    route = conv_route(3, 1, strategy, w.shape[1])
    return apply(route, x8, prepare(route, w, bias, x8.dtype,
                                    quantized(route, quantize)))
