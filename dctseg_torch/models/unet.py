"""3D UNet encoder and decoder of ClsWiseFormer (the JAX package's
``dctseg/models/unet.py``), on the direct path and on the space-to-depth
(s2d) view.

Encoder (reference ``Unet``): InitConv, [EnBlock x2 -> stride-2 EnDown] x3,
EnBlock x2 -> stride-1 widening conv.  Decoder (reference ``Decoder``):
1x1 conv, EnBlock2 x2, then 3x [DeUp_Cat + DeBlock x2], 1x1 endconv and an
f32 softmax over classes.  EnBlock is pre-activation (IN -> ReLU -> conv),
EnBlock2/DeBlock post-activation (conv -> IN -> LReLU, residual on the last
norm).  Submodule names are the reference's, so its checkpoints load.

s2d: with ``s2d`` the full-resolution stages (InitConv, EnBlock1*, EnDown1,
DeUp2, DeBlock2*, endconv) run on the 2x2x2 space-to-depth view, with
``s2d_half`` the half-resolution stages (EnBlock2*, EnDown2, DeUp3,
DeBlock3*).  The parameters keep their reference shapes and names, and the
coarse-grid kernels are exact transforms of them (``ops/s2d.py``), so one
state_dict serves every flag combination.  Both stage inputs go through the
relayout kernel (``ops/relayout.py``); the encoder's fuses the cast to the
compute dtype.

Int8 with fused norms: where a norm's output feeds an int8 conv (both
convs of EnBlock, conv2 of EnBlock2/DeBlock, and the next block's conv1
after a residual norm), the norm is the absmax variant of the fused kernel
and the conv quantizes its input in one read (``ops/quant.py``); the other
int8 convs find the absmax themselves.

:class:`PlainUnet` is the encoder straight into the decoder, the JAX
package's standalone UNet.

Remat: ``remat`` ('full' or 'save_convs') wraps every residual block in
``torch.utils.checkpoint`` (non-reentrant) while gradients are recorded;
'save_convs' keeps the convolutions' outputs and recomputes only the norms
and activations.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from dctseg_torch.models.layers import (NO_DROPOUT, Conv3d, ConvTranspose3d,
                                        Dropout)
from dctseg_torch.ops import relayout
from dctseg_torch.ops import s2d as s2dops
from dctseg_torch.ops.fusednorm import (fused_instance_norm_act,
                                        fused_instance_norm_act_amax,
                                        fused_norm_apply,
                                        fused_norm_apply_amax,
                                        fused_norm_stats,
                                        fused_norm_stats_amax, norm_count)
from dctseg_torch.ops.norms import instance_norm, leaky_relu
from dctseg_torch.parallel import spatial

_CONV_OPS = (torch.ops.aten.convolution.default,)


def _save_convs(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep the conv outputs, recompute the
    rest."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _CONV_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _on_this_shard(policy=None):
    """A checkpoint ``context_fn``: ``policy``'s contexts (or none), with
    the recomputation, which runs inside the backward, on the D slab of
    the space group the forward ran on (``parallel/spatial.py``)."""
    shard = spatial.active()

    def contexts():
        fwd, rec = (policy() if policy is not None
                    else (contextlib.nullcontext(), contextlib.nullcontext()))
        return fwd, _both(rec, spatial.sharded(shard))
    return contexts


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _norm_act(x: torch.Tensor, eps: float, act: str, fused: bool,
              s2d_view: bool = False, residual: torch.Tensor | None = None,
              amax: bool = False) -> tuple:
    """(y, y_amax): InstanceNorm + activation (+ residual), by the fused
    kernel or the JAX package's plain composition (norm, cast, activation,
    add); on the s2d view the statistics are per fine channel (C / 8 of
    them).  ``y_amax``: with ``amax`` and the fused kernel, y's per-sample
    absmax for the int8 conv that reads y (the kernel's absmax variant),
    else None.  On a D slab under ``parallel.spatial.sharded`` the fused
    kernel runs its external-statistics variant, the sums all-reduced over
    the space group between its two launches (the plain norms reduce
    theirs in ``ops/norms.py``); with ``amax`` it reports the slab's
    per-sample absmax, which the int8 conv reduces over the mesh."""
    shard = spatial.active()
    if fused and shard is not None:
        fine = x.shape[-1] // (s2dops.B3 if s2d_view else 1)
        x = x.contiguous()
        sums, slots = (fused_norm_stats_amax(x, fine) if amax
                       else (fused_norm_stats(x, fine), None))
        kw = dict(count=norm_count(x, fine) * shard.size,
                  fine_channels=fine, eps=eps, act=act,
                  residual=None if residual is None
                  else residual.contiguous())
        sums = spatial.reduce_stats(sums, shard)
        if amax:
            return fused_norm_apply_amax(x, sums, slots, **kw)
        return fused_norm_apply(x, sums, **kw), None
    if fused:
        fine = x.shape[-1] // (s2dops.B3 if s2d_view else 1)
        kw = dict(act=act, residual=None if residual is None
                  else residual.contiguous())
        if amax:
            return fused_instance_norm_act_amax(x.contiguous(), fine, eps,
                                                **kw)
        return fused_instance_norm_act(x.contiguous(), fine, eps, **kw), None
    y = s2dops.instance_norm_s2d(x, eps) if s2d_view else instance_norm(x, eps)
    y = torch.relu(y) if act == "relu" else leaky_relu(y)
    return (y + residual if residual is not None else y), None


class S2DConv3d(Conv3d):
    """A Conv3d (same parameters) applied to the s2d view.

    kernel_size 3, stride 1 keeps the view (``conv3`` strategy);
    kernel_size 1 is a block-diagonal pointwise conv, ``groups`` giving the
    fine channel counts of concatenated s2d inputs; stride 2 lands on the
    plain coarse grid.  The route, its weight transform, padding and int8
    class are ``ops/s2d.py``'s (``conv_route``, ``prepare``, ``apply``):
    ``quantize`` runs the pw, down or dense conv3 route int8 by the JAX
    package's ``S2DConv3d`` rule (``dctseg/models/unet.py:89-131``), with
    no channel gate; the fine strategy stays float."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, groups: tuple = (),
                 dtype: torch.dtype = torch.float32, conv3: str = "dense",
                 generator=None, quantize: str = "none"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         dtype=dtype, generator=generator)
        self.groups = tuple(groups) or (in_channels,)
        self.route = s2dops.conv_route(kernel_size, stride, conv3,
                                       in_channels)
        self.int8 = s2dops.quantized(self.route, quantize)

    def fold_kinds(self) -> tuple:
        return ("int8",) if self.int8 else ("float",)

    def prepare(self, kind: str) -> tuple:
        return s2dops.prepare(self.route, self.weight, self.bias, self.dtype,
                              kind == "int8", self.groups)

    def forward(self, x8: torch.Tensor,
                amax: torch.Tensor | None = None) -> torch.Tensor:
        """``amax``: x8's per-sample absmax where a fused norm wrote it
        (taken by the int8 routes), else None."""
        if x8.dtype != self.dtype:
            x8, amax = x8.to(self.dtype), None   # amax is of the uncast x8
        kind = "int8" if self.int8 else "float"
        return s2dops.apply(self.route, x8, self.prepared(kind), amax)


class S2DDeconv(ConvTranspose3d):
    """The k=2, s=2 transpose conv emitting the s2d view directly: a 1x1
    conv at the coarse resolution (``ops/s2d.py``'s deconv route); int8
    with the deconv class."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, generator=None,
                 quantize: str = "none"):
        super().__init__(in_channels, out_channels, dtype=dtype,
                         generator=generator)
        self.int8 = s2dops.quantized("deconv", quantize)

    def fold_kinds(self) -> tuple:
        return ("int8",) if self.int8 else ("float",)

    def prepare(self, kind: str) -> tuple:
        return s2dops.prepare("deconv", self.weight, self.bias, self.dtype,
                              kind == "int8")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kind = "int8" if self.int8 else "float"
        return s2dops.apply("deconv", x.to(self.dtype), self.prepared(kind))


class _Block(nn.Module):
    """A residual block with two 3^3 convs, direct or on the s2d view,
    checkpointed under ``remat`` while gradients are recorded."""

    def __init__(self, channels, dtype, eps, fused_norms, generator,
                 s2d=False, conv3="dense", remat=None, quantize="none",
                 spatial_gate=False):
        super().__init__()
        self.eps, self.fused, self.s2d, self.remat = (eps, fused_norms, s2d,
                                                      remat)
        conv = (functools.partial(S2DConv3d, conv3=conv3, quantize=quantize)
                if s2d else functools.partial(Conv3d, quantize=quantize,
                                              spatial_gate=spatial_gate))
        self.conv1 = conv(channels, channels, dtype=dtype,
                          generator=generator)
        self.conv2 = conv(channels, channels, dtype=dtype,
                          generator=generator)
        # whether the block's output feeds an int8 conv that takes its
        # absmax (the next block's conv1; set by the parent)
        self.feeds_int8 = False

    def _norm(self, x, act, feeds_int8, residual=None):
        """(y, y's absmax where ``feeds_int8`` and the norm is fused)."""
        return _norm_act(x, self.eps, act, self.fused, self.s2d, residual,
                         amax=feeds_int8)

    def forward(self, *args):
        if self.remat is None or not torch.is_grad_enabled():
            return self.body(*args)
        policy = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    _save_convs)
                  if self.remat == "save_convs" else None)
        return ckpt.checkpoint(self.body, *args, use_reentrant=False,
                               context_fn=_on_this_shard(policy))


class _EnBlock(_Block):
    """Pre-activation residual block: [IN -> ReLU -> conv3] x2 + skip."""

    def body(self, x):
        y = self.conv1(*self._norm(x, "relu", self.conv1.int8))
        y = self.conv2(*self._norm(y, "relu", self.conv2.int8))
        return y + x


class _EnBlock2(_Block):
    """Post-activation residual block: [conv3 -> IN -> LeakyReLU] x2, the
    skip added after the last activation (DeBlock is identical).

    Takes (x, x's absmax or None) and returns (y, y's absmax or None): the
    absmax of an output that a fused norm wrote, for the next block's int8
    conv1 (``feeds_int8``)."""

    def body(self, x, amax=None):
        y = self._norm(self.conv1(x, amax), "lrelu", self.conv2.int8)
        return self._norm(self.conv2(*y), "lrelu", self.feeds_int8,
                          residual=x)


def _named_conv(conv: nn.Module) -> nn.ModuleDict:
    """A conv under the reference's ``<block>.conv`` name."""
    return nn.ModuleDict({"conv": conv})


class UnetEncoder(nn.Module):
    """Returns (x1_1, x2_1, x3_1, bottleneck) like the reference's
    ``Unet.forward``; x1_1 in the s2d view with ``s2d``, x2_1 with
    ``s2d_half``.  InitConv's spatial dropout (whole channels; whole fine
    channels on the s2d view) runs only in training.  ``quantize`` reaches
    the s2d stages and the quarter-resolution and bottleneck convs, as in
    the JAX package (``dctseg/models/unet.py:289-363``); the direct full-
    and half-resolution stages stay float."""

    def __init__(self, in_channels, base_channels, dtype, eps, fused_norms,
                 generator=None, s2d=False, s2d_half=False, conv3="dense",
                 remat=None, init_dropout=0.0, quantize="none"):
        super().__init__()
        b0 = base_channels
        self.dtype, self.s2d, self.s2d_half = dtype, s2d, s2d_half
        self.init_dropout = init_dropout

        def block(c, on_s2d, q):
            return _EnBlock(c, dtype, eps, fused_norms, generator, on_s2d,
                            conv3, remat, q)

        def conv(i, o, stride, on_s2d, q):
            if on_s2d:
                return _named_conv(S2DConv3d(i, o, stride=stride, dtype=dtype,
                                             conv3=conv3, generator=generator,
                                             quantize=q))
            return _named_conv(Conv3d(i, o, stride=stride, dtype=dtype,
                                      generator=generator, quantize=q))

        q1 = quantize if s2d else "none"
        q2 = quantize if s2d_half else "none"
        self.InitConv = conv(in_channels, b0, 1, s2d, q1)
        self.EnBlock1, self.EnBlock1_1 = (block(b0, s2d, q1),
                                          block(b0, s2d, q1))
        self.EnDown1 = conv(b0, 2 * b0, 2, s2d, q1)
        self.EnBlock2_1 = block(2 * b0, s2d_half, q2)
        self.EnBlock2_2 = block(2 * b0, s2d_half, q2)
        self.EnDown2 = conv(2 * b0, 4 * b0, 2, s2d_half, q2)
        self.EnBlock3_1, self.EnBlock3_2 = (block(4 * b0, False, quantize),
                                            block(4 * b0, False, quantize))
        self.EnDown3 = conv(4 * b0, 8 * b0, 2, False, quantize)
        self.EnBlock4_1, self.EnBlock4_2 = (block(8 * b0, False, quantize),
                                            block(8 * b0, False, quantize))
        # stride-1 widening conv
        self.EnDown_4 = conv(8 * b0, 16 * b0, 1, False, quantize)

    def forward(self, x, drop: Dropout = NO_DROPOUT):
        if self.s2d:
            # the relayout kernel casts to the compute dtype on the way
            x = relayout.space_to_depth(x.contiguous(), self.dtype)
            x = self.InitConv["conv"](x)
            n, d, h, w, cb = x.shape
            fine = cb // s2dops.B3
            x = drop(x.reshape(n, d, h, w, s2dops.B3, fine),
                     self.init_dropout,
                     (n, 1, 1, 1, 1, fine)).reshape(n, d, h, w, cb)
        else:
            x = self.InitConv["conv"](x)
            x = drop(x, self.init_dropout, (x.shape[0], 1, 1, 1, x.shape[-1]))
        x1_1 = self.EnBlock1_1(self.EnBlock1(x))
        x = self.EnDown1["conv"](x1_1)
        if self.s2d_half:
            x = relayout.space_to_depth(x.contiguous(), self.dtype)
        x2_1 = self.EnBlock2_2(self.EnBlock2_1(x))
        x = self.EnDown2["conv"](x2_1)
        x3_1 = self.EnBlock3_2(self.EnBlock3_1(x))
        x = self.EnDown3["conv"](x3_1)
        x4_1 = self.EnBlock4_2(self.EnBlock4_1(x))
        return x1_1, x2_1, x3_1, self.EnDown_4["conv"](x4_1)


class DeUpCat(nn.Module):
    """1x1 conv -> transpose-conv x2 upsample -> concat skip -> 1x1 conv.
    The reference names the transpose conv ``conv2``.

    ``s2d``: the upsample emits the s2d view of the finer grid, the skip
    arrives in that view, and conv3 is the block-diagonal pointwise conv of
    the concat.  ``s2d_input``: x arrives in the s2d view of its own grid,
    conv1 runs there as a pointwise s2d conv, then depth_to_space.
    ``quantize``: the pw class covers conv1 and conv3, the deconv class the
    s2d upsample; the direct transpose conv stays float."""

    def __init__(self, in_channels, skip_channels, out_channels, dtype,
                 generator=None, s2d=False, s2d_input=False,
                 quantize="none"):
        super().__init__()
        o, q = out_channels, quantize
        self.s2d_input = s2d_input
        if s2d_input:
            self.conv1 = S2DConv3d(in_channels, o, kernel_size=1, dtype=dtype,
                                   generator=generator, quantize=q)
        else:
            self.conv1 = Conv3d(in_channels, o, kernel_size=1, padding=0,
                                dtype=dtype, generator=generator, quantize=q)
        self.conv2 = (S2DDeconv(o, o, dtype=dtype, generator=generator,
                                quantize=q) if s2d else
                      ConvTranspose3d(o, o, dtype=dtype, generator=generator))
        if s2d:
            self.conv3 = S2DConv3d(skip_channels + o, o, kernel_size=1,
                                   groups=(skip_channels, o), dtype=dtype,
                                   generator=generator, quantize=q)
        else:
            self.conv3 = Conv3d(skip_channels + o, o, kernel_size=1,
                                padding=0, dtype=dtype, generator=generator,
                                quantize=q)

    def forward(self, x, skip):
        y = self.conv1(x)
        if self.s2d_input:
            y = s2dops.depth_to_space(y)
        y = self.conv2(y)
        return self.conv3(torch.cat([skip, y], dim=-1))


class Decoder(nn.Module):
    """UNet decoder with deep skips; returns f32 softmax class probs.  With
    ``s2d`` the softmax runs on the s2d layout (each class group holds the
    same summands) and depth_to_space follows: bit-exact with the direct
    tail.  ``quantize`` follows the JAX package (``dctseg/models/unet.py:
    459-530``): the blocks at 16^3 and 32^3 (opting in to the spatial
    gate), every DeUp, and the s2d blocks; the direct half- and
    full-resolution blocks stay float."""

    def __init__(self, embedding_dim, num_classes, base_channels, dtype, eps,
                 fused_norms, generator=None, s2d=False, s2d_half=False,
                 conv3="dense", remat=None, quantize="none"):
        super().__init__()
        e, b0, q = embedding_dim, base_channels, quantize
        self.s2d, self.s2d_half, self.num_classes = s2d, s2d_half, num_classes

        def block(c, on_s2d=False, q="none", gate=False):
            return _EnBlock2(c, dtype, eps, fused_norms, generator, on_s2d,
                             conv3, remat, q, gate)

        self.down_channel = Conv3d(e, e // 2, kernel_size=1, padding=0,
                                   dtype=dtype, generator=generator)
        self.Enblock8_1, self.Enblock8_2 = (block(e // 2, q=q, gate=True),
                                            block(e // 2, q=q, gate=True))
        self.DeUp4 = DeUpCat(e // 2, 4 * b0, e // 4, dtype, generator,
                             quantize=q)
        self.DeBlock4, self.DeBlock4_1 = (block(e // 4, q=q, gate=True),
                                          block(e // 4, q=q, gate=True))
        self.DeUp3 = DeUpCat(e // 4, 2 * b0, e // 8, dtype, generator,
                             s2d=s2d_half, quantize=q)
        q3 = q if s2d_half else "none"
        self.DeBlock3 = block(e // 8, s2d_half, q3)
        self.DeBlock3_1 = block(e // 8, s2d_half, q3)
        self.DeUp2 = DeUpCat(e // 8, b0, e // 16, dtype, generator, s2d=s2d,
                             s2d_input=s2d and s2d_half, quantize=q)
        q2 = q if s2d else "none"
        self.DeBlock2, self.DeBlock2_1 = (block(e // 16, s2d, q2),
                                          block(e // 16, s2d, q2))
        self.endconv = (
            S2DConv3d(e // 16, num_classes, kernel_size=1, dtype=dtype,
                      generator=generator) if s2d else
            Conv3d(e // 16, num_classes, kernel_size=1, padding=0,
                   dtype=dtype, generator=generator))
        # each pair's first block hands its output's absmax to the second's
        # int8 conv1
        for first, second in ((self.Enblock8_1, self.Enblock8_2),
                              (self.DeBlock4, self.DeBlock4_1),
                              (self.DeBlock3, self.DeBlock3_1),
                              (self.DeBlock2, self.DeBlock2_1)):
            first.feeds_int8 = second.conv1.int8

    def forward(self, x1_1, x2_1, x3_1, x):
        def pair(first, second, h):
            return second(*first(h))[0]
        x8 = pair(self.Enblock8_1, self.Enblock8_2, self.down_channel(x))
        y4 = pair(self.DeBlock4, self.DeBlock4_1, self.DeUp4(x8, x3_1))
        y3 = pair(self.DeBlock3, self.DeBlock3_1, self.DeUp3(y4, x2_1))
        if self.s2d_half and not self.s2d:
            y3 = s2dops.depth_to_space(y3)   # back to the plain grid
        y2 = pair(self.DeBlock2, self.DeBlock2_1, self.DeUp2(y3, x1_1))
        y = self.endconv(y2).float()
        if not self.s2d:
            return torch.softmax(y, dim=-1)
        n, d, h, w, cb = y.shape
        y = torch.softmax(y.reshape(n, d, h, w, s2dops.B3, self.num_classes),
                          dim=-1)
        return s2dops.depth_to_space(y.reshape(n, d, h, w, cb))


class PlainUnet(nn.Module):
    """The UNet encoder straight into the decoder, without the decouple and
    couple stages (the JAX package's ``dctseg/models/unet.py`` PlainUnet):
    the reference's standalone UNet, an ablation baseline and the
    profiling driver's second model.  Same fields as the JAX module;
    ``remat`` with ``remat_policy`` wraps the residual blocks while
    gradients are recorded.  Submodules ``unet`` and ``decoder`` carry the
    reference's names inside (``dctseg_torch/convert.py``
    ``plain_unet_state_dict_from_jax``).  (B, D, H, W, 4) ->
    (B, D, H, W, num_classes) f32 softmax probs."""

    def __init__(self, base_channels: int = 16, num_classes: int = 4,
                 init_dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32, remat: bool = True,
                 remat_policy: str = "full", fused_norms: bool = False,
                 s2d: bool = True, s2d_half: bool = True,
                 conv3: str = "dense", quantize: str = "none",
                 eps: float = 1e-5, in_channels: int = 4, generator=None):
        super().__init__()
        self.dtype, self.s2d = dtype, s2d
        kw = dict(s2d=s2d, s2d_half=s2d_half, conv3=conv3,
                  remat=remat_policy if remat else None, quantize=quantize)
        self.unet = UnetEncoder(in_channels, base_channels, dtype, eps,
                                fused_norms, generator,
                                init_dropout=init_dropout, **kw)
        self.decoder = Decoder(16 * base_channels, num_classes,
                               base_channels, dtype, eps, fused_norms,
                               generator, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``train`` turns InitConv's dropout on, with masks drawn from
        ``generator``."""
        if not self.s2d:
            # on the s2d path the relayout kernel does the cast
            x = x.to(self.dtype)
        drop = Dropout(generator) if train else NO_DROPOUT
        return self.decoder(*self.unet(x, drop))
