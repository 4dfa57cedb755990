"""Swin UNETR (Hatamizadeh et al., "Swin UNETR: Swin Transformers for
Semantic Segmentation of Brain Tumors in MRI Images", BrainLes 2021,
arXiv:2201.01266): MONAI's ``monai/networks/nets/swin_unetr.py`` forward,
equation for equation, on the port's NDHWC activations.

  Swin encoder: patch embedding (Conv3d k=s=2, with bias, no norm), four
    BasicLayers of shifted-window blocks, each followed by the legacy
    PatchMerging; the five outputs through a parameter-free LayerNorm over
    the channels (``proj_out``, ``normalize=True``).
  UNETR decoder: UnetResBlocks (conv, IN, LeakyReLU, conv, IN, + residual,
    LeakyReLU; the residual through a 1x1 conv and IN where the widths
    differ) on the input and on four of the encoder's outputs, then five
    UnetrUpBlocks (transpose conv k=s=2, concat the skip, UnetResBlock),
    and a 1x1 conv with bias; the outputs are region sigmoids (TC, WT, ET).

A block's attention part: LayerNorm, zero padding at the end of D, H and W
to multiples of the window, for every second block a cyclic shift by half
the window (``roll(-3)``) with MONAI's shift mask (-100 between tokens of
different regions of ``compute_mask``), the windows, attention with the
learned relative-position bias, the windows back, the shift back, the crop,
the residual add and the block's second LayerNorm.  On any axis no longer
than the window the window is that axis and the shift 0
(``get_window_size``).  The padding tokens attend and are attended to
unmasked, as in MONAI.  The attention runs as K8 (``ops/attention.py``
``fused_window_attention``: the bias gathered and the mask applied inside
the kernel), or with ``window_kernel=False`` as its plain version.  The
encoder's LayerNorms run on K9 (``ops/layernorm.py``): norm1 with the
padding, the roll and the partition in its addressing, the windows back,
the roll back, the crop and the residual add with norm2, and
PatchMerging's norm and ``proj_out`` in place; on CPU tensors K9's
operators run their plain versions, the torch sequence above.

The legacy PatchMerging (MONAI's ``PatchMerging``, the v0.9.0 form that
``downsample="merging"`` selects) concatenates the 2x2x2 neighbours in the
order [0::2,0::2,0::2], [1::2,0::2,0::2], [0::2,1::2,0::2], [0::2,0::2,1::2],
[1::2,0::2,1::2], [0::2,1::2,0::2], [0::2,0::2,1::2], [1::2,1::2,1::2]:
slices 5 and 6 repeat 2 and 3 and two neighbours never enter.  That is
MONAI's published behaviour, which its checkpoints were trained with, and
it is kept.

Precision: bf16 compute over f32 parameters, as the serving configuration
of ClsWiseFormer; LayerNorm and InstanceNorm statistics, the softmax and
the sigmoid in f32.  The residual blocks' norms run on K1 with
``fused_norms`` (``ops/fusednorm.py``: the last norm of each block on its
pre-activation residual route, ``fused_norm_residual_act``), the encoder's
LayerNorms on K9.

Module and parameter names follow MONAI's tree (``swinViT.layers1.0.
blocks.0.attn.qkv.weight``, ``encoder1.layer.conv1.conv.weight``, ...).
MONAI's state_dict also holds each attention's ``relative_position_index``
buffer, which the port derives from the window (K8 computes it in the
kernel) and does not keep: a loader drops those entries.

Three spans (``utils/profiling.py`` ``span``): ``swin.vit`` (patch
embedding through the last ``proj_out``), ``unetr.encoder`` (the five
UnetrBasicBlocks) and ``unetr.decoder`` (the up blocks, the output conv
and the sigmoid).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import unset_fake_temporarily

from dctseg_torch.device import resolve_device
from dctseg_torch.models import layers
from dctseg_torch.models.layers import Conv3d, ConvTranspose3d, Dense
from dctseg_torch.ops.attention import (fused_window_attention,
                                        fused_window_attention_plain)
from dctseg_torch.ops.fusednorm import (fused_instance_norm_act,
                                        fused_norm_residual_act)
from dctseg_torch.ops.layernorm import (PROJ_EPS, layer_norm,
                                        layer_norm_to_windows, padded,
                                        window_partition,
                                        windows_residual_layer_norm)
from dctseg_torch.ops.norms import instance_norm, leaky_relu
from dctseg_torch.utils.profiling import span

HEAD = "regions"        # the output head: sigmoids of TC, WT, ET
PATCH = 2               # the patch embedding's kernel and stride


@dataclasses.dataclass(frozen=True)
class SwinUNETRConfig:
    """MONAI's ``SwinUNETR`` arguments as the BraTS 2021 recipe sets them
    (``research-contributions/SwinUNETR/BRATS21``), and the port's
    choices: the compute dtype, K1 (``fused_norms``) and K8
    (``window_kernel``).  MONAI's patch size 2, ``normalize=True`` and
    ``downsample="merging"`` are the only ones ported, and fixed."""
    in_channels: int = 4
    out_channels: int = 3
    feature_size: int = 48
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    fused_norms: bool = True
    window_kernel: bool = True

    def __post_init__(self):
        if len(self.depths) != 4 or len(self.num_heads) != 4:
            raise ValueError("Swin UNETR has four stages")
        for i, h in enumerate(self.num_heads):
            if (self.feature_size << i) % h:
                raise ValueError(f"stage {i + 1}: {self.feature_size << i} "
                                 f"channels over {h} heads")

    @classmethod
    def from_dict(cls, d: dict) -> "SwinUNETRConfig":
        d = dict(d)
        for k in ("depths", "num_heads"):
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)


# ---- window geometry (MONAI's helpers) ----

def get_window_size(x_size, window_size, shift_size):
    """MONAI's ``get_window_size``: on an axis no longer than the window,
    the window is the axis and the shift 0."""
    win, shift = list(window_size), list(shift_size)
    for i, n in enumerate(x_size):
        if n <= window_size[i]:
            win[i] = n
            shift[i] = 0
    return tuple(win), tuple(shift)


@functools.lru_cache(maxsize=64)
def _region_ids(dims, window, shift, device) -> torch.Tensor:
    img = torch.zeros(dims, dtype=torch.int8)
    cnt = 0
    spans = [(slice(-wn), slice(-wn, -s), slice(-s, None))
             for wn, s in zip(window, shift)]
    for d in spans[0]:
        for h in spans[1]:
            for w in spans[2]:
                img[d, h, w] = cnt
                cnt += 1
    ids = window_partition(img[None, ..., None], window)[..., 0]
    return ids.contiguous().to(device)


def region_ids(dims, window, shift, device) -> torch.Tensor:
    """(nW, N) int8: each token's region of MONAI's ``compute_mask`` over
    the padded grid ``dims`` = (D, H, W), by window; two tokens of one
    window whose ids differ get -100 in its mask.  Made once per geometry
    and device, as a real tensor even under a FakeTensorMode (the
    profiler's count of a forward), so that no fake one is cached."""
    with unset_fake_temporarily():
        return _region_ids(tuple(dims), tuple(window), tuple(shift),
                           torch.device(device))


# ---- layers ----

def _named(module: nn.Module) -> nn.ModuleDict:
    """A conv under MONAI's ``<name>.conv`` (its ``Convolution`` wrapper)."""
    return nn.ModuleDict({"conv": module})


class LayerNorm(layers.LayerNorm):
    """Affine LayerNorm over the channels: statistics and the affine in
    f32, cast back to the input dtype; K9's ``plain`` route."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def proj_out(x: torch.Tensor) -> torch.Tensor:
    """MONAI's ``proj_out(x, normalize=True)``: a parameter-free LayerNorm
    over the channels, in f32."""
    return layer_norm(x, None, None, PROJ_EPS)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinUNETRConfig, dtype, generator):
        super().__init__()
        self.proj = Conv3d(cfg.in_channels, cfg.feature_size, PATCH,
                           stride=PATCH, padding=0, dtype=dtype,
                           generator=generator)

    def forward(self, x):
        return self.proj(x)


class WindowAttention(nn.Module):
    """Window multi-head self-attention with the relative-position bias
    (13^3 x heads for a 7^3 window) and, on shifted blocks, the shift
    mask."""

    def __init__(self, dim: int, heads: int, window: int, qkv_bias: bool,
                 dtype, generator, kernel: bool):
        super().__init__()
        self.heads, self.window, self.kernel = heads, window, kernel
        self.scale = (dim // heads) ** -0.5
        side = 2 * window - 1
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(side ** 3, heads))
        with torch.no_grad():
            nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02,
                                  generator=generator)
        self.qkv = Dense(dim, 3 * dim, use_bias=qkv_bias, dtype=dtype,
                         generator=generator)
        self.proj = Dense(dim, dim, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, ids: torch.Tensor | None
                ) -> torch.Tensor:
        """x: (B * nW, N, C) windows; ``ids``: (nW, N) region ids of a
        shifted block, or None."""
        bw, n, c = x.shape
        qkv = self.qkv(x).view(bw, n, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attend = (fused_window_attention if self.kernel
                  else fused_window_attention_plain)
        y = attend(q, k, v, self.relative_position_bias_table, ids,
                   self.scale, self.window)
        return self.proj(y.view(bw, n, c))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 cfg: SwinUNETRConfig, dtype, generator):
        super().__init__()
        self.window, self.shift = (window,) * 3, (shift,) * 3
        self.norm1 = LayerNorm(dim, cfg.norm_eps)
        self.attn = WindowAttention(dim, heads, window, cfg.qkv_bias, dtype,
                                    generator, cfg.window_kernel)
        self.norm2 = LayerNorm(dim, cfg.norm_eps)
        hidden = int(dim * cfg.mlp_ratio)
        self.mlp = nn.ModuleDict({
            "linear1": Dense(dim, hidden, dtype=dtype, generator=generator),
            "linear2": Dense(hidden, dim, dtype=dtype, generator=generator)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        grid = x.shape[1:4]
        window, shift = get_window_size(grid, self.window, self.shift)
        ids = (region_ids(padded(grid, window), window, shift, x.device)
               if any(shift) else None)
        n1, n2 = self.norm1, self.norm2
        y = self.attn(layer_norm_to_windows(x, n1.weight, n1.bias, n1.eps,
                                            window, shift), ids)
        # x + attention, and norm2 of that sum
        x, y = windows_residual_layer_norm(y, x, n2.weight, n2.bias, n2.eps,
                                           window, shift)
        y = self.mlp["linear1"](y)
        y = self.mlp["linear2"](F.gelu(y, approximate="none"))
        return x + y


class PatchMerging(nn.Module):
    """MONAI's legacy ``PatchMerging`` (see the module docstring for its
    neighbour order): LayerNorm(8C), Linear(8C -> 2C, no bias)."""

    def __init__(self, dim: int, cfg: SwinUNETRConfig, dtype, generator):
        super().__init__()
        self.norm = LayerNorm(8 * dim, cfg.norm_eps)
        self.reduction = Dense(8 * dim, 2 * dim, use_bias=False, dtype=dtype,
                               generator=generator)

    @staticmethod
    def gather(x: torch.Tensor) -> torch.Tensor:
        d, h, w = x.shape[1:4]
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        parts = [x[:, 0::2, 0::2, 0::2], x[:, 1::2, 0::2, 0::2],
                 x[:, 0::2, 1::2, 0::2], x[:, 0::2, 0::2, 1::2],
                 x[:, 1::2, 0::2, 1::2], x[:, 0::2, 1::2, 0::2],
                 x[:, 0::2, 0::2, 1::2], x[:, 1::2, 1::2, 1::2]]
        return torch.cat(parts, dim=-1)

    def forward(self, x):
        return self.reduction(self.norm(self.gather(x)))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int,
                 cfg: SwinUNETRConfig, dtype, generator):
        super().__init__()
        ws = cfg.window_size
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, heads, ws, 0 if i % 2 == 0 else ws // 2,
                                 cfg, dtype, generator)
            for i in range(depth)])
        self.downsample = PatchMerging(dim, cfg, dtype, generator)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


class SwinTransformer(nn.Module):
    def __init__(self, cfg: SwinUNETRConfig, dtype, generator):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg, dtype, generator)
        for i in range(4):
            setattr(self, f"layers{i + 1}", nn.ModuleList([BasicLayer(
                cfg.feature_size << i, cfg.depths[i], cfg.num_heads[i], cfg,
                dtype, generator)]))

    def forward(self, x) -> List[torch.Tensor]:
        out = [self.patch_embed(x)]
        for i in range(4):
            out.append(getattr(self, f"layers{i + 1}")[0](out[-1]))
        return [proj_out(t) for t in out]


class UnetResBlock(nn.Module):
    """MONAI's ``UnetResBlock`` (stride 1): lrelu(IN(conv2(lrelu(IN(
    conv1(x))))) + r), r = x, or IN(conv3_1x1(x)) where the widths differ;
    convs without bias, IN affine-free."""

    def __init__(self, cin: int, cout: int, cfg: SwinUNETRConfig, dtype,
                 generator):
        super().__init__()
        self.eps, self.fused = cfg.norm_eps, cfg.fused_norms
        conv = functools.partial(Conv3d, dtype=dtype, generator=generator,
                                 bias=False)
        self.conv1 = _named(conv(cin, cout, 3))
        self.conv2 = _named(conv(cout, cout, 3))
        self.downsample = cin != cout
        if self.downsample:
            self.conv3 = _named(conv(cin, cout, 1, padding=0))

    def _norm(self, x, act):
        if self.fused:
            return fused_instance_norm_act(x.contiguous(), x.shape[-1],
                                           self.eps, act=act)
        y = instance_norm(x, self.eps)
        return leaky_relu(y) if act == "lrelu" else y

    def forward(self, x):
        y = self._norm(self.conv1["conv"](x), "lrelu")
        y = self.conv2["conv"](y)
        r = self._norm(self.conv3["conv"](x), "none") if self.downsample \
            else x.to(y.dtype)
        if self.fused:
            return fused_norm_residual_act(y.contiguous(), r.contiguous(),
                                           y.shape[-1], self.eps,
                                           act="lrelu")
        return leaky_relu(instance_norm(y, self.eps) + r)


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin, cout, cfg, dtype, generator):
        super().__init__()
        self.layer = UnetResBlock(cin, cout, cfg, dtype, generator)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    def __init__(self, cin, cout, cfg, dtype, generator):
        super().__init__()
        self.transp_conv = _named(ConvTranspose3d(
            cin, cout, 2, 2, dtype=dtype, generator=generator, bias=False))
        self.conv_block = UnetResBlock(2 * cout, cout, cfg, dtype, generator)

    def forward(self, x, skip):
        up = self.transp_conv["conv"](x)
        return self.conv_block(torch.cat([up, skip.to(up.dtype)], dim=-1))


class UnetOutBlock(nn.Module):
    def __init__(self, cin, cout, dtype, generator):
        super().__init__()
        self.conv = _named(Conv3d(cin, cout, 1, padding=0, dtype=dtype,
                                  generator=generator))

    def forward(self, x):
        return self.conv["conv"](x)


class SwinUNETR(nn.Module):
    """x (B, D, H, W, in_channels), each side a multiple of 32 -> (probs,):
    the f32 sigmoids of the three regions (TC, WT, ET), NDHWC, as the one
    entry of a tuple (the engine reads ``model(x)[0]``)."""

    head = HEAD

    def __init__(self, cfg: SwinUNETRConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        dt = self.dtype = getattr(torch, cfg.compute_dtype)
        f, g = cfg.feature_size, generator
        self.swinViT = SwinTransformer(cfg, dt, g)
        self.encoder1 = UnetrBasicBlock(cfg.in_channels, f, cfg, dt, g)
        self.encoder2 = UnetrBasicBlock(f, f, cfg, dt, g)
        self.encoder3 = UnetrBasicBlock(2 * f, 2 * f, cfg, dt, g)
        self.encoder4 = UnetrBasicBlock(4 * f, 4 * f, cfg, dt, g)
        self.encoder10 = UnetrBasicBlock(16 * f, 16 * f, cfg, dt, g)
        self.decoder5 = UnetrUpBlock(16 * f, 8 * f, cfg, dt, g)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f, cfg, dt, g)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f, cfg, dt, g)
        self.decoder2 = UnetrUpBlock(2 * f, f, cfg, dt, g)
        self.decoder1 = UnetrUpBlock(f, f, cfg, dt, g)
        self.out = UnetOutBlock(f, cfg.out_channels, dt, g)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor]:
        if x.dim() != 5 or x.shape[-1] != self.cfg.in_channels or any(
                n % 32 for n in x.shape[1:4]):
            raise ValueError(
                f"SwinUNETR expects (B, D, H, W, {self.cfg.in_channels}) "
                f"with D, H, W multiples of 32; got {tuple(x.shape)}")
        x = x.to(self.dtype)
        with span("swin.vit"):
            hidden = self.swinViT(x)
        with span("unetr.encoder"):
            enc0 = self.encoder1(x)
            enc1 = self.encoder2(hidden[0])
            enc2 = self.encoder3(hidden[1])
            enc3 = self.encoder4(hidden[2])
            dec4 = self.encoder10(hidden[4])
        with span("unetr.decoder"):
            dec3 = self.decoder5(dec4, hidden[3])
            dec2 = self.decoder4(dec3, enc3)
            dec1 = self.decoder3(dec2, enc2)
            dec0 = self.decoder2(dec1, enc1)
            out = self.decoder1(dec0, enc0)
            return (torch.sigmoid(self.out(out).float()),)


def load_monai_checkpoint(model: SwinUNETR, path: str) -> None:
    """Load a MONAI ``SwinUNETR`` checkpoint (a state_dict, or a dict
    holding one under ``state_dict`` as the BraTS 2021 recipe saves it)
    strictly, less the ``relative_position_index`` buffers the port
    derives."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = state.get("state_dict", state)
    model.load_state_dict({k.removeprefix("module."): v
                           for k, v in state.items()
                           if not k.endswith("relative_position_index")},
                          strict=True)


def build_model(cfg: SwinUNETRConfig | None = None, device=None,
                generator: torch.Generator | None = None) -> SwinUNETR:
    """Swin UNETR in eval mode on ``device`` (default: the GPU; raises if
    there is none unless ``device='cpu'``).  Weights are drawn on the CPU
    from ``generator`` (torch's default generator if None)."""
    dev = resolve_device(device)
    model = SwinUNETR(cfg or SwinUNETRConfig(), generator)
    return model.to(dev).eval()


def region_labels(probs: torch.Tensor) -> torch.Tensor:
    """BRATS21 ``test.py``'s rule on (..., 3) region probabilities (TC,
    WT, ET): threshold at 0.5, then label 2 where WT, 1 where TC and 3
    (BraTS 4) where ET, each overwriting the last; uint8."""
    on = probs > 0.5
    out = torch.zeros(probs.shape[:-1], dtype=torch.uint8,
                      device=probs.device)
    out[on[..., 1]] = 2
    out[on[..., 0]] = 1
    out[on[..., 2]] = 3
    return out

