"""Swin UNETR in plain PyTorch: the benchmark's reference for the
``swin_unetr_serve`` configuration, a copy of the tests' reference
(``tests/swin_unetr_reference.py``, which ``benchmark/tests`` holds it to)
with the seeded weights added: :func:`param_specs` and :func:`make_weights`.

MONAI's ``monai/networks/nets/swin_unetr.py`` forward (``SwinUNETR`` with
``feature_size``, ``depths``, ``num_heads`` as configured, window 7, patch
2, MLP ratio 4, ``qkv_bias``, ``normalize=True``, ``downsample="merging"``,
instance norm, dropout 0) over a dict of parameters with MONAI's names, in
float32, written from MONAI's equations with none of the port's code: no
kernel, no cache, no batching trick.  It imports nothing of the port nor of
JAX.

Departures from MONAI, none of which changes a value:
  * the input and the output are NDHWC (the port's layout; MONAI's are
    NCDHW), and the convolutions run on the NCDHW view;
  * the output is the sigmoid of the logits (MONAI's model returns the
    logits; its BraTS 2021 ``test.py`` takes their sigmoid);
  * the relative-position index is built where it is used, not kept as a
    buffer;
  * InstanceNorm is written out (F.instance_norm's biased variance): at a
    single voxel, the bottleneck of a 32^3 input, MONAI's InstanceNorm3d
    refuses the input, and the formula gives 0;
  * ``precision="fp8"`` (the control) rounds every operand of a
    convolution, a linear layer and an attention product to float8 e4m3
    under a per-tensor scale.

Call :func:`strict_float32` first: float32 products without TF32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
MASK_VALUE = -100.0


def strict_float32() -> None:
    """Float32 matrix products and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale that maps its
    absmax to the format's largest value."""
    amax = t.abs().amax().float().clamp(min=1e-30)
    s = E4M3_MAX / amax
    return ((t.float() * s).to(torch.float8_e4m3fn).float() / s).to(t.dtype)


def relative_position_index(ws: int) -> torch.Tensor:
    """MONAI's ``WindowAttention.relative_position_index`` of a ws^3
    window, (ws^3, ws^3)."""
    coords = torch.stack(torch.meshgrid(
        torch.arange(ws), torch.arange(ws), torch.arange(ws), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 2] += ws - 1
    rel[:, :, 0] *= (2 * ws - 1) * (2 * ws - 1)
    rel[:, :, 1] *= 2 * ws - 1
    return rel.sum(-1)


def get_window_size(x_size, window_size, shift_size):
    use_window, use_shift = list(window_size), list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window[i] = x_size[i]
            use_shift[i] = 0
    return tuple(use_window), tuple(use_shift)


def window_partition(x: torch.Tensor, ws) -> torch.Tensor:
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(
        -1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows: torch.Tensor, ws, dims) -> torch.Tensor:
    b, d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1],
                     ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w, -1)


def compute_mask(dims, ws, shift, device) -> torch.Tensor:
    """MONAI's ``compute_mask``: (nW, N, N), -100 between tokens of
    different regions of the shifted grid, 0 elsewhere."""
    cnt = 0
    d, h, w = dims
    img_mask = torch.zeros((1, d, h, w, 1), device=device)
    for ds in (slice(-ws[0]), slice(-ws[0], -shift[0]),
               slice(-shift[0], None)):
        for hs in (slice(-ws[1]), slice(-ws[1], -shift[1]),
                   slice(-shift[1], None)):
            for wsl in (slice(-ws[2]), slice(-ws[2], -shift[2]),
                        slice(-shift[2], None)):
                img_mask[:, ds, hs, wsl, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, ws).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, MASK_VALUE).masked_fill(
        attn_mask == 0, 0.0)


class SwinUNETRRef:
    """The network over a dict of float32 parameters with MONAI's names.
    ``model``: the configuration's ``model`` section (``feature_size``,
    ``depths``, ``num_heads``, ``window_size``, ``in_channels``,
    ``out_channels``, ``norm_eps``).  ``precision``: 'float32' or 'fp8'.
    ``record``, a list, collects every convolution, norm site of a
    residual block and window attention (for the benchmark's counts)."""

    def __init__(self, model: dict, params: Dict[str, torch.Tensor],
                 precision: str = "float32", record: Optional[list] = None):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.m, self.p, self.record = model, params, record
        self.q: Callable = _fp8 if precision == "fp8" else (lambda t: t)
        self.ws = model["window_size"]
        self.eps = model["norm_eps"]
        self._index = relative_position_index(self.ws)

    # -- primitives (NCDHW for the convolutions) --

    def conv(self, x, name, stride=1, padding=0, transposed=False):
        w, b = self.p[f"{name}.weight"], self.p.get(f"{name}.bias")
        if transposed:
            y = F.conv_transpose3d(self.q(x), self.q(w), b, stride)
        else:
            y = F.conv3d(self.q(x), self.q(w), b, stride, padding)
        if self.record is not None:
            self.record.append(dict(name=name, x=tuple(x.permute(
                0, 2, 3, 4, 1).shape), w=tuple(w.shape), y=tuple(y.permute(
                    0, 2, 3, 4, 1).shape), transposed=transposed,
                bias=b is not None))
        return y

    def linear(self, x, name):
        w, b = self.p[f"{name}.weight"], self.p.get(f"{name}.bias")
        return F.linear(self.q(x), self.q(w), b)

    def layer_norm(self, x, name=None):
        c = x.shape[-1]
        if name is None:
            return F.layer_norm(x, [c])
        return F.layer_norm(x, [c], self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], self.eps)

    def instance_norm(self, x, kind=None):
        if self.record is not None and kind is not None:
            self.record.append(dict(norm=kind, x=tuple(x.permute(
                0, 2, 3, 4, 1).shape)))
        mean = x.mean(dim=(2, 3, 4), keepdim=True)
        var = (x - mean).square().mean(dim=(2, 3, 4), keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps)

    @staticmethod
    def lrelu(x):
        return F.leaky_relu(x, 0.01)

    # -- the Swin encoder --

    def window_attention(self, x, mask, name, heads):
        b, n, c = x.shape
        qkv = self.linear(x, f"{name}.qkv").reshape(
            b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * (c // heads) ** -0.5
        attn = self.q(q) @ self.q(k).transpose(-2, -1)
        table = self.p[f"{name}.relative_position_bias_table"]
        index = self._index.to(table.device)[:n, :n].reshape(-1)
        bias = table[index].reshape(n, n, -1).permute(2, 0, 1).contiguous()
        attn = attn + bias.unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, heads, n, n) + \
                mask.to(attn.dtype).unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        if self.record is not None:
            self.record.append(dict(window_attention=name, bw=b, heads=heads,
                                    n=n, d=c // heads))
        x = (self.q(attn) @ self.q(v)).transpose(1, 2).reshape(b, n, c)
        return self.linear(x, f"{name}.proj")

    def block(self, x, mask_matrix, name, heads, shift_size):
        b, d, h, w, c = x.shape
        window_size, shift_size = get_window_size(
            (d, h, w), (self.ws,) * 3, shift_size)
        shortcut = x
        x = self.layer_norm(x, f"{name}.norm1")
        pad_d1 = (window_size[0] - d % window_size[0]) % window_size[0]
        pad_b = (window_size[1] - h % window_size[1]) % window_size[1]
        pad_r = (window_size[2] - w % window_size[2]) % window_size[2]
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b, 0, pad_d1))
        _, dp, hp, wp, _ = x.shape
        dims = [b, dp, hp, wp]
        if any(i > 0 for i in shift_size):
            shifted_x = torch.roll(x, shifts=(-shift_size[0], -shift_size[1],
                                              -shift_size[2]), dims=(1, 2, 3))
            attn_mask = mask_matrix
        else:
            shifted_x = x
            attn_mask = None
        x_windows = window_partition(shifted_x, window_size)
        attn_windows = self.window_attention(x_windows, attn_mask,
                                             f"{name}.attn", heads)
        attn_windows = attn_windows.view(-1, *(window_size + (c,)))
        shifted_x = window_reverse(attn_windows, window_size, dims)
        if any(i > 0 for i in shift_size):
            x = torch.roll(shifted_x, shifts=shift_size, dims=(1, 2, 3))
        else:
            x = shifted_x
        x = x[:, :d, :h, :w, :].contiguous()
        x = shortcut + x
        y = self.layer_norm(x, f"{name}.norm2")
        y = self.linear(y, f"{name}.mlp.linear1")
        y = self.linear(F.gelu(y), f"{name}.mlp.linear2")
        return x + y

    def patch_merging(self, x, name):
        b, d, h, w, c = x.shape
        if (h % 2 == 1) or (w % 2 == 1) or (d % 2 == 1):
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x0 = x[:, 0::2, 0::2, 0::2, :]
        x1 = x[:, 1::2, 0::2, 0::2, :]
        x2 = x[:, 0::2, 1::2, 0::2, :]
        x3 = x[:, 0::2, 0::2, 1::2, :]
        x4 = x[:, 1::2, 0::2, 1::2, :]
        x5 = x[:, 0::2, 1::2, 0::2, :]
        x6 = x[:, 0::2, 0::2, 1::2, :]
        x7 = x[:, 1::2, 1::2, 1::2, :]
        x = torch.cat([x0, x1, x2, x3, x4, x5, x6, x7], -1)
        x = self.layer_norm(x, f"{name}.norm")
        return self.linear(x, f"{name}.reduction")

    def basic_layer(self, x, name, heads, depth):
        """x (B, C, D, H, W) -> the blocks, then the merging."""
        b, c, d, h, w = x.shape
        shift = (self.ws // 2,) * 3
        window_size, shift_size = get_window_size((d, h, w), (self.ws,) * 3,
                                                  shift)
        x = x.permute(0, 2, 3, 4, 1)
        dp = -(-d // window_size[0]) * window_size[0]
        hp = -(-h // window_size[1]) * window_size[1]
        wp = -(-w // window_size[2]) * window_size[2]
        attn_mask = compute_mask([dp, hp, wp], window_size, shift_size,
                                 x.device)
        for i in range(depth):
            x = self.block(x, attn_mask, f"{name}.blocks.{i}", heads,
                           (0, 0, 0) if i % 2 == 0 else shift)
        x = x.view(b, d, h, w, -1)
        x = self.patch_merging(x, f"{name}.downsample")
        return x.permute(0, 4, 1, 2, 3)

    def proj_out(self, x):
        x = x.permute(0, 2, 3, 4, 1)
        return self.layer_norm(x).permute(0, 4, 1, 2, 3)

    def swin(self, x):
        x0 = self.conv(x, "swinViT.patch_embed.proj", stride=2)
        out = [x0]
        for i in range(4):
            out.append(self.basic_layer(
                out[-1], f"swinViT.layers{i + 1}.0", self.m["num_heads"][i],
                self.m["depths"][i]))
        return [self.proj_out(t) for t in out]

    # -- the UNETR decoder --

    def res_block(self, x, name):
        residual = x
        out = self.conv(x, f"{name}.conv1.conv", padding=1)
        out = self.lrelu(self.instance_norm(out, "act"))
        out = self.conv(out, f"{name}.conv2.conv", padding=1)
        out = self.instance_norm(out, "residual")
        if f"{name}.conv3.conv.weight" in self.p:
            residual = self.instance_norm(
                self.conv(residual, f"{name}.conv3.conv"), "plain")
        return self.lrelu(out + residual)

    def up_block(self, x, skip, name):
        out = self.conv(x, f"{name}.transp_conv.conv", stride=2,
                        transposed=True)
        out = torch.cat((out, skip), dim=1)
        return self.res_block(out, f"{name}.conv_block")

    def forward(self, x: torch.Tensor):
        """x (B, D, H, W, in_channels) float32 -> (probs,): the sigmoids
        (B, D, H, W, out_channels)."""
        x_in = x.permute(0, 4, 1, 2, 3)
        hidden = self.swin(x_in)
        enc0 = self.res_block(x_in, "encoder1.layer")
        enc1 = self.res_block(hidden[0], "encoder2.layer")
        enc2 = self.res_block(hidden[1], "encoder3.layer")
        enc3 = self.res_block(hidden[2], "encoder4.layer")
        dec4 = self.res_block(hidden[4], "encoder10.layer")
        dec3 = self.up_block(dec4, hidden[3], "decoder5")
        dec2 = self.up_block(dec3, enc3, "decoder4")
        dec1 = self.up_block(dec2, enc2, "decoder3")
        dec0 = self.up_block(dec1, enc1, "decoder2")
        out = self.up_block(dec0, enc0, "decoder1")
        logits = self.conv(out, "out.conv.conv")
        return (torch.sigmoid(logits).permute(0, 2, 3, 4, 1),)


# ---- parameters ----

def param_specs(model: dict) -> List[tuple]:
    """(name, shape, init, fan_in) of every parameter, MONAI's names in
    its order.  ``init``: 'uniform' (U(-1/sqrt(fan_in), 1/sqrt(fan_in)):
    the convolutions' and linear layers' weights and biases), 'ones' and
    'zeros' (LayerNorm), 'token' (the relative-position bias tables: a
    normal of std 0.02 truncated at +-2, MONAI's ``trunc_normal_``)."""
    f, ws = model["feature_size"], model["window_size"]
    specs: List[tuple] = []

    def conv(name, cin, cout, k, bias, transposed=False):
        shape = (cin, cout, k, k, k) if transposed else (cout, cin, k, k, k)
        specs.append((f"{name}.weight", shape, "uniform", cin * k ** 3))
        if bias:
            specs.append((f"{name}.bias", (cout,), "uniform", cin * k ** 3))

    def linear(name, cin, cout, bias=True):
        specs.append((f"{name}.weight", (cout, cin), "uniform", cin))
        if bias:
            specs.append((f"{name}.bias", (cout,), "uniform", cin))

    def norm(name, c):
        specs.append((f"{name}.weight", (c,), "ones", 0))
        specs.append((f"{name}.bias", (c,), "zeros", 0))

    conv("swinViT.patch_embed.proj", model["in_channels"], f, 2, True)
    for i in range(4):
        c, heads = f << i, model["num_heads"][i]
        layer = f"swinViT.layers{i + 1}.0"
        for j in range(model["depths"][i]):
            blk = f"{layer}.blocks.{j}"
            norm(f"{blk}.norm1", c)
            specs.append((f"{blk}.attn.relative_position_bias_table",
                          ((2 * ws - 1) ** 3, heads), "token", 0))
            linear(f"{blk}.attn.qkv", c, 3 * c, model["qkv_bias"])
            linear(f"{blk}.attn.proj", c, c)
            norm(f"{blk}.norm2", c)
            hidden = int(c * model["mlp_ratio"])
            linear(f"{blk}.mlp.linear1", c, hidden)
            linear(f"{blk}.mlp.linear2", hidden, c)
        norm(f"{layer}.downsample.norm", 8 * c)
        linear(f"{layer}.downsample.reduction", 8 * c, 2 * c, bias=False)

    def res_block(name, cin, cout):
        conv(f"{name}.conv1.conv", cin, cout, 3, False)
        conv(f"{name}.conv2.conv", cout, cout, 3, False)
        if cin != cout:
            conv(f"{name}.conv3.conv", cin, cout, 1, False)

    res_block("encoder1.layer", model["in_channels"], f)
    res_block("encoder2.layer", f, f)
    res_block("encoder3.layer", 2 * f, 2 * f)
    res_block("encoder4.layer", 4 * f, 4 * f)
    res_block("encoder10.layer", 16 * f, 16 * f)
    for name, cin, cout in (("decoder5", 16 * f, 8 * f),
                            ("decoder4", 8 * f, 4 * f),
                            ("decoder3", 4 * f, 2 * f),
                            ("decoder2", 2 * f, f), ("decoder1", f, f)):
        conv(f"{name}.transp_conv.conv", cin, cout, 2, False,
             transposed=True)
        res_block(f"{name}.conv_block", 2 * cout, cout)
    conv("out.conv.conv", f, model["out_channels"], 1, True)
    return specs


def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every parameter, drawn
    from ``seed`` on the device in two calls (one ``torch.rand``, one
    ``torch.randn``), as ``benchmark/weights.py`` draws ClsWiseFormer's."""
    specs = param_specs(model)
    g = torch.Generator(device=device).manual_seed(seed)
    n_uniform = sum(math.prod(s) for _, s, init, _ in specs
                    if init == "uniform")
    n_normal = sum(math.prod(s) for _, s, init, _ in specs if init == "token")
    uniform = torch.rand(n_uniform, generator=g, device=device)
    normal = torch.randn(n_normal, generator=g, device=device)
    out, iu, inn = {}, 0, 0
    for name, shape, init, fan_in in specs:
        n = math.prod(shape)
        if init == "uniform":
            bound = 1.0 / math.sqrt(fan_in)
            t = (uniform[iu:iu + n] * 2.0 - 1.0) * bound
            iu += n
        elif init == "token":
            t = (normal[inn:inn + n] * 0.02).clamp(-2.0, 2.0)
            inn += n
        else:
            t = (torch.ones if init == "ones" else torch.zeros)(
                n, device=device)
        out[name] = t.reshape(shape)
    return out
