"""ClsWiseFormer on its direct path in plain PyTorch: the reference the
benchmark holds the port's outputs against.

It follows the published network (github.com/mathwrx/Decouple-and-Couple_
Learning_in_Multi-Modal_Brain_Tumor_Segmentation, ``cls_wise_former.py``)
in the equations the port runs, on NDHWC activations:

  UNet encoder (InitConv, pre-activation residual blocks, stride-2 convs)
  edge decouple (skip2 down, concat skip3, conv + IN + LeakyReLU per region)
  semantic decouple (conv + IN + LeakyReLU on the bottleneck per region)
  per region: patchify, four top-k routings against the class tokens, the
    edge-supported coupler (one shared cross-attention block applied four
    times, one FFN), scatter back, class-token gating
  the mutual cross-region coupler over the summed class streams
  sum_fusion conv, the decoder (post-activation blocks, transpose-conv
  upsampling), softmax; deep-supervision heads (conv, conv, trilinear
  upsample, softmax).

Departures from the published code, as the port makes them: the 'fixed'
positional encoding adds row 0 of the sinusoid table to every token (the
published table is indexed by the batch axis); InstanceNorm statistics are
E[x^2] - mean^2 in float32, clamped at 0; trilinear upsampling is three
interpolation matrices (``align_corners=False``); attention runs in float32
whatever the compute dtype.

Everything runs in float32 with TF32 off (:func:`strict_float32`), or, with
``precision="fp8"``, with every operand of a convolution, a linear layer and
an attention product rounded to float8 e4m3 under a per-tensor scale, and
the gradients of the convolutions' and linear layers' outputs to float8
e5m2 (the control that a lower precision must fail).  Parameter names are the
published state_dict's 222 keys.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

REGIONS = ("01", "02", "04")
E4M3_MAX = 448.0
E5M2_MAX = 57344.0
PE_ROWS = 1024          # rows of the published positional table


def strict_float32() -> None:
    """Float32 matrix products and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def geometry(model: dict) -> dict:
    """The network's sizes from a configuration's ``model`` section."""
    d, b0 = model["img_dim"], model["base_channels"]
    sem_patch, edge_patch = (2, 2, 1), (4, 2, 2)
    sem_size, edge_size = d // 8, d // 4
    return dict(
        b0=b0, in_ch=model["in_channels"], classes=model["num_classes"],
        heads=model["num_heads"], k=model["top_num"], eps=model["norm_eps"],
        img=d, sem_ch=8 * b0, edge_ch=2 * b0, bottleneck=16 * b0,
        sem_size=sem_size, edge_size=edge_size, sem_patch=sem_patch,
        edge_patch=edge_patch, token=8 * b0 * math.prod(sem_patch),
        init_dropout=model["init_conv_dropout"],
        dropout=model["dropout_rate"], attn_dropout=model["attn_dropout_rate"])


# ---- parameters ----

def param_specs(model: dict) -> List[tuple]:
    """(name, shape, init, fan_in) of every entry of the state_dict.
    ``init``: 'uniform' (U(-1/sqrt(fan_in), 1/sqrt(fan_in))), 'ones',
    'zeros', 'token' (truncated normal, std 0.02), 'pe' (the sinusoid
    table)."""
    g = geometry(model)
    b0, p, specs = g["b0"], g["token"], []

    def conv(name, cin, cout, k=3, transposed=False):
        shape = (cin, cout, k, k, k) if transposed else (cout, cin, k, k, k)
        specs.append((f"{name}.weight", shape, "uniform", cin * k ** 3))
        specs.append((f"{name}.bias", (cout,), "uniform", cin * k ** 3))

    def dense(name, cin, cout, bias=True):
        specs.append((f"{name}.weight", (cout, cin), "uniform", cin))
        if bias:
            specs.append((f"{name}.bias", (cout,), "uniform", cin))

    def norm(name):
        specs.append((f"{name}.weight", (p,), "ones", 0))
        specs.append((f"{name}.bias", (p,), "zeros", 0))

    def transformer(name):
        att = f"{name}.cross_attention_list.0.fn"
        norm(f"{att}.norm")
        norm(f"{att}.norm2")
        dense(f"{att}.fn.qkv", p, 3 * p, bias=False)
        dense(f"{att}.fn.out_proj", p, p)
        ffn = f"{name}.cross_ffn_list.0.fn"
        norm(f"{ffn}.norm")
        dense(f"{ffn}.fn.net.0", p, p)
        dense(f"{ffn}.fn.net.3", p, p)

    for r in REGIONS:
        specs.append((f"e_token_{r}", (1, 1, p), "token", 0))
        specs.append((f"s_token_{r}", (1, 1, p), "token", 0))
    u = "Unet_list"
    conv(f"{u}.InitConv.conv", g["in_ch"], b0)
    for blk, c in (("EnBlock1", b0), ("EnBlock1_1", b0), ("EnDown1", None),
                   ("EnBlock2_1", 2 * b0), ("EnBlock2_2", 2 * b0),
                   ("EnDown2", None), ("EnBlock3_1", 4 * b0),
                   ("EnBlock3_2", 4 * b0), ("EnDown3", None),
                   ("EnBlock4_1", 8 * b0), ("EnBlock4_2", 8 * b0)):
        if c is None:
            cin = {"EnDown1": b0, "EnDown2": 2 * b0, "EnDown3": 4 * b0}[blk]
            conv(f"{u}.{blk}.conv", cin, 2 * cin)
        else:
            conv(f"{u}.{blk}.conv1", c, c)
            conv(f"{u}.{blk}.conv2", c, c)
    conv(f"{u}.EnDown_4.conv", 8 * b0, 16 * b0)
    conv("conv_64_to_32", 2 * b0, 2 * b0)
    for r in REGIONS:
        conv(f"conv_mid_fea_{r[1]}", 6 * b0, g["edge_ch"])
        conv(f"conv_semantic_{r[1]}", g["bottleneck"], g["sem_ch"])
    for r in REGIONS:
        specs.append((f"label_{r}_position_encoding.pe", (PE_ROWS, 1, p),
                      "pe", 0))
        transformer(f"transformer_{r}")
    specs.append(("fusion_label_pos.pe", (PE_ROWS, 1, p), "pe", 0))
    transformer("fusion_transformer_1_2_4")
    for head, cin, mid, edge in (
            ("supervise_label", g["sem_ch"], 32, False),
            ("edge_supervise_label", g["edge_ch"], 8, True),
            ("mid_supervise_label", g["sem_ch"], 32, False),
            ("mid_edge_supervise_label", g["edge_ch"], 8, True)):
        pre = "edge_" if edge else ""
        for r in REGIONS:
            conv(f"{head}.{pre}supervise_label_{r[1]}", cin, mid)
            conv(f"{head}.{pre}down_label_{r[1]}", mid, 2)
    conv("sum_fusion", g["sem_ch"], g["bottleneck"])
    e = g["bottleneck"]
    d = "decoder"
    conv(f"{d}.down_channel", e, e // 2, k=1)
    for blk, c in (("Enblock8_1", e // 2), ("Enblock8_2", e // 2)):
        conv(f"{d}.{blk}.conv1", c, c)
        conv(f"{d}.{blk}.conv2", c, c)
    for up, cin, skip, cout, blocks in (
            ("DeUp4", e // 2, 4 * b0, e // 4, ("DeBlock4", "DeBlock4_1")),
            ("DeUp3", e // 4, 2 * b0, e // 8, ("DeBlock3", "DeBlock3_1")),
            ("DeUp2", e // 8, b0, e // 16, ("DeBlock2", "DeBlock2_1"))):
        conv(f"{d}.{up}.conv1", cin, cout, k=1)
        conv(f"{d}.{up}.conv2", cout, cout, k=2, transposed=True)
        conv(f"{d}.{up}.conv3", skip + cout, cout, k=1)
        for blk in blocks:
            conv(f"{d}.{blk}.conv1", cout, cout)
            conv(f"{d}.{blk}.conv2", cout, cout)
    conv(f"{d}.endconv", e // 16, g["classes"], k=1)
    return specs


def sinusoid_table(rows: int, dim: int) -> np.ndarray:
    """The published (rows, 1, dim) fixed positional table."""
    pe = np.zeros((rows, dim), np.float32)
    pos = np.arange(rows, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * (-np.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe[:, None, :]


def interp_matrix(n_in: int, scale: int) -> np.ndarray:
    """(n_in * scale, n_in) linear interpolation, half-pixel centres."""
    n_out = n_in * scale
    w = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        src = (i + 0.5) / scale - 0.5
        lo = int(np.floor(src))
        frac = src - lo
        w[i, min(max(lo, 0), n_in - 1)] += 1.0 - frac
        w[i, min(max(lo + 1, 0), n_in - 1)] += frac
    return w


# ---- precision and dropout ----

def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale that maps its
    absmax to the format's largest value; the gradient passes straight
    through."""
    q = _scaled(t.detach(), torch.float8_e4m3fn, E4M3_MAX)
    return t + (q - t.detach())


def _scaled(t: torch.Tensor, fmt, top: float) -> torch.Tensor:
    amax = t.abs().amax().float().clamp(min=1e-30)
    s = top / amax
    return ((t.float() * s).to(fmt).float() / s).to(t.dtype)


class _GradFp8(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2 under a
    per-tensor scale, as a float8 backward pass computes it."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, torch.float8_e5m2, E5M2_MAX)


class Dropout:
    """Keep each element (or slice, by ``shape``) with probability 1 - rate,
    scaling what it keeps; masks are ``torch.rand(..) < keep`` drawn from
    ``generator`` in the forward's order.  ``None`` generator: no dropout."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator

    def __call__(self, x, rate, shape=None):
        if self.generator is None or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(tuple(shape or x.shape), device=x.device,
                          generator=self.generator) < keep
        return torch.where(mask, x / keep, x.new_zeros(()))


# ---- the network ----

class ClsWiseFormerRef:
    """The network over a dict of parameters (float32 tensors, the
    published names).  ``precision``: 'float32' or 'fp8'.  ``record``, a
    list, collects every convolution's shapes (for ``counts.py``)."""

    def __init__(self, model: dict, params: Dict[str, torch.Tensor],
                 precision: str = "float32", record: Optional[list] = None):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.g, self.p, self.record = geometry(model), params, record
        fp8 = precision == "fp8"
        self.q: Callable = _fp8 if fp8 else (lambda t: t)
        # the gradient of a product's output, in a float8 backward pass
        self.qg: Callable = _GradFp8.apply if fp8 else (lambda t: t)
        self._mats: dict = {}

    # -- primitives --

    def conv(self, x, name, stride=1, padding=1, transposed=False):
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        xc = self.q(x).permute(0, 4, 1, 2, 3)
        if transposed:
            y = F.conv_transpose3d(xc, self.q(w), b, stride)
        else:
            y = F.conv3d(xc, self.q(w), b, stride, padding)
        y = self.qg(y.permute(0, 2, 3, 4, 1))
        if self.record is not None:
            self.record.append(dict(name=name, x=tuple(x.shape),
                                    w=tuple(w.shape), y=tuple(y.shape),
                                    transposed=transposed))
        return y

    def dense(self, x, name, rows=slice(None)):
        w = self.p[f"{name}.weight"][rows]
        b = self.p.get(f"{name}.bias")
        return self.qg(F.linear(self.q(x), self.q(w),
                                None if b is None else b[rows]))

    def instance_norm(self, x):
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        sq = x.square().mean(dim=(1, 2, 3), keepdim=True)
        var = torch.clamp(sq - mean.square(), min=0.0)
        return (x - mean) * torch.rsqrt(var + self.g["eps"])

    @staticmethod
    def lrelu(x):
        return torch.where(x >= 0, x, 0.01 * x)

    def layer_norm(self, x, name):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        return y * self.p[f"{name}.weight"] + self.p[f"{name}.bias"]

    def upsample(self, x, scale):
        _, d, h, w, _ = x.shape

        def mat(n):
            key = (n, scale, x.device)
            if key not in self._mats:
                self._mats[key] = torch.from_numpy(
                    interp_matrix(n, scale)).to(x.device)
            return self._mats[key]
        x = torch.einsum("od,bdhwc->bohwc", mat(d), x)
        x = torch.einsum("oh,bdhwc->bdowc", mat(h), x)
        return torch.einsum("ow,bdhwc->bdhoc", mat(w), x)

    @staticmethod
    def patchify(x, patch):
        b, d0, d1, d2, c = x.shape
        p0, p1, p2 = patch
        x = x.reshape(b, d0 // p0, p0, d1 // p1, p1, d2 // p2, p2, c)
        x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
        return x.reshape(b, -1, c * p0 * p1 * p2)

    @staticmethod
    def unpatchify(t, c, size, patch):
        b = t.shape[0]
        p0, p1, p2 = patch
        g0, g1, g2 = size // p0, size // p1, size // p2
        x = t.reshape(b, g0, g1, g2, c, p0, p1, p2)
        x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
        return x.reshape(b, g0 * p0, g1 * p1, g2 * p2, c)

    @staticmethod
    def topk(tokens, query, k):
        q = query.expand(tokens.shape[0], -1, -1)
        scores = torch.einsum("bop,bnp->bn", q, tokens)
        idx = torch.topk(scores, k, dim=1, largest=True, sorted=True).indices
        sel = torch.gather(tokens, 1,
                           idx[:, :, None].expand(-1, -1, tokens.shape[-1]))
        return sel, idx

    @staticmethod
    def scatter(tokens, idx, updates):
        index = idx[:, :, None].expand(-1, -1, tokens.shape[-1])
        return torch.scatter(tokens, 1, index, updates)

    # -- blocks --

    def en_block(self, x, name):
        """Pre-activation: [IN -> ReLU -> conv] x2 + x."""
        self.note_norm(x, False)
        y = self.conv(torch.relu(self.instance_norm(x)), f"{name}.conv1")
        self.note_norm(y, False)
        y = self.conv(torch.relu(self.instance_norm(y)), f"{name}.conv2")
        return y + x

    def de_block(self, x, name):
        """Post-activation: [conv -> IN -> LeakyReLU] x2, + x after."""
        y = self.conv(x, f"{name}.conv1")
        self.note_norm(y, False)
        y = self.conv(self.lrelu(self.instance_norm(y)), f"{name}.conv2")
        self.note_norm(y, True)
        return self.lrelu(self.instance_norm(y)) + x

    def note_norm(self, x, residual):
        """Record a norm site of a residual block (the port's K1 calls)."""
        if self.record is not None:
            self.record.append(dict(norm="block", x=tuple(x.shape),
                                    residual=residual))

    def head(self, name, pre, feats, scale):
        out = {}
        for r, f in zip(REGIONS, feats):
            y = self.conv(f, f"{name}.{pre}supervise_label_{r[1]}")
            y = self.conv(y, f"{name}.{pre}down_label_{r[1]}")
            out[r] = torch.softmax(self.upsample(y, scale), dim=-1)
        return out

    def attention(self, x, x2, name, drop):
        g = self.g
        hs, h = g["token"], g["heads"]
        d = hs // h
        b, n, _ = x.shape
        n2 = x2.shape[1]
        qn = self.dense(x, f"{name}.qkv", slice(0, hs)).reshape(b, n, h, d)
        kv = self.dense(x2, f"{name}.qkv", slice(hs, 3 * hs)).reshape(
            b, n2, 2, h, d)
        k, v = kv[:, :, 0], kv[:, :, 1]
        att = torch.einsum("bxhd,byhd->bhxy", self.q(qn), self.q(k)) * (
            d ** -0.5)
        att = drop(torch.softmax(att, dim=-1), g["attn_dropout"])
        out = torch.einsum("bhxy,byhd->bxhd", self.q(att), self.q(v))
        out = self.dense(out.reshape(b, n, hs), f"{name}.out_proj")
        return drop(out, g["attn_dropout"])

    def cross_block(self, x, x2, name, drop):
        a = f"{name}.cross_attention_list.0.fn"
        y = self.attention(self.layer_norm(x, f"{a}.norm"),
                           self.layer_norm(x2, f"{a}.norm2"), f"{a}.fn", drop)
        return drop(y, self.g["dropout"]) + x

    def ffn(self, x, name, drop):
        f = f"{name}.cross_ffn_list.0.fn"
        y = self.dense(self.layer_norm(x, f"{f}.norm"), f"{f}.fn.net.0")
        y = drop(F.gelu(y, approximate="none"), self.g["dropout"])
        return drop(self.dense(y, f"{f}.fn.net.3"), self.g["dropout"]) + x

    def route(self, tokens, query, class_token, pe, drop):
        sel, idx = self.topk(tokens, query, self.g["k"])
        sel = drop(sel + self.pe_row(pe), self.g["dropout"])
        ct = class_token.expand(tokens.shape[0], 1, -1)
        return torch.cat([ct, sel], dim=1), idx

    def pe_row(self, name):
        """The 'fixed' encoding: row 0 of the table, added to every token."""
        return self.p[f"{name}.pe"][0, 0]

    # -- the forward --

    def forward(self, x: torch.Tensor, generator=None):
        """x (B, D, H, W, C_in) float32 -> (seg probs, final sup, final edge
        sup, mid sup, mid edge sup), as the port returns them.  With a
        ``generator`` dropout runs (the training forward)."""
        g, drop = self.g, Dropout(generator)
        u = "Unet_list"
        y = self.conv(x, f"{u}.InitConv.conv")
        y = drop(y, g["init_dropout"], (y.shape[0], 1, 1, 1, y.shape[-1]))
        x1 = self.en_block(self.en_block(y, f"{u}.EnBlock1"),
                           f"{u}.EnBlock1_1")
        y = self.conv(x1, f"{u}.EnDown1.conv", stride=2)
        x2 = self.en_block(self.en_block(y, f"{u}.EnBlock2_1"),
                           f"{u}.EnBlock2_2")
        y = self.conv(x2, f"{u}.EnDown2.conv", stride=2)
        x3 = self.en_block(self.en_block(y, f"{u}.EnBlock3_1"),
                           f"{u}.EnBlock3_2")
        y = self.conv(x3, f"{u}.EnDown3.conv", stride=2)
        x4 = self.en_block(self.en_block(y, f"{u}.EnBlock4_1"),
                           f"{u}.EnBlock4_2")
        bottleneck = self.conv(x4, f"{u}.EnDown_4.conv")

        def act(t):
            return self.lrelu(self.instance_norm(t))
        x23 = torch.cat([self.conv(x2, "conv_64_to_32", stride=2), x3], -1)
        edge = {r: act(self.conv(x23, f"conv_mid_fea_{r[1]}"))
                for r in REGIONS}
        sem = {r: act(self.conv(bottleneck, f"conv_semantic_{r[1]}"))
               for r in REGIONS}

        mid_sup = self.head("mid_supervise_label", "",
                            [sem[r] for r in REGIONS], 8)
        mid_edge_sup = self.head("mid_edge_supervise_label", "edge_",
                                 [edge[r] for r in REGIONS], 4)
        k = g["k"]
        sem_grids, sem_tok, sup_sem, sup_edge = {}, {}, {}, {}
        for r in REGIONS:
            et = self.patchify(edge[r], g["edge_patch"])
            st = self.patchify(sem[r], g["sem_patch"])
            e_tok, s_tok = self.p[f"e_token_{r}"], self.p[f"s_token_{r}"]
            pe = f"label_{r}_position_encoding"
            edge_seq, idx_e = self.route(et, e_tok, e_tok, pe, drop)
            se_supple, _ = self.route(st, e_tok, s_tok, pe, drop)
            sem_seq, idx_s = self.route(st, s_tok, s_tok, pe, drop)
            edge_supple, _ = self.route(et, s_tok, e_tok, pe, drop)
            t = f"transformer_{r}"
            a = self.cross_block(edge_seq, se_supple, t, drop)
            b = self.cross_block(sem_seq, edge_supple, t, drop)
            ra = self.cross_block(a, b, t, drop)
            rb = self.cross_block(b, a, t, drop)
            res = self.ffn(torch.cat([ra, rb], dim=1), t, drop)
            edge_grid = self.scatter(et, idx_e, res[:, 1:k + 1])
            sem_grid = self.scatter(st, idx_s, res[:, k + 2:2 * (k + 1)])
            tok = res[:, k + 1:k + 2]
            sup_edge[r] = self.unpatchify(res[:, 0:1] * edge_grid,
                                          g["edge_ch"], g["edge_size"],
                                          g["edge_patch"])
            sup_sem[r] = self.unpatchify(tok * sem_grid, g["sem_ch"],
                                         g["sem_size"], g["sem_patch"])
            sem_grids[r], sem_tok[r] = sem_grid, tok
        final_sup = self.head("supervise_label", "",
                              [sup_sem[r] for r in REGIONS], 8)
        final_edge_sup = self.head("edge_supervise_label", "edge_",
                                   [sup_edge[r] for r in REGIONS], 4)

        fusion_token = sum(sem_tok[r] for r in REGIONS)
        fusion_feature = sum(sem_grids[r] for r in REGIONS)
        sel, fidx = self.topk(fusion_feature, fusion_token, k)
        sel = drop(sel + self.pe_row("fusion_label_pos"), g["dropout"])
        t = "fusion_transformer_1_2_4"
        seq = torch.cat([fusion_token, sel], dim=1)
        res = self.ffn(self.cross_block(seq, seq, t, drop), t, drop)
        fused = res[:, 0:1] * self.scatter(fusion_feature, fidx,
                                           res[:, 1:k + 1])
        enc = self.unpatchify(fused, g["sem_ch"], g["sem_size"],
                              g["sem_patch"])
        y = self.conv(enc, "sum_fusion")

        d = "decoder"
        y = self.conv(y, f"{d}.down_channel", padding=0)
        y = self.de_block(self.de_block(y, f"{d}.Enblock8_1"),
                          f"{d}.Enblock8_2")
        for up, skip, blocks in (("DeUp4", x3, ("DeBlock4", "DeBlock4_1")),
                                 ("DeUp3", x2, ("DeBlock3", "DeBlock3_1")),
                                 ("DeUp2", x1, ("DeBlock2", "DeBlock2_1"))):
            y = self.conv(y, f"{d}.{up}.conv1", padding=0)
            y = self.conv(y, f"{d}.{up}.conv2", stride=2, transposed=True)
            y = self.conv(torch.cat([skip, y], dim=-1), f"{d}.{up}.conv3",
                          padding=0)
            for blk in blocks:
                y = self.de_block(y, f"{d}.{blk}")
        seg = torch.softmax(self.conv(y, f"{d}.endconv", padding=0), dim=-1)
        return seg, final_sup, final_edge_sup, mid_sup, mid_edge_sup
