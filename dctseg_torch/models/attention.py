"""Cross/self attention and transformer blocks of the couplers (the JAX
package's ``dctseg/models/attention.py``).

``DualSelfAttention``: one QKV projection (no bias) shared by both inputs,
Q from ``x``, K/V from ``x2``, then an output projection.  The
intra-region coupler applies one weight-shared cross-attention block four
times, concatenates both streams and runs a weight-shared FFN; the
cross-region coupler is the same attention on (x, x) plus the FFN.

Submodule names are the reference's (``cross_attention_list.0.fn.norm``,
``...fn.fn.qkv``, ``cross_ffn_list.0.fn.fn.net.0`` ...).  Dropout runs only
in training, which is not ported yet, so it is absent here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dctseg_torch.models.layers import Dense, LayerNorm
from dctseg_torch.ops.attention import fused_attention


class DualSelfAttention(nn.Module):
    """Shared-QKV cross attention: Q from x, K/V from x2."""

    def __init__(self, hidden_size, num_heads, dtype, use_kernel,
                 generator=None):
        super().__init__()
        self.hidden, self.heads, self.use_kernel = (hidden_size, num_heads,
                                                    use_kernel)
        self.qkv = Dense(hidden_size, 3 * hidden_size, use_bias=False,
                         dtype=dtype, generator=generator)
        self.out_proj = Dense(hidden_size, hidden_size, dtype=dtype,
                              generator=generator)

    def forward(self, x, x2):
        hs, h = self.hidden, self.heads
        d = hs // h
        b, n, _ = x.shape
        n2 = x2.shape[1]
        # the q columns of qkv(x) and the k, v columns of qkv(x2)
        q = self.qkv(x, slice(0, hs)).reshape(b, n, h, d)
        kv = self.qkv(x2, slice(hs, 3 * hs)).reshape(b, n2, 2, h, d)
        k, v = kv[:, :, 0], kv[:, :, 1]
        scale = d ** -0.5
        if self.use_kernel:
            out = fused_attention(q.transpose(1, 2).contiguous(),
                                  k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(), scale)
            out = out.transpose(1, 2)
        else:
            # the JAX package's einsum path: f32 scores and softmax, p cast
            # to the input dtype, p.v accumulated in f32
            att = torch.einsum("bxhd,byhd->bhxy", q.float(), k.float()) * scale
            att = torch.softmax(att, dim=-1).to(x.dtype)
            out = torch.einsum("bhxy,byhd->bxhd", att.float(), v.float())
        out = out.reshape(b, n, hs).to(x.dtype)
        return self.out_proj(out)


class _PreNormDrop(nn.Module):
    """Both attention inputs LayerNormed with separate norms."""

    def __init__(self, dim, heads, dtype, use_kernel, generator):
        super().__init__()
        self.norm, self.norm2 = LayerNorm(dim), LayerNorm(dim)
        self.fn = DualSelfAttention(dim, heads, dtype, use_kernel, generator)

    def forward(self, x, x2):
        return self.fn(self.norm(x), self.norm2(x2))


class CrossAttentionBlock(nn.Module):
    """Residual(PreNormDrop(DualSelfAttention)), residual from the Q
    stream."""

    def __init__(self, dim, heads, dtype, use_kernel, generator=None):
        super().__init__()
        self.fn = _PreNormDrop(dim, heads, dtype, use_kernel, generator)

    def forward(self, x, x2):
        return self.fn(x, x2) + x


class FeedForward(nn.Module):
    """Dense -> exact GELU -> Dense; ``net.0`` and ``net.3`` as in the
    reference's Sequential (its dropouts sit at 2 and 4)."""

    def __init__(self, dim, hidden_dim, dtype, generator=None):
        super().__init__()
        self.net = nn.ModuleDict({
            "0": Dense(dim, hidden_dim, dtype=dtype, generator=generator),
            "3": Dense(hidden_dim, dim, dtype=dtype, generator=generator)})

    def forward(self, x):
        return self.net["3"](F.gelu(self.net["0"](x), approximate="none"))


class _PreNorm(nn.Module):
    def __init__(self, dim, dtype, generator):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fn = FeedForward(dim, dim, dtype, generator)

    def forward(self, x):
        return self.fn(self.norm(x))


class FFNBlock(nn.Module):
    """Residual(PreNorm(FeedForward))."""

    def __init__(self, dim, dtype, generator=None):
        super().__init__()
        self.fn = _PreNorm(dim, dtype, generator)

    def forward(self, x):
        return self.fn(x) + x


class TwoClsWiseTransformer(nn.Module):
    """Edge-supported intra-region coupler:
      a = block(edge, sem_supple); b = block(sem, edge_supple)
      out = ffn(concat(block(a, b), block(b, a)))   # (B, 2(k+1), P)
    """

    def __init__(self, dim, heads, dtype, use_kernel, generator=None):
        super().__init__()
        self.cross_attention_list = nn.ModuleList(
            [CrossAttentionBlock(dim, heads, dtype, use_kernel, generator)])
        self.cross_ffn_list = nn.ModuleList([FFNBlock(dim, dtype, generator)])

    def forward(self, edge_fea, se_supple, semantic_fea, edge_supple):
        block = self.cross_attention_list[0]
        edge_q_sem = block(edge_fea, se_supple)
        sem_q_edge = block(semantic_fea, edge_supple)
        result_edge = block(edge_q_sem, sem_q_edge)
        result_sem = block(sem_q_edge, edge_q_sem)
        cross = torch.cat([result_edge, result_sem], dim=1)
        return self.cross_ffn_list[0](cross)


class FusionClsWiseTransformer(nn.Module):
    """Mutual cross-region coupler: self attention on (x, x) + FFN."""

    def __init__(self, dim, heads, dtype, use_kernel, generator=None):
        super().__init__()
        self.cross_attention_list = nn.ModuleList(
            [CrossAttentionBlock(dim, heads, dtype, use_kernel, generator)])
        self.cross_ffn_list = nn.ModuleList([FFNBlock(dim, dtype, generator)])

    def forward(self, x):
        y = self.cross_attention_list[0](x, x)
        return self.cross_ffn_list[0](y)
