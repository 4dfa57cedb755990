"""Fused attention forward: the port of the TPU kernel
``dctseg/ops/pallas/attention.py`` ``fused_attention``.

On a CUDA tensor the wrapper launches the hand-written kernel of
``dctseg_torch/csrc/attention.cu`` or raises; on a CPU tensor it runs the
plain PyTorch version below.  Both keep the scores, the softmax and p.v in
f32 and cast only the output to q's dtype -- the Pallas kernel's bf16
semantics, not those of the JAX package's einsum path, which casts p to the
input dtype before p.v (``dctseg/models/attention.py``).

The kernel has no backward yet: ``_FusedAttention.backward`` raises until
the training slice (ROADMAP A6) brings one, as the TPU kernel's custom VJP
did.
"""

from __future__ import annotations

import torch

from dctseg_torch.ops import _build

MAX_HEAD_DIM = 128
_WARPS = 8                  # csrc/attention.cu kWarps
_MAX_SMEM = 232448          # bytes of shared memory a block may opt into


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 scores, softmax and p.v."""
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p, v.float()).to(q.dtype)


def _smem_bytes(n2: int, d: int) -> int:
    return (n2 * (2 * d + 1) + _WARPS * (d + n2)) * 4


def _check(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or k.shape[2] == 0:
        raise ValueError(
            f"expected q (B, H, N, D) and k, v (B, H, N2, D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share one device")


def _launch(q, k, v, scale):
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the attention kernel takes contiguous "
                         "(B, H, N, D) tensors")
    b, h, n, d = q.shape
    n2 = k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} above {MAX_HEAD_DIM}")
    if _smem_bytes(n2, d) > _MAX_SMEM:
        raise ValueError(f"K and V of one head ({n2} x {d}) do not fit "
                         "shared memory")
    dtype = _build.dtype_code(q.dtype)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.lib()
    stream = _build.stream_of(q)
    _build.check(lib.dctseg_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, n,
        n2, d, scale, dtype, stream), "attention")
    fused_attention.launches += 1
    return out


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the attention kernel has no backward yet; it comes with the "
            "training slice (ROADMAP A6)")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q: (B, H, N, D); k, v: (B, H, N2, D) -> (B, H, N, D) in q's dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _FusedAttention.apply(q, k, v, scale)


fused_attention.launches = 0   # kernel launches on CUDA tensors
