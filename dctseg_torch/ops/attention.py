"""Fused attention forward: the port of the TPU kernel
``dctseg/ops/pallas/attention.py`` ``fused_attention``.

The wrapper calls the operator ``torch.ops.dctseg.fused_attention``
(``ops/library.py``).  On a CUDA tensor the operator launches one of the two
hand-written kernels of ``dctseg_torch/csrc/attention.cu`` (tensor cores for
bf16 and f16, SIMT otherwise: :func:`uses_tensor_cores`) or raises; on a CPU
tensor it runs the plain PyTorch version below.  The operator returns a
fresh contiguous (B, N, H, D) tensor, the memory the kernel writes, and the
wrapper hands back its (B, H, N, D) view.  All keep the scores, the softmax and
p.v at f32 accuracy and cast only the output to q's dtype -- the Pallas
kernel's bf16 semantics, not those of the JAX package's einsum path, which
casts p to the input dtype before p.v (``dctseg/models/attention.py``).

The gradient is the TPU kernel's custom VJP: a recompute through that einsum
formulation (:func:`einsum_attention`) and its autograd gradient, on either
device.  The sequences are short (129 tokens), so the recompute costs less
than keeping the scores.  No backward kernel is owed.
"""

from __future__ import annotations

import array

import torch

from dctseg_torch.ops import _build, library

MAX_HEAD_DIM = 128
# The tensor-core kernel (csrc/attention.cu attention_mma_kernel) takes bf16
# and f16 with D a multiple of 16 up to MAX_HEAD_DIM, N2 up to MMA_MAX_KEYS
# (its scores live in registers) and rows on 16-byte boundaries; every
# other call goes to the SIMT kernel.
MMA_MAX_KEYS = 144          # csrc/attention.cu 16 * kMaxKey16
_WARPS = 8                  # csrc/attention.cu kWarps
_MAX_SMEM = 232448          # bytes of shared memory a block may opt into


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 scores, softmax and p.v."""
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p, v.float()).to(q.dtype)


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """The JAX package's einsum formulation: f32 scores and softmax, p cast
    to q's dtype, p.v accumulated in f32, the output cast to q's dtype."""
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", p.float(), v.float()).to(q.dtype)


def attention_vjp(q, k, v, scale, grad):
    """(dq, dk, dv): the gradient of :func:`einsum_attention` at (q, k, v)
    for the output cotangent ``grad``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = einsum_attention(*leaves, scale)
        return torch.autograd.grad(out, leaves, grad)


def _smem_bytes(n2: int, d: int) -> int:
    return (n2 * (2 * d + 1) + _WARPS * (d + n2)) * 4


def _check(q, k, v):
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape or ks[0] != qs[0] \
            or ks[1] != qs[1] or ks[3] != qs[3] or ks[2] == 0:
        raise ValueError(
            f"expected q (B, H, N, D) and k, v (B, H, N2, D); got "
            f"{tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share one dtype")
    if not (q.get_device() == k.get_device() == v.get_device()
            and q.is_cuda == k.is_cuda == v.is_cuda):
        raise ValueError("q, k and v must share one device")
    if not q.is_cuda and q.device.type != "cpu":
        raise ValueError(f"no kernel for device {q.device}")


_MMA_DTYPES = (torch.bfloat16, torch.float16)


def _mma_rule(dtype, d, n2, ptrs, strides) -> bool:
    aligned = 0
    for x in strides:
        aligned |= x
    return (dtype in _MMA_DTYPES and d % 16 == 0 and d <= MAX_HEAD_DIM
            and n2 <= MMA_MAX_KEYS and not (ptrs[0] | ptrs[1] | ptrs[2]) & 15
            and not aligned & 7)


def uses_tensor_cores(q, k, v) -> bool:
    """The dispatch rule: the tensor-core kernel for bf16 and f16 with D a
    multiple of 16 up to MAX_HEAD_DIM, N2 <= MMA_MAX_KEYS and every row
    start on a 16-byte boundary (the cp.async copies); the SIMT kernel
    otherwise."""
    return _mma_rule(q.dtype, q.shape[3], k.shape[2],
                     (q.data_ptr(), k.data_ptr(), v.data_ptr()),
                     (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]))


def _launch(q, k, v, scale):
    """Launch a kernel on (B, H, N, D) views with unit stride on D; the
    output is a contiguous (B, N, H, D) tensor.  The host path is kept
    short: at the model's shape the kernel takes a few microseconds, so the
    host's checks and the ctypes call set the time of a call."""
    b, h, n, d = q.shape
    n2 = k.shape[2]
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if qs[3] != 1 or ks[3] != 1 or vs[3] != 1:
        raise ValueError("the attention kernel takes views with unit stride "
                         "on the head dimension")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} above {MAX_HEAD_DIM}")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    strides = (*qs[:3], *ks[:3], *vs[:3])
    mma = _mma_rule(q.dtype, d, n2, ptrs, strides)
    if not mma and _smem_bytes(n2, d) > _MAX_SMEM:
        raise ValueError(f"K and V of one head ({n2} x {d}) do not fit "
                         "shared memory")
    out = q.new_empty((b, n, h, d))
    if out.numel() == 0:
        return out
    args = array.array("q", (*ptrs, out.data_ptr(), b, h, n, n2, d, *strides,
                             _build.dtype_code(q.dtype), mma))
    _build.check(_build.lib().dctseg_attention_fwd(
        args.buffer_info()[0], scale, _build.stream_of(q)), "attention")
    fused_attention.launches += 1
    fused_attention.kernel_launches["mma" if mma else "simt"] += 1
    return out


def _cpu(q, k, v, scale):
    return fused_attention_plain(q, k, v, scale).transpose(1, 2).contiguous()


def _fake(q, k, v, scale):
    b, h, n, d = q.shape
    return q.new_empty((b, n, h, d))


def _setup_context(ctx, inputs, output):
    q, k, v, ctx.scale = inputs
    ctx.save_for_backward(q, k, v)


def _backward(ctx, grad):
    """The TPU kernel's custom VJP: :func:`attention_vjp` at the saved
    inputs, for the cotangent of the (B, N, H, D) output."""
    q, k, v = ctx.saved_tensors
    return (*attention_vjp(q, k, v, ctx.scale, grad.transpose(1, 2)), None)


_OP = library.define(
    "fused_attention", "(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
    cuda=_launch, cpu=_cpu, fake=_fake, backward=_backward,
    setup_context=_setup_context)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q: (B, H, N, D); k, v: (B, H, N2, D) -> (B, H, N, D) in q's dtype, a
    view of contiguous (B, N, H, D) memory.  Any strides on B, H and N; on
    CUDA, unit stride on D."""
    _check(q, k, v)
    return library.call(_OP, q, k, v, scale).transpose(1, 2)


# kernel launches on CUDA tensors: in all, and by kernel
fused_attention.launches = 0
fused_attention.kernel_launches = {"mma": 0, "simt": 0}
