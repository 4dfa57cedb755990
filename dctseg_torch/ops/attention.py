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

K8, :func:`fused_window_attention` (the operator
``torch.ops.dctseg.fused_window_attention``), is Swin UNETR's
shifted-window attention (``models/swin_unetr.py``): softmax(q k^T * scale
+ bias + mask) v over every (window, head), the relative-position bias
gathered inside the kernel from the learned table by MONAI's index
(:func:`relative_position_index`) and the shift mask worked out from
per-token region ids, on CUDA by ``window_attention_kernel`` of
``csrc/attention.cu`` (bf16 and f16; no other kernel takes a CUDA call),
on the CPU by :func:`fused_window_attention_plain`.  f32 scores, softmax
and p.v; only the output is cast.  Inference only: it has no gradient.
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


# ---- K8: shifted-window attention ----

WINDOW_HEAD_DIMS = (16, 32, 64)      # csrc/attention.cu dispatch_window
WINDOW_MAX_SIDE = 8                  # csrc/attention.cu kWinMaxSide
MASK_VALUE = -100.0                  # MONAI's shift-mask value


def relative_position_index(ws: int, n: int | None = None) -> torch.Tensor:
    """MONAI's ``relative_position_index`` of a ws^3 window, (n, n) int64
    (its first n tokens; n = ws^3 by default): row (2ws-1)^2 * (d_i - d_j +
    ws - 1) + (2ws-1) * (h_i - h_j + ws - 1) + (w_i - w_j + ws - 1) of the
    bias table."""
    r = torch.arange(ws)
    c = torch.stack(torch.meshgrid(r, r, r, indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (ws - 1)
    side = 2 * ws - 1
    idx = rel[..., 0] * side * side + rel[..., 1] * side + rel[..., 2]
    n = ws ** 3 if n is None else n
    return idx[:n, :n]


def fused_window_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, table: torch.Tensor,
                                 ids: torch.Tensor | None, scale: float,
                                 ws: int) -> torch.Tensor:
    """Plain version of K8, all in f32: softmax(q k^T * scale + bias +
    mask) v, the output cast to q's dtype, as a contiguous (BW, N, H, D)
    tensor."""
    bw, h, n, d = q.shape
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    idx = relative_position_index(ws, n).to(table.device)
    s = s + table.float()[idx].permute(2, 0, 1)[None]
    if ids is not None:
        nw = ids.shape[0]
        i = ids.long()
        mask = torch.where(i[:, :, None] != i[:, None, :], MASK_VALUE, 0.0)
        s = (s.reshape(bw // nw, nw, h, n, n) + mask[None, :, None]
             ).reshape(bw, h, n, n)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhnm,bhmd->bnhd", p, v.float())
    return o.to(q.dtype).contiguous()


def _check_window(q, k, v, table, ids, ws):
    _check(q, k, v)
    bw, h, n, d = q.shape
    if k.shape != q.shape:
        raise ValueError(f"q, k and v of one window share their shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if not 1 <= ws <= WINDOW_MAX_SIDE or n > ws ** 3:
        raise ValueError(f"{n} tokens a window do not fit a {ws}^3 window "
                         f"(ws at most {WINDOW_MAX_SIDE})")
    side = 2 * ws - 1
    if table.shape != (side ** 3, h) or table.dtype != torch.float32 or \
            table.device != q.device:
        raise ValueError(f"the bias table must be f32 ({side ** 3}, {h}) on "
                         f"q's device; got {tuple(table.shape)} "
                         f"{table.dtype}")
    if ids is not None and (ids.dim() != 2 or ids.shape[1] != n
                            or bw % ids.shape[0] or ids.dtype != torch.int8
                            or ids.device != q.device):
        raise ValueError(f"region ids must be int8 (nW, {n}) on q's device "
                         f"with nW dividing {bw}; got {tuple(ids.shape)} "
                         f"{ids.dtype}")


def _window_launch(q, k, v, table, ids, scale, ws):
    """Launch K8 on (BW, H, N, D) views; the output is a contiguous
    (BW, N, H, D) tensor.  Raises where the kernel cannot take the call."""
    bw, h, n, d = q.shape
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if qs[3] != 1 or ks[3] != 1 or vs[3] != 1:
        raise ValueError("the window attention kernel takes views with unit "
                         "stride on the head dimension")
    if q.dtype not in _MMA_DTYPES or d not in WINDOW_HEAD_DIMS:
        raise ValueError(f"the window attention kernel takes bf16 or f16 "
                         f"with D in {WINDOW_HEAD_DIMS}; got {q.dtype}, "
                         f"D={d}")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    strides = (*qs[:3], *ks[:3], *vs[:3])
    low = 0
    for x in strides:
        low |= x
    if (ptrs[0] | ptrs[1] | ptrs[2]) & 15 or low & 7:
        raise ValueError("the window attention kernel takes rows on 16-byte "
                         "boundaries")
    if ids is not None and not ids.is_contiguous():
        ids = ids.contiguous()
    out = q.new_empty((bw, n, h, d))
    if out.numel() == 0:
        return out
    nw = 1 if ids is None else ids.shape[0]
    args = array.array("q", (
        *ptrs, out.data_ptr(), table.data_ptr(),
        0 if ids is None else ids.data_ptr(), bw, h, n, d, nw, ws, *strides,
        *table.stride(), _build.dtype_code(q.dtype)))
    _build.check(_build.lib().dctseg_window_attention_fwd(
        args.buffer_info()[0], scale, _build.stream_of(q)),
        "window attention")
    fused_window_attention.launches += 1
    return out


def _window_cpu(q, k, v, table, ids, scale, ws):
    return fused_window_attention_plain(q, k, v, table, ids, scale, ws)


def _window_fake(q, k, v, table, ids, scale, ws):
    bw, h, n, d = q.shape
    return q.new_empty((bw, n, h, d))


_WINDOW_OP = library.define(
    "fused_window_attention",
    "(Tensor q, Tensor k, Tensor v, Tensor table, Tensor? ids, float scale, "
    "int ws) -> Tensor",
    cuda=_window_launch, cpu=_window_cpu, fake=_window_fake)


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           table: torch.Tensor, ids: torch.Tensor | None,
                           scale: float, ws: int) -> torch.Tensor:
    """K8: softmax(q k^T * scale + bias + mask) v over the windows of a
    Swin block.  q, k, v: (BW, H, N, D), BW = batch x windows (batch
    major), any strides on BW, H and N, on CUDA unit stride on D.
    ``table``: the f32 (2ws-1)^3 x H relative-position bias table, read by
    :func:`relative_position_index` of a ws^3 window.  ``ids``: (nW, N)
    int8 region ids of the shifted block (-100 where two tokens' ids
    differ), or None.  Returns a contiguous (BW, N, H, D) tensor in q's
    dtype (the heads merged by a reshape).  Inference only."""
    _check_window(q, k, v, table, ids, ws)
    return library.call(_WINDOW_OP, q, k, v, table, ids, scale, ws)


fused_window_attention.launches = 0   # kernel launches on CUDA tensors
