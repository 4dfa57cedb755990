"""The port's on-path kernels as torch operators in the ``dctseg``
namespace: ``torch.ops.dctseg.fused_instance_norm_act``,
``torch.ops.dctseg.fused_attention``,
``torch.ops.dctseg.fused_window_attention``, ``torch.ops.dctseg.space_to_depth``,
the int8 pair ``torch.ops.dctseg.quantize_absmax`` /
``torch.ops.dctseg.int8_conv3d`` and K9's three LayerNorm routes
``torch.ops.dctseg.layer_norm_to_windows``,
``torch.ops.dctseg.windows_residual_layer_norm`` and
``torch.ops.dctseg.layer_norm``.

Each kernel module defines its operator here when it is imported:

  * a schema;
  * a CUDA implementation, the kernel's launch path (plan, alignment and the
    ``ctypes`` call, which read pointers and so run only on real tensors);
  * a CPU implementation, the kernel's plain PyTorch version;
  * a fake implementation, which gives the output's shape, dtype and strides
    without running anything, for ``torch.export`` and FakeTensors;
  * the backward, through ``torch.library.register_autograd``; an operator
    defined without one (the int8 pair, inference only) gets a backward
    that raises, and one that writes an input in place (a ``Tensor(a!)``
    argument, which ``register_autograd`` refuses) an autograd kernel that
    raises where a gradient is asked for and otherwise hands the call on.

Each operator whose kernel does matrix work also has a flop formula for
``torch.utils.flop_counter.FlopCounterMode`` (``utils/profiling.py``
``flops_of``): the attention 4*B*H*N*N2*D (two products of 2*N*N2*D a
head), the window attention 4*BW*H*N^2*D, the int8 conv 2 * its multiply-accumulates.  The norms, the
quantizer and the relayout have none and count 0, as FlopCounterMode
counts elementwise work.

As operators the kernels survive ``torch.export`` as one graph node each, so
a serving bundle (``dctseg_torch/infer/serving.py``) carries them, and the
eager model calls the same operators: there is one route.  The operators are
plain ``torch.library.Library`` registrations, not ``custom_op``: the
dispatcher calls the Python implementations with the least host time per
call (PERF.md).  The backward's autograd kernel is a Python function too:
:func:`call` goes past it where no gradient is asked for.
"""

from __future__ import annotations

from typing import Callable, Optional

import math

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "dctseg"
LIB = torch.library.Library(NAMESPACE, "DEF")


def attention_flops(q_shape, k_shape, v_shape, scale, *, out_shape=None,
                    **kwargs) -> int:
    """softmax(q k^T) v on q (B, H, N, D), k and v (B, H, N2, D)."""
    b, h, n, d = q_shape
    return 4 * b * h * n * k_shape[2] * d


def window_attention_flops(q_shape, k_shape, v_shape, table_shape, ids_shape,
                           scale, ws, *, out_shape=None, **kwargs) -> int:
    """K8's two products on q, k, v (BW, H, N, D): 4*BW*H*N^2*D."""
    b, h, n, d = q_shape
    return 4 * b * h * n * k_shape[2] * d


def int8_conv_flops(xq_shape, stats_shape, wq_shape, *args, out_shape=None,
                    **kwargs) -> int:
    """2 * MACs: every output element (N, Do, Ho, Wo, Co) sums k^3 * Ci
    products (wq in K6's (Co, k, k, k, Ci) layout)."""
    return 2 * math.prod(out_shape) * math.prod(wq_shape[1:])


FLOP_FORMULAS = {"fused_attention": attention_flops,
                 "fused_window_attention": window_attention_flops,
                 "int8_conv3d": int8_conv_flops}


def define(name: str, schema: str, *, cuda: Callable, cpu: Callable,
           fake: Callable, backward: Optional[Callable] = None,
           setup_context: Optional[Callable] = None
           ) -> torch._ops.OpOverload:
    """Define ``dctseg::<name><schema>`` with its implementations; return
    its overload, the callable the wrappers use."""
    LIB.define(name + schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    qualname = f"{NAMESPACE}::{name}"
    torch.library.register_fake(qualname, fake, lib=LIB)
    if backward is None and "(a!)" in schema:
        def refuse(*args):
            if _asks_gradient(args):
                raise RuntimeError(f"{qualname} is inference only: it has "
                                   "no gradient")
            with torch._C._AutoDispatchBelowAutograd():
                return packet.default(*args)
        LIB.impl(name, refuse, "Autograd")
    else:
        if backward is None:
            def backward(ctx, *grads):
                raise RuntimeError(f"{qualname} is inference only: it has "
                                   "no gradient")
        torch.library.register_autograd(qualname, backward,
                                        setup_context=setup_context, lib=LIB)
    packet = getattr(getattr(torch.ops, NAMESPACE), name)
    if name in FLOP_FORMULAS:
        register_flop_formula(packet)(FLOP_FORMULAS[name])
    return packet.default


def _asks_gradient(args) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


def call(op: torch._ops.OpOverload, *args):
    """``op(*args)``, past the operator's autograd kernel where no gradient
    is asked for: that kernel, a Python function, would only hand the call
    on, at ~10 us of host time (PERF.md).  Under ``torch.inference_mode()``
    the dispatcher skips it itself."""
    if torch.is_inference_mode_enabled() or _asks_gradient(args):
        return op(*args)
    with torch._C._AutoDispatchBelowAutograd():
        return op(*args)
