"""The on-path kernels as ``torch.ops.dctseg`` operators, on the CPU.

Each operator's CPU implementation equals its kernel's plain version bit
for bit; its fake implementation gives the shape, dtype and strides of the
real output; ``torch.library.opcheck`` passes; the gradients through the
operators are those the wrappers gave before they became operators (the
attention VJP, the relayout's inverse, the plain norm's autograd).  The
CUDA implementations, the kernels' launch paths, are held against the plain
versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from dctseg_torch.ops import attention as attn
from dctseg_torch.ops import fusednorm, quant, relayout

OPS = {
    "fused_instance_norm_act": torch.ops.dctseg.fused_instance_norm_act,
    "fused_attention": torch.ops.dctseg.fused_attention,
    "space_to_depth": torch.ops.dctseg.space_to_depth,
    "int8_conv3d": torch.ops.dctseg.int8_conv3d,
    "quantize_absmax": torch.ops.dctseg.quantize_absmax,
}


def _normal(*shape, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dtype)


def _qkv_views(dtype, b=2, n=9, h=3, d=8):
    """q, k, v as the model makes them: (B, H, N, D) views of one
    (B, N, 3, H, D) projection."""
    base = _normal(b, n, 3, h, d, seed=1, dtype=dtype)
    return tuple(base[:, :, i].transpose(1, 2) for i in range(3))


def _cases():
    """(id, operator name, operator args, the plain result)."""
    x, res = _normal(2, 4, 4, 4, 32), _normal(2, 4, 4, 4, 32, seed=2)
    xb = _normal(1, 4, 4, 4, 16, dtype=torch.bfloat16)
    yield ("norm_res_f32", "fused_instance_norm_act",
           (x, res, 4, 1e-5, "relu", 0.01),
           fusednorm.fused_instance_norm_act_plain(x, 4, 1e-5, "relu", 0.01,
                                                   res))
    yield ("norm_bf16", "fused_instance_norm_act",
           (xb, None, 16, 1e-5, "lrelu", 0.01),
           fusednorm.fused_instance_norm_act_plain(xb, 16, 1e-5, "lrelu",
                                                   0.01))
    q = _normal(2, 3, 9, 8, seed=3)
    k, v = _normal(2, 3, 5, 8, seed=4), _normal(2, 3, 5, 8, seed=5)
    yield ("attention_f32", "fused_attention", (q, k, v, 0.3),
           attn.fused_attention_plain(q, k, v, 0.3).transpose(1, 2))
    qs, ks, vs = _qkv_views(torch.bfloat16)
    yield ("attention_bf16_views", "fused_attention", (qs, ks, vs, 8 ** -0.5),
           attn.fused_attention_plain(qs, ks, vs, 8 ** -0.5).transpose(1, 2))
    xr = _normal(2, 4, 6, 8, 3, seed=6)
    yield ("relayout_cast", "space_to_depth", (xr, torch.bfloat16),
           relayout.space_to_depth_plain(xr, torch.bfloat16))
    x2 = _normal(1, 2, 2, 2, 4, seed=7)
    yield ("relayout_extent2", "space_to_depth", (x2, torch.float32),
           relayout.space_to_depth_plain(x2, torch.float32))
    xq, stats = quant.quantize_absmax_plain(_normal(2, 5, 4, 3, 16, seed=8))
    wq, sw = quant.prepare_weight(_normal(24, 16, 3, 3, 3, seed=9))
    bias = _normal(24, seed=10, dtype=torch.bfloat16)
    for name, stride, pads, b, dt in (
            ("int8_conv_bf16_bias", [1, 1, 1], [1] * 6, bias,
             torch.bfloat16),
            ("int8_conv_f32_s2_p10", [2, 2, 2], [1, 0] * 3, None,
             torch.float32)):
        yield (name, "int8_conv3d", (xq, stats, wq, sw, b, stride, pads, dt),
               quant.int8_conv3d_plain(xq, stats, wq, sw, b, stride,
                                       [pads[0:2], pads[2:4], pads[4:6]], dt))


CASES = list(_cases())
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_operator_on_cpu_equals_plain(case):
    _, name, args, want = case
    got = OPS[name](*args)
    assert got.dtype == want.dtype and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # no output aliases an input (the extent-2 relayout moves nothing)
    ptrs = {a.untyped_storage().data_ptr() for a in args
            if isinstance(a, torch.Tensor)}
    assert got.untyped_storage().data_ptr() not in ptrs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fake_matches_real_output(case):
    _, name, args, _ = case
    real = OPS[name](*args)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
        fake = OPS[name](*fake_args)
    assert (fake.shape, fake.dtype, fake.stride()) == (
        real.shape, real.dtype, real.stride())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_opcheck(case):
    _, name, args, _ = case
    torch.library.opcheck(OPS[name].default, args)


def test_quantize_operator_outputs():
    """quantize_absmax's two outputs: on the CPU its plain version's; under
    a FakeTensorMode the real outputs' shapes, dtypes and strides."""
    x = _normal(2, 5, 4, 3, 16, seed=11, dtype=torch.bfloat16)
    real = OPS["quantize_absmax"](x)
    for got, want in zip(real, quant.quantize_absmax_plain(x)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with FakeTensorMode() as mode:
        fake = OPS["quantize_absmax"](mode.from_tensor(x))
    assert [(t.shape, t.dtype, t.stride()) for t in fake] == [
        (t.shape, t.dtype, t.stride()) for t in real]
    torch.library.opcheck(OPS["quantize_absmax"].default, (x,))


@pytest.mark.parametrize("name", sorted(OPS))
def test_operators_have_cuda_cpu_and_fake_kernels(name):
    qualname = f"dctseg::{name}"
    for key in ("CUDA", "CPU", "Meta", "Autograd"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qualname, key)


def _grads(fn, *inputs, cotangent):
    leaves = [t.clone().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, cotangent)


def test_attention_gradient_is_the_vjp():
    q, k, v = (_normal(2, 3, 7, 8, seed=s) for s in (8, 9, 10))
    go = _normal(2, 3, 7, 8, seed=11)
    got = _grads(lambda *t: attn.fused_attention(*t, 0.4), q, k, v,
                 cotangent=go)
    for a, b in zip(got, attn.attention_vjp(q, k, v, 0.4, go)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_relayout_gradient_is_the_inverse_relayout():
    x = _normal(1, 4, 4, 6, 3, seed=12)
    ct = _normal(1, 2, 2, 3, 24, seed=13)
    got, = _grads(lambda t: relayout.space_to_depth(t, torch.bfloat16)
                  .float(), x, cotangent=ct)
    want, = _grads(lambda t: relayout.space_to_depth_plain(
        t, torch.bfloat16).float(), x, cotangent=ct)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_norm_gradient_is_the_plain_versions():
    x, res = _normal(2, 4, 4, 4, 32, seed=14), _normal(2, 4, 4, 4, 32, seed=15)
    ct = _normal(2, 4, 4, 4, 32, seed=16)
    got = _grads(lambda a, r: fusednorm.fused_instance_norm_act(
        a, 4, act="lrelu", residual=r), x, res, cotangent=ct)
    want = _grads(lambda a, r: fusednorm.fused_instance_norm_act_plain(
        a, 4, act="lrelu", residual=r), x, res, cotangent=ct)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
