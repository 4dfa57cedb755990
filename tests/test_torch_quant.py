"""The port's int8 post-training quantization against the JAX package's
(``dctseg/ops/quant.py``), on the CPU.

Ops: the spec grammar, the weight scales, the quantizer and the int8 conv
equal JAX's bit for bit (f32 and bf16; padding, stride, ragged channel
counts; half-way ties round to even).  The JAX ops run eagerly there, in the
op order they are written in, which the port follows: under ``jax.jit``
XLA rewrites ``amax / 127`` into ``amax * f32(1/127)`` and folds the two
scales' divisions into one constant, which moves sx and sx * sw[c] by an
ulp now and then.  The tile walk of K6's mma_sync route is rehearsed in
torch against ``F.conv3d``.  Layers: the s2d modules' int8 routes equal
JAX's modules bit for bit; the number of quantized convs per full-width
forward is the JAX rule's.  The tiny model under int8 is in
``test_torch_quant_model.py``.
"""
import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
import dctseg.models.clswiseformer as jax_cwf
from dctseg.models import unet as jax_unet
from dctseg.config import ModelConfig as JaxModelConfig
from dctseg.ops import quant as jax_quant
from dctseg.ops import s2d as jax_s2d
from dctseg.utils.torch_convert import _conv, _deconv

import dctseg_torch.models.clswiseformer as cwf
from dctseg_torch.config import (Config, DataConfig, ModelConfig,
                                 TrainConfig, tiny_model_config)
from dctseg_torch.models.layers import Conv3d
from dctseg_torch.models.unet import S2DConv3d, S2DDeconv
from dctseg_torch.ops import quant, s2d
from dctseg_torch.train.trainer import Trainer
from torch._subclasses.fake_tensor import FakeTensorMode

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _normal(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(t):
    return t.float().numpy()


# ---- the spec grammar ----

SPECS = ["none", "", "int8", "int8+pw", "int8+pw+deconv+down", "int8_all",
         "int8+deconv", "int8+pointwise", "fp8", "int8+pw+conv4"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("op", list(jax_quant.OP_CLASSES) + ["matmul"])
def test_enabled_matches_jax(spec, op):
    """Same answers and the same ValueErrors, message for message."""
    try:
        want = jax_quant.enabled(spec, op)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            quant.enabled(spec, op)
        assert str(got.value) == str(e)
        return
    assert quant.enabled(spec, op) == want


def test_constants_match_jax():
    assert quant.OP_CLASSES == jax_quant.OP_CLASSES
    assert quant._QMAX == jax_quant._QMAX
    assert quant.MIN_SPATIAL_ELEMS == jax_quant.MIN_SPATIAL_ELEMS == 0


def test_config_validates_the_spec():
    assert tiny_model_config(quantize="int8_all").quantize == "int8_all"
    with pytest.raises(ValueError, match="unknown quantize spec"):
        tiny_model_config(quantize="int4")
    with pytest.raises(ValueError, match="op class 'pointwise'"):
        tiny_model_config(quantize="int8+pointwise")


# ---- weights and activations ----

def test_weight_scales_and_quantize_symmetric_bit_exact():
    w = _normal(48, 40, 3, 3, 3, seed=1, scale=0.1)
    w[3] = 0.0                                     # an all-zero channel
    sw = quant.weight_scales(_t(w))
    jw = _conv(w)                                  # DHWIO
    jsw = np.asarray(jax_quant.weight_scales(jnp.asarray(jw)))
    np.testing.assert_array_equal(sw.numpy(), jsw)
    wq, sw2 = quant.prepare_weight(_t(w))
    assert wq.dtype == torch.int8 and wq.shape == (48, 3, 3, 3, 40)
    assert wq.is_contiguous() and torch.equal(sw, sw2)
    jwq = np.asarray(jax_quant.quantize_symmetric(jnp.asarray(jw),
                                                  jnp.asarray(jsw)))
    # K6's layout (Co, kd, kh, kw, Ci) is DHWIO moved O-first
    np.testing.assert_array_equal(wq.numpy(), jwq.transpose(4, 0, 1, 2, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rounds_half_to_even(dtype):
    """x / sx lands exactly on k + 1/2 (amax 127 makes sx = 1): torch.round
    and jnp.round go to the even neighbour; half away from zero would
    differ on every other tie."""
    k = np.arange(-126, 126, dtype=np.float32)
    x = np.concatenate([[127.0], k + 0.5, _normal(64, seed=2) * 40])
    xt = _t(x, dtype)
    xq, stats = quant.quantize_absmax(xt)
    assert stats.tolist() == [127.0, 1.0]
    want = np.round(x).astype(np.int8)             # numpy: half to even
    np.testing.assert_array_equal(xq.numpy()[:253], want[:253])
    away = (np.sign(k + 0.5) * np.floor(np.abs(k + 0.5) + 0.5)
            ).astype(np.int8)
    assert (xq.numpy()[1:253] != away).sum() == 126
    xj = jnp.asarray(x).astype(JNP[dtype]).astype(jnp.float32)
    jsx = jnp.maximum(jnp.max(jnp.abs(xj)), 1e-12) / 127.0
    jxq = jnp.clip(jnp.round(xj / jsx), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))


def test_quantize_propagates_nan_and_keeps_zero_input_finite():
    x = torch.zeros(2, 3, 4, 4, 8)
    xq, stats = quant.quantize_absmax(x)
    assert torch.equal(xq, torch.zeros_like(xq, dtype=torch.int8))
    assert stats.tolist() == [0.0, np.float32(1e-12) / np.float32(127.0)]
    x[0, 1, 2, 3, 4] = float("nan")
    _, stats = quant.quantize_absmax(x)
    assert torch.isnan(stats).all()


# ---- the int8 conv against JAX ----

CONV_CASES = {"k3_s1_p1": (3, 1, ((1, 1),) * 3),
              "k3_s2_p1": (3, 2, ((1, 1),) * 3),
              "k1_s1_p0": (1, 1, ((0, 0),) * 3),
              "k2_s1_p10": (2, 1, ((1, 0),) * 3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ci", [64, 72])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv3d_int8_bit_exact_with_jax(case, ci, dtype):
    k, stride, padding = CONV_CASES[case]
    x = _normal(2, 7, 6, 5, ci, seed=ci)
    w = _normal(24, ci, k, k, k, seed=k, scale=0.1)
    b = _normal(24, seed=5)
    xt = _t(x, dtype)
    got = quant.conv3d_int8(xt, _t(w), stride, padding)
    got_b = quant.conv3d_int8(xt, _t(w), stride, padding, bias=_t(b))
    xj = jnp.asarray(_np(xt)).astype(JNP[dtype])
    want = jax_quant.conv3d_int8(xj, jnp.asarray(_conv(w)), (stride,) * 3,
                                 padding)
    want_b = want + jnp.asarray(b).astype(want.dtype)
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    np.testing.assert_array_equal(_np(got_b), np.asarray(want_b, np.float32))


def test_plain_accumulation_is_exact_where_f32_is_not():
    """The plain K6 sums in float64: at Ci = 256, k = 3 the int32 sums pass
    2^24, where a float32 conv would round them."""
    xq = torch.full((1, 3, 3, 3, 256), 127, dtype=torch.int8)
    wq = torch.full((2, 3, 3, 3, 256), 127, dtype=torch.int8)
    wq[1, 0, 0, 0, 0] = 126
    stats, sw = torch.tensor([1.0, 1.0]), torch.ones(2)
    y = quant.int8_conv3d_plain(xq, stats, wq, sw, None, 1, 0,
                                torch.float32)
    acc = 127 * 127 * 27 * 256
    assert acc > 2 ** 24
    assert y[0, 0, 0, 0].tolist() == [np.float32(acc),
                                      np.float32(acc - 127)]


def test_conv3x3_s2d_int8_matches_jax_and_fine_stays_float():
    """Dense: the int8 conv over the transformed kernel, as JAX.  Fine (and
    auto at Ci >= 32): float under any spec, as JAX, not an error."""
    x8 = _normal(1, 4, 4, 4, 8 * 8, seed=6)
    w = _normal(8, 8, 3, 3, 3, seed=7, scale=0.2)
    got = s2d.conv3x3_s2d(_t(x8), _t(w), None, "dense", "int8")
    want = jax_s2d.conv3x3_s2d(jnp.asarray(x8), jnp.asarray(_conv(w)),
                               "dense", "int8")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x32 = _normal(1, 4, 4, 4, 8 * 32, seed=8)
    w32 = _normal(16, 32, 3, 3, 3, seed=9, scale=0.2)
    for strategy, xx, ww in (("fine", x8, w), ("auto", x32, w32)):
        fl = s2d.conv3x3_s2d(_t(xx), _t(ww), None, strategy)
        q = s2d.conv3x3_s2d(_t(xx), _t(ww), None, strategy, "int8_all")
        assert torch.equal(q, fl)
        jq = jax.jit(lambda a, k, s=strategy: jax_s2d.conv3x3_s2d(
            a, k, s, "int8"))(xx, _conv(ww))
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-5,
                                   rtol=1e-5)
    assert not S2DConv3d(8, 8, conv3="fine", quantize="int8_all").int8
    with pytest.raises(ValueError, match="quantize"):
        s2d.conv3d_s2d(_t(x8), s2d.conv_kernel(_t(w)), quantize="int8_all")


# The s2d modules' int8 routes against the JAX package's modules, run
# eagerly on the same fine parameters: (kernel size, stride, groups) of an
# S2DConv3d, or the S2DDeconv.  Bit for bit: the route's padding, its bias
# (tiled, or not on the down route) and the scales over the transformed
# kernel of the weight cast to the compute dtype.
S2D_MODULES = {"dense": (3, 1, ()), "pw": (1, 1, (8, 16)),
               "down": (3, 2, ()), "deconv": None}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("route", sorted(S2D_MODULES))
def test_s2d_modules_int8_bit_exact_with_jax(monkeypatch, route, dtype):
    gen = torch.Generator().manual_seed(11)
    co, spec = 8, S2D_MODULES[route]
    q = "int8" if route == "dense" else f"int8+{route}"   # its class only
    if spec is None:
        ci = 16
        port = S2DDeconv(ci, co, dtype=dtype, generator=gen,
                         quantize=q)
        jmod = jax_unet.S2DDeconv(co, dtype=JNP[dtype], quantize=q)
        x = _normal(2, 4, 4, 4, ci, seed=13)
    else:
        k, stride, groups = spec
        ci = sum(groups) or 8
        port = S2DConv3d(ci, co, k, stride, groups, dtype=dtype,
                         generator=gen, quantize=q)
        jmod = jax_unet.S2DConv3d(co, k, stride, groups, dtype=JNP[dtype],
                                  quantize=q)
        x = _normal(2, 4, 4, 4, 8 * ci, seed=13)
    with torch.no_grad():
        port.bias.copy_(_t(_normal(co, seed=14)))
    assert port.int8 and getattr(port, "route", "deconv") == route
    w, b = port.weight.detach().numpy(), port.bias.detach().numpy()
    name, conv = (("ConvTranspose_0", _deconv) if spec is None
                  else ("Conv_0", _conv))
    params = {"params": {name: {"kernel": jnp.asarray(conv(w)),
                                "bias": jnp.asarray(b)}}}
    xt = _t(x, dtype)
    calls = _count_calls(monkeypatch, quant, "int8_conv3d")
    with torch.inference_mode():
        got = port(xt)
    want = jmod.apply(params, jnp.asarray(_np(xt)).astype(JNP[dtype]))
    assert len(calls) == 1 and got.dtype == dtype
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


# ---- K6's tile walk, rehearsed in torch ----

def _rehearse_k6(xq, wq, stride, padding):
    """The mma_sync route's arithmetic in torch (the tma route's is in
    tests/test_torch_int8conv.py): the launch plan, each block's
    per-row receptive-field corners, the per-chunk (tap, channel) split of
    K with the padding, stride and ragged-K masks, the int64 products of the
    gathered tiles summed over the K stages, and the store masks."""
    n, d, h, w, ci = xq.shape
    co, k = wq.shape[0], wq.shape[1]
    pads = quant._pairs(padding)
    shape = quant.out_shape(xq.shape, wq.shape, stride, pads)
    plan = quant.plan_mma_sync(xq.shape, wq.shape, shape[1:4], 16)
    m_total, kdim = n * math.prod(shape[1:4]), k ** 3 * ci
    tm, tn, tk, vec = quant.TILE_M, quant.TILE_N, quant.TILE_K, plan.vec
    assert (plan.grid[0] - 1) * tm < m_total <= plan.grid[0] * tm
    assert (plan.grid[1] - 1) * tn < co <= plan.grid[1] * tn
    k_tiles = math.ceil(kdim / tk)              # the kernel's stage count
    x_flat, w_flat = xq.reshape(-1).long(), wq.reshape(co, -1).long()
    out = torch.full((m_total, co), -(2 ** 40), dtype=torch.long)
    od, oh, ow = shape[1:4]
    for bm in range(plan.grid[0]):
        m = bm * tm + torch.arange(tm)
        valid_m = m < m_total
        t = m.clone()
        ox, t = t % ow, t // ow
        oy, t = t % oh, t // oh
        oz, nb = t % od, t // od
        corner = [oz * stride[0] - pads[0][0], oy * stride[1] - pads[1][0],
                  ox * stride[2] - pads[2][0]]
        for bn in range(plan.grid[1]):
            c_out = bn * tn + torch.arange(tn)
            acc = torch.zeros(tm, tn, dtype=torch.long)
            for kt in range(k_tiles):
                kk = kt * tk + torch.arange(0, tk, vec)   # chunk starts
                k_ok = kk < kdim
                tap = torch.where(k_ok, kk // ci, 0)
                c = kk - tap * ci
                kd, rem = tap // (k * k), tap % (k * k)
                kh, kw = rem // k, rem % k
                z = corner[0][:, None] + kd
                y = corner[1][:, None] + kh
                x = corner[2][:, None] + kw
                ok = (k_ok & valid_m[:, None] & (z >= 0) & (z < d)
                      & (y >= 0) & (y < h) & (x >= 0) & (x < w))
                base = (((nb[:, None] * d + z) * h + y) * w + x) * ci + c
                # each chunk moves vec bytes, zero where masked
                idx = base[..., None] + torch.arange(vec)
                a = torch.where(ok[..., None],
                                x_flat[idx.clamp(0, x_flat.numel() - 1)], 0)
                a = a.reshape(tm, tk)
                w_ok = (c_out[:, None] < co) & k_ok[None, :]
                widx = kk[None, :, None] + torch.arange(vec)
                bt = torch.where(
                    w_ok[..., None],
                    w_flat[c_out.clamp(max=co - 1)[:, None, None],
                           widx.clamp(max=kdim - 1)], 0).reshape(tn, tk)
                acc += a @ bt.T
            keep = valid_m[:, None] & (c_out[None, :] < co)
            rows = m[:, None].expand(tm, tn)[keep]
            cols = c_out[None, :].expand(tm, tn)[keep]
            out[rows, cols] = acc[keep]
    return out.reshape(*shape[:4], co)


@pytest.mark.parametrize("k,stride,padding,ci,shape", [
    (3, (1, 1, 1), ((1, 1),) * 3, 96, (1, 5, 6, 7)),       # ragged K, M
    (3, (2, 2, 2), ((1, 1),) * 3, 64, (2, 9, 8, 7)),       # stride 2
    (2, (1, 1, 1), ((1, 0),) * 3, 32, (1, 6, 5, 6)),       # s2d down conv
    (1, (1, 1, 1), ((0, 0),) * 3, 40, (3, 4, 5, 7)),       # pointwise, vec 8
    (3, (2, 1, 2), ((1, 0), (1, 1), (0, 1)), 12, (1, 5, 6, 7))])
def test_k6_tile_walk_rehearsal_equals_conv(k, stride, padding, ci, shape):
    g = torch.Generator().manual_seed(ci)
    xq = torch.randint(-127, 128, (*shape, ci), generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (70, k, k, k, ci), generator=g,
                       dtype=torch.int8)
    got = _rehearse_k6(xq, wq, stride, padding)
    (dl, dh), (hl, hh), (wl, wh) = padding
    want = F.conv3d(F.pad(xq.permute(0, 4, 1, 2, 3).double(),
                          (wl, wh, hl, hh, dl, dh)),
                    wq.permute(0, 4, 1, 2, 3).double(), stride=stride)
    assert torch.equal(got, want.permute(0, 2, 3, 4, 1).long())


def test_k6_plan_vector_width():
    plan = quant.plan_int8_conv
    assert quant.plan_mma_sync((8, 32, 32, 32, 96), (32, 3, 3, 3, 96),
                               (32, 32, 32), 16) == \
        quant.Int8ConvPlan("mma_sync", (2048, 1), vec=16)
    assert plan((8, 32, 32, 32, 96), (32, 3, 3, 3, 96), (32, 32, 32),
                (1, 1, 1), 16).route == "tma"
    assert plan((1, 4, 4, 4, 72), (8, 3, 3, 3, 72), (4, 4, 4), (1, 1, 1),
                16) == quant.Int8ConvPlan("mma_sync", (1, 1), vec=8)
    assert plan((1, 4, 4, 4, 64), (8, 1, 1, 1, 64), (4, 4, 4), (1, 1, 1),
                4) == quant.Int8ConvPlan("mma_sync", (1, 1), vec=4)
    with pytest.raises(ValueError, match="multiple of 4"):
        plan((1, 4, 4, 4, 6), (8, 1, 1, 1, 6), (4, 4, 4), (1, 1, 1), 16)


# ---- layers ----

def test_conv3d_quantizes_by_the_jax_rule():
    for cin, k, spec, want in ((64, 3, "int8", True), (63, 3, "int8", False),
                               (64, 1, "int8", False), (64, 1, "int8+pw",
                                                        True),
                               (128, 1, "int8_all", True),
                               (64, 3, "none", False)):
        assert Conv3d(cin, 8, k, padding=k // 2, quantize=spec).int8 == want
    conv = Conv3d(64, 16, quantize="int8", generator=torch.Generator()
                  .manual_seed(0))
    x = _t(_normal(1, 4, 4, 4, 64, seed=3))
    want = quant.conv3d_int8(x, conv.weight, 1, 1, bias=conv.bias)
    with torch.no_grad():
        assert torch.equal(conv(x), want)


def test_spatial_gate_skips_quant_below_threshold(monkeypatch):
    """JAX's test of the same name: the gate ships inert; raised above
    4^3 it makes a gated conv run float, and only a gated one."""
    g = torch.Generator().manual_seed(0)
    float_conv = Conv3d(64, 64, generator=g)
    sd = float_conv.state_dict()
    x = _t(_normal(1, 4, 4, 4, 64, seed=3))

    def out(spec, gate):
        m = Conv3d(64, 64, quantize=spec, spatial_gate=gate)
        m.load_state_dict(sd)
        with torch.no_grad():
            return m(x)

    y_float, y_int8 = out("none", False), out("int8", False)
    assert (y_int8 - y_float).abs().max() > 1e-4
    assert torch.equal(out("int8", True), y_int8)
    monkeypatch.setattr(quant, "MIN_SPATIAL_ELEMS", 33 ** 3)
    assert torch.equal(out("int8", True), y_float)
    assert torch.equal(out("int8", False), y_int8)
    monkeypatch.setattr(quant, "MIN_SPATIAL_ELEMS", 4 ** 3)
    assert torch.equal(out("int8", True), y_int8)


def test_trainer_rejects_quantized_config(tmp_path):
    cfg = Config(model=tiny_model_config(img_dim=16, top_num=2,
                                         fused_norms=False,
                                         use_pallas_attention=False,
                                         quantize="int8"),
                 data=DataConfig(synthetic_num_samples=2,
                                 input_shape=(16, 16, 16), pad_depth=16,
                                 crop_size=(16, 16, 16)),
                 train=TrainConfig(end_epoch=1,
                                   checkpoint_dir=str(tmp_path / "ckpt")))
    with pytest.raises(ValueError, match="inference-only"):
        Trainer(cfg, device="cpu")


def test_int8_operators_have_no_gradient():
    x = _t(_normal(1, 3, 3, 3, 64)).requires_grad_()
    w = _t(_normal(8, 64, 3, 3, 3, scale=0.1))
    with pytest.raises(RuntimeError, match="inference only"):
        quant.conv3d_int8(x, w).sum().backward()


# ---- the model at full width (the tiny model: test_torch_quant_model.py)

PATHS = {"direct": dict(s2d_fullres=False, s2d_halfres=False),
         "s2d": dict(s2d_fullres=True, s2d_halfres=True)}


def _count_calls(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def counting(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)
    monkeypatch.setattr(module, name, counting)
    return calls


@pytest.mark.parametrize("path,spec", sorted(chip_smoke.INT8_CONVS))
def test_full_width_int8_convs_match_jax(monkeypatch, path, spec):
    """The int8 convs of one full-width B=8 forward, as chip_smoke.py pins
    them for the card: the port's forward, traced on fake tensors, and the
    JAX model's, traced abstractly (jax.eval_shape), take that many."""
    flags = PATHS[path]
    port_calls = _count_calls(monkeypatch, quant, "int8_conv3d")
    model = cwf.ClsWiseFormer(ModelConfig(**flags, quantize=spec))
    with FakeTensorMode(allow_non_fake_inputs=True), torch.inference_mode():
        out = model(torch.empty(8, 128, 128, 128, 4))[0]
    assert out.shape == (8, 128, 128, 128, 4)
    jax_calls = _count_calls(monkeypatch, jax_quant, "conv3d_int8")
    jmodel = jax_cwf.build_model(JaxModelConfig(
        **flags, quantize=spec, conv3_strategy="dense", fused_norms=False,
        use_pallas_attention=False))
    x = jax.ShapeDtypeStruct((8, 128, 128, 128, 4), jnp.float32)
    params = jax.eval_shape(
        lambda v: jmodel.init(jax.random.PRNGKey(0), v, train=False), x)
    jax_calls.clear()
    jax.eval_shape(lambda p, v: jmodel.apply(p, v, train=False)[0], params,
                   x)
    assert len(port_calls) == len(jax_calls) == \
        chip_smoke.INT8_CONVS[path, spec]
