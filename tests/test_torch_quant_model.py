"""The tiny ClsWiseFormer under the port's int8 post-training
quantization against the JAX package's, on the CPU (the ops and layers:
``test_torch_quant.py``).

Every int8 conv of the tiny model's forward, on the input the forward gave
it, equals JAX's module bit for bit; its ``seg_probs`` under ``int8`` and
``int8_all``, direct and s2d, against JAX's with its Pallas kernels in
interpret mode, and against the port's float forward within JAX's own
drift bounds; the same seed gives the same state_dict with and without
quantize.  ``Predictor(fold_params=True)`` equals the unfolded engine bit
for bit and follows ``update_params``.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dctseg.models.clswiseformer as jax_cwf
from dctseg.models import layers as jax_layers
from dctseg.models import unet as jax_unet
from dctseg.ops import quant as jax_quant
from dctseg.ops.pallas import attention as jax_attention
from dctseg.ops.pallas import fusednorm as jax_fusednorm
from dctseg.config import tiny_model_config as jax_tiny_config
from dctseg.utils.torch_convert import _conv, _deconv, convert_state_dict

import dctseg_torch.models.clswiseformer as cwf
from dctseg_torch.config import tiny_model_config
from dctseg_torch.infer.engine import Predictor
from dctseg_torch.models.unet import S2DConv3d, S2DDeconv
from dctseg_torch.ops import quant

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_quant import (JNP, PATHS, _count_calls,  # noqa: E402
                              _normal, _np)

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

KERNELS = dict(fused_norms=True, use_pallas_attention=True)
# quantized convs per tiny forward (base 4): direct, only conv_semantic_*
# reaches 64 input channels; s2d, every dense s2d conv (and, under
# int8_all, the s2d down, deconv and pointwise convs) besides
INT8_CONVS = {("direct", "int8"): 3, ("direct", "int8_all"): 3,
              ("s2d", "int8"): 20, ("s2d", "int8_all"): 27}
# Port against JAX, same weights and input.  Direct: only the last convs
# are int8, and the two agree to float32 noise (6.6e-8 mean |dp|, every
# argmax equal), far below int8's own drift from float (1.2e-5).  s2d: 20
# int8 convs in a row make the tiny random network chaotic: an ulp anywhere
# upstream (the order of a float32 sum) moves some x / sx across a .5
# rounding boundary, and each flipped int8 value flips more downstream.
# JAX against itself shows it: its jit (which rewrites the divisions by
# 127: test_torch_quant.py) against its eager op order drifts 0.0027 / 97.9 % (int8) and
# 0.0035 / 97.3 % (int8_all), nearly int8's own drift from float (0.0033 /
# 97.2 % and 0.0040 / 96.9 %).  So end to end the port is held to JAX's
# eager forward within 1.1x that JAX-against-JAX drift, measured here, and
# below JAX's int8-against-float drift; what holds it tightly is
# test_every_int8_conv_of_the_forward_equals_jax: each int8 conv of the
# forward, on the input the forward gave it, equals JAX's module bit for
# bit.
PORT_VS_JAX_DIRECT = dict(mean=1e-6, agree=0.999)
S2D_CHAOS_FACTOR = 1.1
# int8 against float: the mean drift within JAX's own bounds
# (tests/test_quant.py:92-94, :141-143); the argmax agreement within 0.01
# of what JAX's int8 model keeps of JAX's float model on the same weights
# and input.  JAX's fixed 0.98 / 0.97 hold for its own test's flax init but
# not for every seed: at this fixture's weights JAX itself keeps 97.2 %
# (int8) and 96.7 % (int8_all) on the s2d path, near-tied classes of a
# random network flipping; the port keeps 97.1 % and 96.7 %, and the 0.01
# covers the drift between two exact int8 executions (above)
DRIFT_MEAN = {"int8": 0.01, "int8_all": 0.015}
AGREE_MARGIN = 0.01


@pytest.fixture(scope="module")
def tiny():
    """A seeded port state_dict (one for every path), its JAX params by the
    JAX package's converter, and one input."""
    model = cwf.ClsWiseFormer(tiny_model_config(**KERNELS),
                              torch.Generator().manual_seed(4))
    sd = model.state_dict()
    params = {"params": convert_state_dict(
        {k: v.numpy() for k, v in sd.items()})}
    return sd, params, _normal(1, 32, 32, 32, 4, seed=12)


def _port_probs(sd, x, **cfg_kw):
    model = cwf.build_model(tiny_model_config(**KERNELS, **cfg_kw),
                            device="cpu")
    model.load_state_dict(sd, strict=True)
    return Predictor(model, device="cpu").seg_probs(x).numpy()


def _interpret_kernels(monkeypatch):
    orig_attn = jax_attention.fused_attention
    monkeypatch.setattr(
        jax_attention, "fused_attention",
        lambda q, k, v, scale: orig_attn(q, k, v, scale, interpret=True))
    orig_norm = jax_fusednorm.fused_instance_norm_act
    monkeypatch.setattr(
        jax_fusednorm, "fused_instance_norm_act",
        lambda *a, **kw: orig_norm(*a, **{**kw, "impl": "interpret"}))


def _agreement(a, b):
    return float((a.argmax(-1) == b.argmax(-1)).mean())


# each path's float seg_probs, JAX's and the port's: the int8 and int8_all
# cases compare against the same ones
_JAX_FLOAT, _PORT_FLOAT = {}, {}


def _jax_probs(params, x, jit=True, **cfg_kw):
    """JAX's seg_probs, under jax.jit or eagerly (op by op, in the order
    the port follows)."""
    jmodel = jax_cwf.build_model(jax_tiny_config(**KERNELS, **cfg_kw))
    fwd = lambda p, v: jmodel.apply(p, v, train=False)[0]   # noqa: E731
    return np.asarray((jax.jit(fwd) if jit else fwd)(params, x))


@pytest.mark.parametrize("spec", ["int8", "int8_all"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_seg_probs_int8_matches_jax_and_float(tiny, monkeypatch, path, spec):
    sd, params, x = tiny
    flags = PATHS[path]
    _interpret_kernels(monkeypatch)
    if path not in _JAX_FLOAT:
        _JAX_FLOAT[path] = _jax_probs(params, x, **flags)
        _PORT_FLOAT[path] = _port_probs(sd, x, **flags)
    jax_calls = _count_calls(monkeypatch, jax_quant, "conv3d_int8")
    want = _jax_probs(params, x, **flags, quantize=spec)
    n_jax = len(jax_calls)
    port_calls = _count_calls(monkeypatch, quant, "int8_conv3d")
    got = _port_probs(sd, x, **flags, quantize=spec)
    assert len(port_calls) == n_jax == INT8_CONVS[path, spec] > 0
    ref = _PORT_FLOAT[path]
    values = dict(
        port_vs_jax=float(np.abs(got - want).mean()),
        port_vs_jax_agree=_agreement(got, want),
        port_drift=float(np.abs(got - ref).mean()),
        port_agree=_agreement(got, ref),
        jax_drift=float(np.abs(want - _JAX_FLOAT[path]).mean()),
        jax_agree=_agreement(want, _JAX_FLOAT[path]))
    if path == "direct":
        assert values["port_vs_jax"] <= PORT_VS_JAX_DIRECT["mean"], values
        assert values["port_vs_jax_agree"] >= PORT_VS_JAX_DIRECT["agree"], \
            values
    else:
        eager = _jax_probs(params, x, jit=False, **flags, quantize=spec)
        values.update(
            port_vs_eager=float(np.abs(got - eager).mean()),
            port_vs_eager_agree=_agreement(got, eager),
            jit_vs_eager=float(np.abs(want - eager).mean()),
            jit_vs_eager_agree=_agreement(want, eager))
        assert values["port_vs_eager"] <= min(
            S2D_CHAOS_FACTOR * values["jit_vs_eager"],
            values["jax_drift"]), values
        assert values["port_vs_eager_agree"] >= max(
            values["jit_vs_eager_agree"] - 0.005, values["jax_agree"]), \
            values
    assert values["port_drift"] < DRIFT_MEAN[spec], values
    assert values["port_agree"] >= values["jax_agree"] - AGREE_MARGIN, values


def _jax_module(port, spec):
    """The JAX package's module for an int8 port conv, and its params."""
    w, b = port.weight.detach().numpy(), port.bias.detach().numpy()
    dt = JNP[port.dtype]
    if isinstance(port, S2DDeconv):
        return (jax_unet.S2DDeconv(w.shape[1], dtype=dt, quantize=spec),
                {"ConvTranspose_0": {"kernel": _deconv(w), "bias": b}})
    k = w.shape[2]
    if isinstance(port, S2DConv3d):
        mod = jax_unet.S2DConv3d(w.shape[0], k, port.stride, port.groups,
                                 dtype=dt, conv3=port.route, quantize=spec)
    else:
        mod = jax_layers.Conv3d(w.shape[0], k, port.stride, port.padding,
                                dtype=dt, quantize=spec,
                                spatial_gate=port.spatial_gate)
    return mod, {"Conv_0": {"kernel": _conv(w), "bias": b}}


@pytest.mark.parametrize("spec", ["int8", "int8_all"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_every_int8_conv_of_the_forward_equals_jax(tiny, monkeypatch, path,
                                                   spec):
    """Each int8 conv of the tiny model's forward (Conv3d, S2DConv3d,
    S2DDeconv), on the input the forward gave it, equals the JAX package's
    module with the same parameters, run eagerly, bit for bit: the route,
    padding, bias and scales the model takes, at the model's shapes."""
    sd, _, x = tiny
    model = cwf.build_model(tiny_model_config(**KERNELS, **PATHS[path],
                                              quantize=spec), device="cpu")
    model.load_state_dict(sd, strict=True)
    seen = []

    def record(mod, args, out):
        seen.append((mod, args[0].clone(), out.clone()))
    for m in model.modules():
        if getattr(m, "int8", False):
            m.register_forward_hook(record)
    Predictor(model, device="cpu").seg_probs(x)
    assert len(seen) == INT8_CONVS[path, spec]
    jax_calls = _count_calls(monkeypatch, jax_quant, "conv3d_int8")
    for mod, xin, out in seen:
        jmod, p = _jax_module(mod, spec)
        want = jmod.apply({"params": p},
                          jnp.asarray(_np(xin)).astype(JNP[mod.dtype]))
        np.testing.assert_array_equal(_np(out), np.asarray(want, np.float32),
                                      err_msg=type(mod).__name__)
    assert len(jax_calls) == len(seen)


def test_quantize_is_pure_execution_strategy(tiny):
    """JAX's test of the same name: the same seed gives the same
    state_dict with and without quantize, and converted JAX params load
    strictly into both."""
    _, params, _ = tiny
    from dctseg_torch.convert import state_dict_from_jax
    sds = {}
    for spec in ("none", "int8", "int8_all"):
        cfg = tiny_model_config(**PATHS["s2d"], quantize=spec)
        model = cwf.ClsWiseFormer(cfg, torch.Generator().manual_seed(9))
        sds[spec] = model.state_dict()
        model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    for spec in ("int8", "int8_all"):
        assert list(sds[spec]) == list(sds["none"])
        assert all(torch.equal(sds[spec][k], v)
                   for k, v in sds["none"].items())


@pytest.mark.parametrize("spec", ["none", "int8_all"])
def test_fold_params_bit_exact_and_swappable(tiny, spec):
    """Folded and unfolded engines run the same ops on the same tensors:
    equal bit for bit, float and int8, before and after a checkpoint swap
    (the weights x 1.5, which must equal a fresh predictor's)."""
    sd, _, x = tiny
    cfg = tiny_model_config(**KERNELS, **PATHS["s2d"], quantize=spec)

    def predictor(weights, fold):
        model = cwf.build_model(cfg, device="cpu")
        model.load_state_dict(weights, strict=True)
        return Predictor(model, device="cpu", fold_params=fold)

    base, fold = predictor(sd, False), predictor(sd, True)
    y = fold.seg_probs(x)
    assert torch.equal(y, base.seg_probs(x))
    sd2 = {k: v * 1.5 if v.is_floating_point() else v for k, v in sd.items()}
    fold.update_params(sd2)
    y2 = fold.seg_probs(x)
    assert not torch.equal(y2, y)
    assert torch.equal(y2, predictor(sd2, False).seg_probs(x))
    assert torch.equal(y2, predictor(sd2, True).seg_probs(x))
