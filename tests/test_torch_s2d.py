"""The port's space-to-depth strategy against the JAX package's, on the CPU.

Relayouts and K3's plain version must be bit-exact with JAX (the Pallas
relayout runs in interpret mode).  Each weight transform, applied as a conv,
must equal the JAX transform applied as a conv (atol and rtol 1e-5, fp32,
as the JAX package's own s2d tests; weights in both layouts from the JAX
package's converter rules).  The tiny model's
eval forward on the s2d view must equal the JAX model's (atol 1e-4, equal
top-k indices) and the port's own direct path (atol 1e-4), for each
combination of the two s2d flags.  The JAX side runs under ``jax.jit``.
"""

import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

import dctseg.models.clswiseformer as jax_cwf
from dctseg.config import tiny_model_config as jax_tiny_config
from dctseg.ops import s2d as jax_s2d
from dctseg.ops.norms import instance_norm as jax_instance_norm
from dctseg.ops.pallas import relayout as jax_relayout
from dctseg.utils.torch_convert import (_conv, _deconv, convert_state_dict,
                                        reference_state_dict_names)

import dctseg_torch.models.clswiseformer as cwf
from dctseg_torch.config import tiny_model_config
from dctseg_torch.convert import state_dict_from_jax
from dctseg_torch.ops import relayout
from dctseg_torch.ops import s2d

# The suite runs in several xdist workers on one machine: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

RNG = np.random.default_rng(11)


def _normal(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", [(2, 8, 6, 4, 5), (1, 4, 4, 4, 32)])
def test_space_to_depth_bit_exact_with_jax(shape):
    x = _normal(*shape)
    y = s2d.space_to_depth(_t(x))
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jax.jit(jax_s2d.space_to_depth)(x)))
    np.testing.assert_array_equal(s2d.depth_to_space(y).numpy(), x)
    np.testing.assert_array_equal(
        s2d.depth_to_space(y).numpy(),
        np.asarray(jax.jit(jax_s2d.depth_to_space)(y.numpy())))


# the shapes of the JAX package's relayout test: the encoder's input site
# (C = 4) and its half-resolution site (C = 32)
RELAYOUT_CASES = [((2, 4, 32, 32, 4), torch.float32, torch.bfloat16),
                  ((2, 4, 32, 32, 4), torch.float32, torch.float32),
                  ((1, 4, 32, 4, 32), torch.float32, torch.bfloat16),
                  ((1, 4, 32, 4, 32), torch.bfloat16, torch.bfloat16)]
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("shape,in_dt,out_dt", RELAYOUT_CASES)
def test_relayout_plain_bit_exact_with_pallas_interpret(shape, in_dt, out_dt):
    x = _t(_normal(*shape)).to(in_dt)
    xj = jnp.asarray(x.float().numpy()).astype(JNP[in_dt])
    want = jax.jit(lambda a: jax_relayout.space_to_depth(
        a, JNP[out_dt], "interpret"))(xj)
    got = relayout.space_to_depth(x, out_dt)
    assert got.dtype == out_dt and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(
        got.float().numpy(), relayout.space_to_depth_plain(x, out_dt)
        .float().numpy())


def test_relayout_gradient_equals_jax_custom_vjp():
    """The CPU path's autograd gradient and the operator's backward
    (``relayout._backward``) both equal jax.grad through the Pallas
    kernel's custom VJP, exactly."""
    x = _normal(1, 4, 32, 32, 4)
    ct = _normal(1, 2, 16, 16, 32)

    def f(a):
        y = jax_relayout.space_to_depth(a, jnp.bfloat16, "interpret")
        return jnp.sum(y.astype(jnp.float32) * ct)
    want = np.asarray(jax.jit(jax.grad(f))(x))

    xt = _t(x).requires_grad_()
    (relayout.space_to_depth(xt, torch.bfloat16).float() * _t(ct)).sum(
        ).backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    g = _t(ct).to(torch.bfloat16)
    dx, none = relayout._backward(
        types.SimpleNamespace(in_dtype=torch.float32), g)
    assert none is None and dx.dtype == torch.float32
    np.testing.assert_array_equal(dx.numpy(), want)


def test_relayout_rejects_odd_extents():
    with pytest.raises(ValueError, match="even"):
        relayout.space_to_depth(torch.zeros(1, 4, 3, 4, 2))


# ---- weight transforms, applied as convs ----

def _jax_conv(x8, w8, padding, stride=1):
    return np.asarray(jax.jit(
        lambda a, w: jax_s2d.conv3d_s2d(a, w, stride, padding))(x8, w8))


@pytest.mark.parametrize("ci,co", [(3, 5), (16, 16)])
def test_conv_kernel_as_conv_equals_jax(ci, co):
    x8 = _normal(2, 4, 4, 4, 8 * ci)
    w = _normal(co, ci, 3, 3, 3, scale=0.2)
    got = s2d.conv3d_s2d(_t(x8), s2d.conv_kernel(_t(w)))
    want = _jax_conv(x8, jax_s2d.conv_kernel(_conv(w)), (1, 1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ci,co", [(3, 5), (16, 16)])
def test_fine_conv_kernel_as_conv_equals_jax(ci, co):
    x = _normal(2, 8, 8, 8, ci)
    w = _normal(co, ci, 3, 3, 3, scale=0.2)
    got = s2d.conv3d_fine_s2dout(_t(x), s2d.fine_conv_kernel(_t(w)))
    want = np.asarray(jax.jit(jax_s2d.conv3d_fine_s2dout)(
        x, jax_s2d.fine_conv_kernel(_conv(w))))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_down_kernel_as_conv_equals_jax():
    x8 = _normal(2, 4, 4, 4, 8 * 6)
    w = _normal(4, 6, 3, 3, 3, scale=0.2)
    got = s2d.conv3d_s2d(_t(x8), s2d.down_kernel(_t(w)), padding=(1, 0))
    want = _jax_conv(x8, jax_s2d.down_kernel(_conv(w)), (1, 0))
    assert got.shape == (2, 4, 4, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_pointwise_kernel_with_groups_as_conv_equals_jax():
    c1, c2, co = 3, 4, 6
    x8 = _normal(2, 4, 4, 4, 8 * (c1 + c2))
    w = _normal(co, c1 + c2, 1, 1, 1, scale=0.3)
    got = s2d.conv3d_s2d(_t(x8), s2d.pointwise_kernel(_t(w), (c1, c2)),
                         padding=(0, 0))
    want = _jax_conv(x8, jax_s2d.pointwise_kernel(_conv(w), (c1, c2)),
                     (0, 0))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_deconv_kernel_as_conv_equals_jax_and_transpose_conv():
    """No flip in the port's transform: the port keeps torch's transpose
    conv kernel; the JAX kernel is the converter's flipped one."""
    ci, co = 5, 3
    x = _normal(2, 4, 4, 4, ci)
    w = _normal(ci, co, 2, 2, 2, scale=0.3)
    got = s2d.conv3d_s2d(_t(x), s2d.deconv_kernel(_t(w)), padding=(0, 0))
    want = _jax_conv(x, jax_s2d.deconv_kernel(_deconv(w)), (0, 0))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    direct = F.conv_transpose3d(_t(x).permute(0, 4, 1, 2, 3), _t(w),
                                stride=2).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(s2d.depth_to_space(got).numpy(),
                               direct.numpy(), atol=1e-5, rtol=1e-5)


def test_tile_bias_layout():
    t = s2d.tile_bias(torch.tensor([1.0, 2.0, 3.0]))
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(jax_s2d.tile_bias(jnp.asarray([1.0, 2.0, 3.0]))))


@pytest.mark.parametrize("strategy,ci", [("dense", 4), ("fine", 4),
                                         ("auto", 4), ("auto", 32)])
def test_conv3x3_s2d_strategies_equal_direct_conv_and_jax(strategy, ci):
    co = 6
    x = _normal(1, 8, 8, 8, ci)
    w = _normal(co, ci, 3, 3, 3, scale=0.2)
    b = _normal(co)
    direct = F.conv3d(_t(x).permute(0, 4, 1, 2, 3), _t(w), _t(b),
                      padding=1).permute(0, 2, 3, 4, 1)
    x8 = s2d.space_to_depth(_t(x))
    got = s2d.conv3x3_s2d(x8, _t(w), _t(b), strategy)
    np.testing.assert_allclose(s2d.depth_to_space(got).numpy(),
                               direct.numpy(), atol=1e-5, rtol=1e-5)
    want = jax.jit(lambda a, k: jax_s2d.conv3x3_s2d(a, k, strategy))(
        x8.numpy(), _conv(w)) + np.tile(b, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_instance_norm_s2d_equals_jax_and_fine_norm():
    x = _normal(2, 4, 4, 4, 8 * 6) * 3 + 1
    got = s2d.instance_norm_s2d(_t(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax.jit(jax_s2d.instance_norm_s2d)(x)),
        atol=1e-5, rtol=1e-5)
    fine = np.asarray(jax.jit(jax_instance_norm)(
        np.asarray(jax_s2d.depth_to_space(x))))
    np.testing.assert_allclose(s2d.depth_to_space(got).numpy(), fine,
                               atol=1e-5, rtol=1e-5)


# ---- the tiny model on the s2d view ----

S2D_COMBOS = [(True, True), (True, False), (False, True)]
PLAIN = dict(fused_norms=False, use_pallas_attention=False)


@pytest.fixture(scope="module")
def tiny_weights():
    """One seeded port state_dict (the s2d parameter tree is the plain one,
    so it serves every flag combination), its JAX params through the JAX
    package's converter, one input, and the port's direct-path output."""
    cfg = tiny_model_config(**PLAIN)
    model = cwf.ClsWiseFormer(cfg, torch.Generator().manual_seed(4))
    sd = model.state_dict()
    params = {"params": convert_state_dict(
        {k: v.numpy() for k, v in sd.items()})}
    x = _normal(1, 32, 32, 32, 4)
    with torch.inference_mode():
        direct = model(_t(x))
    return sd, params, x, direct


def _jax_forward_with_routing(monkeypatch, cfg, params, x):
    """The JAX model's jitted eval forward, with every routing's top-k
    indices returned beside its outputs."""
    jmodel = jax_cwf.build_model(cfg)
    orig = jax_cwf.topk_select

    def run(p, v):
        store = []

        def recording(tokens, query, k):
            selected, idx = orig(tokens, query, k)
            store.append(idx)
            return selected, idx
        monkeypatch.setattr(jax_cwf, "topk_select", recording)
        out = jmodel.apply(p, v, train=False)
        monkeypatch.setattr(jax_cwf, "topk_select", orig)
        return out, store
    return jax.jit(run)(params, jnp.asarray(x))


def _assert_outputs_close(got, want, atol):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=atol)
    for j in range(1, 5):
        assert set(got[j]) == set(want[j]) == {"01", "02", "04"}
        for r in got[j]:
            np.testing.assert_allclose(got[j][r].numpy(),
                                       np.asarray(want[j][r]), atol=atol,
                                       err_msg=f"output {j} region {r}")


@pytest.mark.parametrize("full,half", S2D_COMBOS,
                         ids=["s2d_both", "s2d_full", "s2d_half"])
def test_s2d_forward_matches_jax_and_direct_path(tiny_weights, monkeypatch,
                                                 full, half):
    sd, params, x, direct = tiny_weights
    flags = dict(s2d_fullres=full, s2d_halfres=half)
    (want, jax_idx) = _jax_forward_with_routing(
        monkeypatch, jax_tiny_config(**PLAIN, **flags), params, x)

    port_idx = []
    orig = cwf.topk_select

    def recording(tokens, query, k):
        selected, idx = orig(tokens, query, k)
        port_idx.append(idx.numpy())
        return selected, idx
    monkeypatch.setattr(cwf, "topk_select", recording)
    outs = {}
    for fused in (False, True):
        cfg = tiny_model_config(**flags, fused_norms=fused,
                                use_pallas_attention=fused)
        model = cwf.build_model(cfg, device="cpu")
        model.load_state_dict(sd, strict=True)
        assert sorted(model.state_dict()) == sorted(
            reference_state_dict_names())
        port_idx.clear()
        with torch.inference_mode():
            outs[fused] = model(_t(x))
        assert len(port_idx) == len(jax_idx) == 13
        for i, (a, b) in enumerate(zip(port_idx, jax_idx)):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"routing {i}")
        # the plain norms and K1's plain version in fine-channel mode, both
        # against JAX's XLA norms
        _assert_outputs_close(outs[fused], want, 1e-4)
    _assert_outputs_close(outs[False], [direct[0]] + [
        {r: v.numpy() for r, v in d.items()} for d in direct[1:]], 1e-4)


def test_s2d_params_load_from_jax_converter(tiny_weights):
    """The same 222 keys load strictly into every flag combination, from the
    port's converter applied to the JAX params."""
    _, params, _, _ = tiny_weights
    for full, half in S2D_COMBOS:
        cfg = tiny_model_config(s2d_fullres=full, s2d_halfres=half)
        model = cwf.build_model(cfg, device="cpu")
        model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)


def test_index_tables_made_under_inference_mode_serve_training():
    """An s2d model that first runs under inference_mode (an eval at a
    checkpoint save) trains afterwards: the cached index tables are normal
    tensors."""
    s2d._DEVICE_TABLES.clear()
    cfg = tiny_model_config(img_dim=16, top_num=2, s2d_fullres=True,
                            s2d_halfres=True, **PLAIN)
    model = cwf.build_model(cfg, device="cpu")
    x = torch.zeros(1, 16, 16, 16, 4)
    with torch.inference_mode():
        model(x)
    model(x, train=True)[0].sum().backward()
    assert model.Unet_list.InitConv["conv"].weight.grad is not None
