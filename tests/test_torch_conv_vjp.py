"""The explicit VJP of the 3^3 stride-1 SAME conv on the s2d view (the JAX
package's ``dctseg/ops/s2d.py`` ``CONV3_BWD = "explicit"``, ``_conv3_cv_bwd``
:270) against the JAX function and against autograd, on the CPU in fp32.

Tolerances: dx and dW against JAX's ``_conv3_cv_bwd`` at rtol 1e-5 (atol
1e-6 of the largest entry, for sums that cancel to near zero); a tiny s2d
train step's loss at 1e-6 and its gradients at rtol 1e-5 (atol 1e-5 of
the largest gradient) against the same step with autograd's backward.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dctseg.ops import s2d as jax_s2d

from dctseg_torch.config import TrainConfig, tiny_model_config
from dctseg_torch.models import clswiseformer as cwf
from dctseg_torch.ops import s2d
from dctseg_torch.train import optim
from dctseg_torch.train.trainer import train_step

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

SHAPES = [((2, 4, 5, 6, 8), 6), ((1, 4, 4, 4, 32), 32), ((1, 3, 2, 5, 16),
                                                          8)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_default_is_autograd():
    assert s2d.CONV3_BWD == "xla"


@pytest.mark.parametrize("xshape,co", SHAPES)
def test_explicit_vjp_matches_jax(monkeypatch, xshape, co):
    """dx and dW of conv3d_s2d's explicit route equal JAX's
    ``_conv3_cv_bwd`` on the same x, kernel and cotangent; the forward
    equals JAX's conv."""
    rng = np.random.default_rng(sum(xshape) + co)
    x = rng.normal(size=xshape).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, xshape[-1], co)) * 0.2).astype(np.float32)
    g = rng.normal(size=xshape[:-1] + (co,)).astype(np.float32)
    dx, dw = jax_s2d._conv3_cv_bwd((jnp.asarray(x), jnp.asarray(w)),
                                   jnp.asarray(g))
    monkeypatch.setattr(s2d, "CONV3_BWD", "explicit")
    xt = _t(x).requires_grad_()
    wt = _t(w.transpose(4, 3, 0, 1, 2)).requires_grad_()   # (O, I, 3, 3, 3)
    y = s2d.conv3d_s2d(xt, wt)
    y.backward(_t(g))
    np.testing.assert_allclose(
        y.detach().numpy(),
        np.asarray(jax_s2d._conv3_raw(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)
    for got, want in ((xt.grad.numpy(), np.asarray(dx)),
                      (wt.grad.numpy(),
                       np.asarray(dw).transpose(4, 3, 0, 1, 2))):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("xshape,co", SHAPES[:2])
def test_explicit_vjp_matches_autograd(monkeypatch, xshape, co):
    """With a bias, the explicit route's output and gradients equal
    autograd's through the plain conv."""
    rng = np.random.default_rng(co)
    x = _t(rng.normal(size=xshape).astype(np.float32))
    w = _t((rng.normal(size=(co, xshape[-1], 3, 3, 3)) * 0.2).astype(
        np.float32))
    b = _t(rng.normal(size=co).astype(np.float32))
    g = _t(rng.normal(size=xshape[:-1] + (co,)).astype(np.float32))
    out = {}
    for route in ("xla", "explicit"):
        monkeypatch.setattr(s2d, "CONV3_BWD", route)
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        y = s2d.conv3d_s2d(xs, ws, bs)
        y.backward(g)
        out[route] = (y.detach(), xs.grad, ws.grad, bs.grad)
    for got, want in zip(out["explicit"], out["xla"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))


def test_unknown_route_raises(monkeypatch):
    monkeypatch.setattr(s2d, "CONV3_BWD", "fast")
    with pytest.raises(ValueError, match="CONV3_BWD"):
        s2d.conv3d_s2d(torch.zeros(1, 2, 2, 2, 8), torch.zeros(8, 8, 3, 3, 3))


def test_train_step_with_the_explicit_vjp(monkeypatch):
    """One train step of the tiny s2d model (dense conv3) with the
    explicit VJP gives autograd's loss and gradients."""
    cfg = tiny_model_config(img_dim=16, top_num=2, s2d_fullres=True,
                            s2d_halfres=True, fused_norms=False,
                            use_pallas_attention=False)
    rng = np.random.default_rng(2)
    x = _t(rng.normal(size=(1, 16, 16, 16, 4)).astype(np.float32))
    tgt = _t(rng.integers(0, 4, size=(1, 16, 16, 16)).astype(np.uint8))
    edge = _t(rng.choice([0, 1, 2, 4, 5], size=(1, 16, 16, 16)).astype(
        np.uint8))
    out = {}
    for route in ("xla", "explicit"):
        monkeypatch.setattr(s2d, "CONV3_BWD", route)
        model = cwf.build_model(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(1))
        opt = optim.make_optimizer(model.parameters(),
                                   TrainConfig(lr=1e-3, end_epoch=10))
        m = train_step(model, opt, 1e-3, x, tgt, edge)
        out[route] = (m["loss"].item(),
                      {n: p.grad for n, p in model.named_parameters()})
    np.testing.assert_allclose(out["explicit"][0], out["xla"][0], rtol=1e-6)
    top = max(float(g.abs().max()) for g in out["xla"][1].values())
    for name, want in out["xla"][1].items():
        np.testing.assert_allclose(out["explicit"][1][name].numpy(),
                                   want.numpy(), rtol=1e-5, atol=1e-5 * top,
                                   err_msg=name)
