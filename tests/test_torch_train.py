"""The port's training math against the JAX package's, on the CPU: losses,
optimizer and schedule, one train step of the tiny s2d model, gradient
accumulation, dropout, the attention kernel's backward and the save
predicate.

Inputs are made from a seed with numpy; the JAX side runs under
``jax.jit``.  JAX params come from a seeded port model's state_dict through
the JAX package's converter, so no flax init runs.  Tolerances (fp32): the
losses and the optimizer at 1e-6; the train step's loss at 1e-5 relative,
each gradient at 1e-4 of its largest magnitude, the parameters after two
optimizer steps at 1e-5.  Dropout masks cannot match JAX's, so the parity
runs at dropout 0 and dropout is tested on the port alone.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import dctseg.losses as jax_losses
from dctseg.config import TrainConfig as JaxTrainConfig
from dctseg.config import tiny_model_config as jax_tiny_config
from dctseg.models.clswiseformer import build_model as jax_build_model
from dctseg.ops.pallas.attention import _fused_attention_bwd
from dctseg.train.checkpoint import should_save as jax_should_save
from dctseg.train.optim import make_optimizer as jax_make_optimizer
from dctseg.train.trainer import _seed_schedule_count
from dctseg.utils.torch_convert import convert_state_dict

from dctseg_torch import losses
from dctseg_torch.config import TrainConfig, tiny_model_config
from dctseg_torch.convert import state_dict_from_jax
from dctseg_torch.models import clswiseformer as cwf
from dctseg_torch.models.layers import Dropout
from dctseg_torch.ops import attention
from dctseg_torch.train import optim
from dctseg_torch.train.checkpoint import should_save
from dctseg_torch.train.trainer import train_step

# The suite runs in several xdist workers on one machine: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

RNG = np.random.default_rng(5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _probs(*shape):
    z = RNG.normal(size=shape).astype(np.float32)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


# ---- losses ----

@pytest.fixture(scope="module")
def loss_inputs():
    sp = (2, 6, 6, 6)
    outs = (_probs(*sp, 4),) + tuple(
        {r: _probs(*sp, 2) for r in ("01", "02", "04")} for _ in range(4))
    target = RNG.integers(0, 4, size=sp).astype(np.int32)
    edge = RNG.choice([0, 1, 2, 4, 5, 6, 7, 8], size=sp).astype(np.int32)
    raw = RNG.choice([0, 1, 2, 4], size=sp).astype(np.int32)
    return outs, target, edge, raw


def _port_outs(outs):
    return (_t(outs[0]),) + tuple({r: _t(v) for r, v in d.items()}
                                  for d in outs[1:])


@pytest.mark.parametrize("name", sorted(losses.CRITERIA))
def test_criterion_matches_jax(loss_inputs, name):
    outs, target, _, raw = loss_inputs
    labels = target if name == "softmax_dice" else raw
    want = jax.jit(jax_losses.CRITERIA[name])(outs[0], labels)
    got = losses.CRITERIA[name](_t(outs[0]), _t(labels))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_total_loss_matches_jax(loss_inputs):
    outs, target, edge, _ = loss_inputs
    want = jax.jit(jax_losses.total_loss)(outs, target, edge)
    got = losses.total_loss(_port_outs(outs), _t(target), _t(edge))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_edge_decode_matches_jax():
    """The 8-code edge decode: each code's positives per region."""
    for key, codes in losses.EDGE_POSITIVE_CODES.items():
        assert tuple(codes) == tuple(jax_losses.EDGE_POSITIVE_CODES[key])


# ---- optimizer and schedule ----

@pytest.mark.parametrize("seeded_count", [0, 3])
def test_optimizer_and_schedule_match_jax(seeded_count):
    """Five steps of the same gradients on a small tree: L2 weight decay,
    amsgrad, the poly schedule restarting past epoch 1, and a schedule
    count seeded as a params-only resume seeds it."""
    cfg = dict(lr=1e-2, weight_decay=1e-2, amsgrad=True, end_epoch=10,
               amp_lr_restart_epoch=1)
    shapes = {"a": (3, 4), "b": (5,)}
    p0 = {k: RNG.normal(size=s).astype(np.float32) for k, s in
          shapes.items()}
    grads = [{k: RNG.normal(size=s).astype(np.float32) for k, s in
              shapes.items()} for _ in range(5)]

    tx = jax_make_optimizer(JaxTrainConfig(**cfg), steps_per_epoch=1)
    state = _seed_schedule_count(tx.init(p0), seeded_count)
    update = jax.jit(tx.update)
    pj = p0
    for g in grads:
        upd, state = update(g, state, pj)
        pj = optax.apply_updates(pj, upd)

    params = {k: torch.nn.Parameter(_t(v.copy())) for k, v in p0.items()}
    opt = optim.make_optimizer(params.values(), TrainConfig(**cfg))
    sched = optim.make_schedule(TrainConfig(**cfg), steps_per_epoch=1)
    for step, g in enumerate(grads, start=seeded_count):
        for k, p in params.items():
            p.grad = _t(g[k])
        optim.set_lr(opt, sched(step))
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(pj[k]), rtol=1e-6, atol=1e-6)


def test_poly_schedule_values():
    sched = optim.poly_schedule(2e-4, 1000, steps_per_epoch=10, power=0.9,
                                restart_epoch=249)
    for epoch in (0, 1, 137, 249, 250, 999):
        e = epoch - 249 if epoch > 249 else epoch
        assert sched(epoch * 10 + 3) == pytest.approx(
            round(2e-4 * (1 - e / 1000) ** 0.9, 8), rel=1e-6)


def test_should_save_matches_jax():
    for save_freq, end in ((50, 1000), (1, 3), (5, 7), (2, 2), (3, 1)):
        for epoch in range(end + 3):
            assert should_save(epoch, save_freq, end) == jax_should_save(
                epoch, save_freq, end), (epoch, save_freq, end)


# ---- one train step of the tiny s2d model ----

S2D_TRAIN = dict(s2d_fullres=True, s2d_halfres=True, fused_norms=False,
                 use_pallas_attention=False)


def _batch(b, d=16, rng=RNG):
    x = rng.normal(size=(b, d, d, d, 4)).astype(np.float32)
    tgt = rng.integers(0, 4, size=(b, d, d, d)).astype(np.uint8)
    edge = rng.choice([0, 1, 2, 4, 5, 6, 7, 8], size=(b, d, d, d)).astype(
        np.uint8)
    return x, tgt, edge


def test_train_step_matches_jax():
    """One train step of the tiny s2d model (img_dim 16, fp32, dropout 0)
    against jax.value_and_grad of the JAX loss, then the parameters after
    two optimizer steps; one jitted JAX step function serves both.

    The seed puts the step away from the loss's kinks (every relu input at
    least 6.8e-6 from zero, every probability above the CE clamp at 0.005):
    at a kink the two frameworks' last-bit differences pick different
    one-sided gradients, which a central difference shows as their mean.
    A conv bias ahead of an InstanceNorm has a gradient of exactly zero;
    both sides compute rounding noise there (below 1e-6 of the largest
    gradient), which is checked as such.  Adam's first steps move an entry
    by about lr * sign(gradient), so the parameters after each step are
    held at 1e-5 where the gradients are resolved (above 1e-3 of their
    tensor's largest magnitude) and within 2 lr where the sign is rounding
    noise; the second step starts from JAX's parameters, with the port's
    optimizer state."""
    cfg = tiny_model_config(img_dim=16, top_num=2, **S2D_TRAIN)
    tcfg = TrainConfig(lr=1e-3, end_epoch=10)
    model = cwf.build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    params = {"params": convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})}
    x, tgt, edge = _batch(1, rng=np.random.default_rng(1))

    jmodel = jax_build_model(jax_tiny_config(img_dim=16, top_num=2,
                                             **S2D_TRAIN))
    tx = jax_make_optimizer(JaxTrainConfig(lr=1e-3, end_epoch=10),
                            steps_per_epoch=1)

    @jax.jit
    def jax_step(p, opt_state):
        def loss_fn(q):
            outs = jmodel.apply(q, x, train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)})
            return jax_losses.total_loss(outs, tgt.astype(jnp.int32),
                                         edge.astype(jnp.int32))["loss"]
        loss, grads = jax.value_and_grad(loss_fn)(p)
        upd, opt_state = tx.update(grads, opt_state, p)
        return loss, grads, optax.apply_updates(p, upd), opt_state

    loss0, grads0, p1, s1 = jax_step(params, tx.init(params))
    _, grads1, p2, _ = jax_step(p1, s1)

    def port(tree):
        return state_dict_from_jax(jax.tree.map(np.asarray, tree), cfg)
    want_g, want_g1, want_p1, want_p2 = (port(t) for t in
                                         (grads0, grads1, p1, p2))

    opt = optim.make_optimizer(model.parameters(), tcfg)
    sched = optim.make_schedule(tcfg, steps_per_epoch=1)
    m = train_step(model, opt, sched(0), _t(x), _t(tgt), _t(edge))
    np.testing.assert_allclose(m["loss"].item(), float(loss0), rtol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) <= set(want_g)
    top = max(float(np.abs(want_g[n].numpy()).max()) for n in named)
    zero = {n for n in named if np.abs(want_g[n].numpy()).max() < 1e-6 * top}
    assert zero and all(n.endswith("bias") for n in zero)
    for name, p in named.items():
        w = want_g[name].numpy()
        if name in zero:
            assert np.abs(p.grad.numpy()).max() < 1e-6 * top, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)

    def check_params(want, grads):
        for name, p in named.items():
            g = np.min([np.abs(t[name].numpy()) for t in grads], axis=0)
            # an entry whose gradient is within rounding noise of 0 moves
            # by about lr * (a noisy sign) per Adam step
            noise = (g < 1e-3 * g.max() if name not in zero
                     else np.ones(g.shape, bool))
            d = np.abs(p.detach().numpy() - want[name].numpy())
            assert d[noise].max(initial=0) <= 2 * tcfg.lr, name
            np.testing.assert_allclose(d[~noise], 0, atol=1e-5,
                                       err_msg=name)
    check_params(want_p1, [want_g])
    # the second step starts from JAX's parameters (keeping the port's
    # optimizer state): the noisy entries of the first step would otherwise
    # move the two runs to points a kink apart
    model.load_state_dict({**model.state_dict(), **want_p1}, strict=True)
    train_step(model, opt, sched(1), _t(x), _t(tgt), _t(edge))
    check_params(want_p2, [want_g, want_g1])


def test_grad_accum_is_the_mean_of_interleaved_micro_batches():
    cfg = tiny_model_config(img_dim=16, top_num=2, **S2D_TRAIN)
    x, tgt, edge = (_t(a) for a in _batch(4, 16))

    def fresh():
        return cwf.build_model(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(2))
    ref = fresh()
    grads = []
    for j in range(2):
        ref.zero_grad()
        outs = ref(x[j::2], train=True)
        losses.total_loss(outs, tgt[j::2].long(), edge[j::2].long()
                          )["loss"].backward()
        grads.append({n: p.grad.clone() for n, p in ref.named_parameters()})
    model = fresh()
    m = train_step(model, torch.optim.SGD(model.parameters(), lr=0.0), 0.0,
                   x, tgt, edge, grad_accum=2)
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.grad, (grads[0][n] + grads[1][n]) / 2,
                                   rtol=1e-5, atol=1e-7)
    # the metrics cover every row, in the batch's order
    with torch.no_grad():
        pred = torch.cat([ref(x[j::2])[0].argmax(-1) for j in range(2)])
    pred = pred[[0, 2, 1, 3]]
    assert m["pred_counts"].tolist() == [int((pred == c).sum())
                                         for c in range(4)]
    with pytest.raises(ValueError, match="grad_accum"):
        train_step(model, torch.optim.SGD(model.parameters(), lr=0.0), 0.0,
                   x[:3], tgt[:3], edge[:3], grad_accum=2)


# ---- dropout ----

def test_dropout_is_deterministic_per_generator_seed():
    cfg = tiny_model_config(img_dim=16, top_num=2, dropout_rate=0.3,
                            attn_dropout_rate=0.3, init_conv_dropout=0.3,
                            s2d_fullres=True, s2d_halfres=True)
    model = cwf.build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    x = _t(_batch(1, 16)[0])

    def run(seed):
        with torch.no_grad():
            return model(x, train=True,
                         generator=torch.Generator().manual_seed(seed))[0]
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        assert torch.equal(model(x)[0], model(x)[0])   # eval: no dropout


@pytest.mark.parametrize("s2d_view", [True, False])
def test_init_conv_dropout_zeroes_whole_fine_channels(s2d_view):
    """InitConv's spatial dropout keeps or zeroes each (sample, fine
    channel) as a whole -- on the s2d view, over every coarse position and
    every block offset -- and scales what it keeps by 1 / (1 - rate)."""
    rate = 0.5
    cfg = tiny_model_config(img_dim=16, top_num=2, init_conv_dropout=rate,
                            s2d_fullres=s2d_view, s2d_halfres=s2d_view)
    model = cwf.build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    seen = []
    model.Unet_list.EnBlock1.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach().clone()))
    x = _t(_batch(2, 16)[0])
    with torch.no_grad():
        model(x)
        model(x, train=True, generator=torch.Generator().manual_seed(3))
    clean, dropped = seen
    if s2d_view:
        n, d, h, w, cb = clean.shape
        clean = clean.reshape(n, d * h * w * 8, cb // 8)
        dropped = dropped.reshape(n, d * h * w * 8, cb // 8)
    else:
        clean = clean.reshape(clean.shape[0], -1, clean.shape[-1])
        dropped = dropped.reshape(dropped.shape[0], -1, dropped.shape[-1])
    kept = (dropped != 0).any(dim=1)                    # (n, fine channel)
    assert 0 < int(kept.sum()) < kept.numel()
    for i in range(kept.shape[0]):
        for c in range(kept.shape[1]):
            if kept[i, c]:
                torch.testing.assert_close(dropped[i, :, c],
                                           clean[i, :, c] / (1 - rate))
            else:
                assert not dropped[i, :, c].any()


def test_dropout_mask_semantics():
    x = torch.ones(4000)
    y = Dropout(torch.Generator().manual_seed(0))(x, 0.25)
    assert set(y.unique().tolist()) <= {0.0, float(np.float32(1.0 / 0.75))}
    assert abs((y == 0).float().mean().item() - 0.25) < 0.03
    assert Dropout(active=False)(x, 0.25) is x


# ---- the attention kernel's backward ----

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_backward_matches_jax_vjp(dtype):
    """The port's backward (the einsum formulation's autograd gradient)
    against the JAX kernel's custom VJP, a plain function.  bf16: both
    round the same f32 products to bf16, so they agree to within one bf16
    rounding of the f32 result; f32: to 1e-6."""
    shape = (2, 8, 9, 16)
    q, k, v, g = (RNG.normal(size=shape).astype(np.float32)
                  for _ in range(4))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    scale = shape[-1] ** -0.5
    want = jax.jit(lambda *a: _fused_attention_bwd(scale, True, a[:3], a[3]))(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v, g)))
    qt, kt, vt, gt = (_t(a).to(dtype) for a in (q, k, v, g))
    got = attention.attention_vjp(qt, kt, vt, scale, gt)
    # and the CPU autograd path through fused_attention takes that backward
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    attention.fused_attention(*leaves, scale).backward(gt)
    for name, a, b, leaf in zip("qkv", got, want, leaves):
        b = np.asarray(b.astype(jnp.float32))
        assert a.dtype == dtype
        torch.testing.assert_close(leaf.grad, a, rtol=0, atol=0)
        if dtype == torch.float32:
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6,
                                       err_msg=name)
        else:
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b),
                                                      2.0 ** -126))) - 7)
            np.testing.assert_array_less(np.abs(a.float().numpy() - b),
                                         ulp + 1e-6, err_msg=name)
