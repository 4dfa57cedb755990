"""K7, the int8 activation quantizer, and the fused norm's absmax output
(``dctseg_torch/ops/quant.py``, ``dctseg_torch/ops/fusednorm.py``), on the
CPU, at the tiny config.

The absmax variant of the fused norm returns the plain norm's output bit
for bit and, per sample, the max of |out| (NaN and inf planted, all-zero
input, s2d fine channels).  K7's one-pass route (``quantize_from_amax``)
equals the two-pass quantizer bit for bit, exact half-way ties included;
the conv fed by the norm's absmax equals the JAX package's ``conv3d_int8``
on the same values bit for bit.  The tiny int8 forward, direct and s2d,
equals the same forward with every conv quantized by the two-pass plain
quantizer.  The launch plans, the argument arrays the wrappers hand the
kernels (through a stand-in library that records them), and the K7 calls
per route of one full-width forward, which ``chip_smoke.py`` pins for the
card, traced on fake tensors.
"""

import collections
import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dctseg.ops import quant as jax_quant
from dctseg.utils.torch_convert import _conv

import dctseg_torch.models.clswiseformer as cwf
from dctseg_torch.config import ModelConfig, tiny_model_config
from dctseg_torch.infer.engine import Predictor
from dctseg_torch.ops import _build, fusednorm, quant
from torch._subclasses.fake_tensor import FakeTensorMode

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.float16: torch.int16}


def _normal(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _same_bits(a, b):
    """Equal bit for bit (NaNs included)."""
    return a.dtype == b.dtype and torch.equal(a.view(_BITS[a.dtype]),
                                              b.view(_BITS[b.dtype]))


# ---- the fused norm's absmax variant ----

# (shape, fine channels): the plain layout and an s2d view (8 offsets per
# fine channel)
LAYOUTS = {"plain": ((2, 4, 5, 3, 16), 16), "s2d": ((2, 3, 2, 4, 64), 8)}
PLANTS = ("randn", "nan", "inf", "zeros")


@pytest.mark.parametrize("plant", PLANTS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("residual", [False, True], ids=["nores", "res"])
@pytest.mark.parametrize("act", ["relu", "lrelu"])
def test_amax_variant_equals_norm_and_its_absmax(act, residual, layout,
                                                 dtype, plant):
    """out equals the plain norm's bit for bit; amax[n] is the float32 max
    of |out[n]|; a NaN or inf planted in sample 0 reaches only its slot; an
    all-zero input gives zero outputs and a zero absmax."""
    shape, fine = LAYOUTS[layout]
    dt = DTYPES[dtype]
    x = _normal(*shape, seed=3, scale=2.0) + 0.5
    r = _normal(*shape, seed=4)
    if plant == "zeros":
        x[...], r[...] = 0.0, 0.0
    elif plant != "randn":
        x[0, 1, 1, 0, 3] = np.nan if plant == "nan" else np.inf
    xt, rt = _t(x, dt), (_t(r, dt) if residual else None)
    fusednorm.fused_instance_norm_act_amax.launches = 0
    out, amax = fusednorm.fused_instance_norm_act_amax(xt, fine, act=act,
                                                       residual=rt)
    want = fusednorm.fused_instance_norm_act_plain(xt, fine, act=act,
                                                   residual=rt)
    assert _same_bits(out, want)
    assert _same_bits(out, fusednorm.fused_instance_norm_act(
        xt, fine, act=act, residual=rt))
    assert amax.dtype == torch.float32 and amax.shape == (shape[0],)
    per = out.reshape(shape[0], -1).float().abs().amax(dim=1)
    torch.testing.assert_close(amax, per, rtol=0, atol=0, equal_nan=True)
    if plant in ("nan", "inf"):
        # the non-finite input spoils sample 0's statistics, not sample 1's
        assert torch.isnan(amax[0]) and torch.isfinite(amax[1])
    if plant == "zeros":
        assert not out.any() and not amax.any()
    assert fusednorm.fused_instance_norm_act_amax.launches == 0   # the CPU


def test_amax_variant_fake_and_no_gradient():
    """The operator's fake gives (out like x, float32 (N,)); it is
    inference only."""
    x = _t(_normal(3, 4, 4, 4, 8, seed=1), torch.bfloat16)
    with FakeTensorMode() as mode:
        out, amax = torch.ops.dctseg.fused_instance_norm_act_amax(
            mode.from_tensor(x), None, 8, 1e-5, "relu", 0.01)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert amax.shape == (3,) and amax.dtype == torch.float32
    torch.library.opcheck(torch.ops.dctseg.fused_instance_norm_act_amax
                          .default, (x, None, 8, 1e-5, "lrelu", 0.01))
    with pytest.raises(RuntimeError, match="inference only"):
        out, _ = fusednorm.fused_instance_norm_act_amax(
            x.float().requires_grad_(), 8, act="relu")
        out.sum().backward()


@pytest.mark.parametrize("grad_mode", [False, True], ids=["no_grad", "grad"])
def test_apply_amax_operator_called_directly(grad_mode):
    """The external-statistics apply with slots, a ``Tensor(a!)`` operator,
    called directly where no gradient is asked for (under no_grad, or in
    grad mode with no input asking for one) runs like every dctseg
    operator: the plain variant's output and slots.  An input that asks
    for a gradient raises."""
    x = _t(_normal(3, 4, 4, 4, 8, seed=2), torch.float32)
    want, want_amax = fusednorm.fused_instance_norm_act_amax_plain(
        x, 8, act="relu")
    count = fusednorm.norm_count(x, 8)
    sums, slots = torch.ops.dctseg.fused_norm_stats_amax(x, 8)
    with torch.set_grad_enabled(grad_mode):
        out = torch.ops.dctseg.fused_norm_apply_amax(
            x, None, sums, slots, count, 8, 1e-5, "relu", 0.01)
    assert torch.equal(out, want) and torch.equal(slots, want_amax)
    with pytest.raises(RuntimeError, match="inference only"):
        torch.ops.dctseg.fused_norm_apply_amax(
            x.clone().requires_grad_(), None, sums, slots, count, 8, 1e-5,
            "relu", 0.01)


# ---- K7's one-pass route ----

def _tie_input(shape, seed):
    """Exact half-way ties: amax 127 s and a third of the values (k + 0.5)
    s for s = 2^-3, so that sx = s and x / sx = k + 0.5 exactly."""
    rng = np.random.default_rng(seed)
    s = 2.0 ** -3
    x = np.clip(rng.normal(size=shape) * 3, -126 * s, 126 * s)
    k = rng.integers(-126, 126, size=shape)
    x = np.where(rng.random(shape) < 1 / 3, (k + 0.5) * s, x)
    x.reshape(-1)[0] = 127 * s
    return x.astype(np.float32)


@pytest.mark.parametrize("slots", ["per_sample", "one"])
@pytest.mark.parametrize("ties", [False, True], ids=["randn", "ties"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_from_amax_equals_two_pass(dtype, ties, slots):
    """xq and stats of the one-pass route (its plain version, through the
    operator) equal quantize_absmax_plain's bit for bit; ties round half to
    even with sx = 2^-3."""
    dt = DTYPES[dtype]
    shape = (3, 4, 5, 6, 16)
    x = _t(_tie_input(shape, 5) if ties else _normal(*shape, seed=6) * 3,
           dt)
    per = x.reshape(3, -1).float().abs().amax(dim=1)
    amax = per if slots == "per_sample" else per.max().reshape(1)
    quant.quantize_from_amax.launches = 0
    xq, stats = quant.quantize_from_amax(x, amax)
    pq, pstats = quant.quantize_absmax_plain(x)
    assert torch.equal(xq, pq) and torch.equal(stats, pstats)
    assert xq.dtype == torch.int8 and stats.dtype == torch.float32
    if ties:
        assert stats[1].item() == 2.0 ** -3
        xs = x.float() / stats[1]
        half = xs == xs.floor() + 0.5
        assert half.any()
        even = torch.where(xs.floor() % 2 == 0, xs.floor(), xs.floor() + 1)
        assert torch.equal(xq[half].float(), even[half].clamp(-127, 127))
    assert quant.quantize_from_amax.launches == 0   # the CPU


def test_quantize_from_amax_propagates_nan_and_zero():
    """A NaN slot makes amax and sx NaN, as the two-pass quantizer's NaN
    does; zero slots give sx = 1e-12 / 127 and zero xq."""
    x = _t(_normal(2, 3, 3, 3, 8, seed=7))
    x[1, 0, 0, 0, 0] = float("nan")
    amax = x.reshape(2, -1).abs().amax(dim=1)
    xq, stats = quant.quantize_from_amax(x, amax)
    pq, pstats = quant.quantize_absmax_plain(x)
    assert torch.equal(xq, pq) and torch.isnan(stats).all()
    torch.testing.assert_close(stats, pstats, rtol=0, atol=0, equal_nan=True)
    z = torch.zeros(2, 3, 3, 3, 8)
    zq, zstats = quant.quantize_from_amax(z, torch.zeros(2))
    assert not zq.any() and zstats.tolist() == quant.quantize_absmax_plain(
        z)[1].tolist()


def test_quantize_from_amax_operator_fake_and_no_gradient():
    x = _t(_normal(2, 3, 3, 3, 8, seed=8), torch.bfloat16)
    amax = x.reshape(2, -1).float().abs().amax(dim=1)
    with FakeTensorMode() as mode:
        xq, stats = torch.ops.dctseg.quantize_from_amax(
            mode.from_tensor(x), mode.from_tensor(amax))
    assert xq.shape == x.shape and xq.dtype == torch.int8
    assert stats.shape == (2,) and stats.dtype == torch.float32
    torch.library.opcheck(torch.ops.dctseg.quantize_from_amax.default,
                          (x, amax))
    with pytest.raises(RuntimeError, match="inference only"):
        quant.quantize_from_amax(x.float().requires_grad_(),
                                 amax)[1].sum().backward()


# ---- K7's amax route (the absmax alone, for a mesh's reduction) ----

@pytest.mark.parametrize("plant", PLANTS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_amax_is_the_two_pass_absmax(dtype, plant):
    """quantize_amax (its plain version, through the operator) gives the
    amax of quantize_absmax_plain's stats bit for bit as a float32 (1,)
    tensor, NaN, inf and zeros included; from_amax on it gives that
    quantizer's xq and stats."""
    x = _normal(3, 4, 5, 6, 16, seed=9) * 3
    if plant == "zeros":
        x[...] = 0.0
    elif plant != "randn":
        x[1, 2, 0, 3, 4] = np.nan if plant == "nan" else -np.inf
    x = _t(x, DTYPES[dtype])
    quant.quantize_amax.launches = 0
    slot = quant.quantize_amax(x)
    pq, pstats = quant.quantize_absmax_plain(x)
    assert slot.shape == (1,) and slot.dtype == torch.float32
    assert _same_bits(slot[0], pstats[0])
    xq, stats = quant.quantize_from_amax(x, slot)
    assert torch.equal(xq, pq) and _same_bits(stats, pstats)
    assert quant.quantize_amax.launches == 0   # the CPU


def test_quantize_amax_operator_fake_and_no_gradient():
    x = _t(_normal(2, 3, 3, 3, 8, seed=10), torch.bfloat16)
    with FakeTensorMode() as mode:
        slot = torch.ops.dctseg.quantize_amax(mode.from_tensor(x))
    assert slot.shape == (1,) and slot.dtype == torch.float32
    torch.library.opcheck(torch.ops.dctseg.quantize_amax.default, (x,))
    with pytest.raises(RuntimeError, match="inference only"):
        quant.quantize_amax(x.float().requires_grad_()).sum().backward()


def test_quantize_input_reduces_the_slots_under_a_scale_group(monkeypatch):
    """Under ``spatial.scaled`` quantize_input takes its slots (K7's amax
    route, or the fused norm's) through the group's MAX reduction, then the
    from_amax route; outside it, the one-GPU routes as before.  On a D slab
    without a scale group it refuses."""
    from dctseg_torch.parallel import spatial
    seen = []

    def reduce(slots, group):
        seen.append((slots.clone(), group))
        return slots * 2
    monkeypatch.setattr(spatial, "reduce_amax", reduce)
    routes = _count_routes(monkeypatch)
    x = _t(_normal(2, 3, 3, 3, 8, seed=11))
    amax = x.reshape(2, -1).abs().amax(dim=1)
    group = object()
    with spatial.scaled(group):
        _, by_route = quant.quantize_input(x)
        _, by_slots = quant.quantize_input(x, amax)
    assert [g is group for _, g in seen] == [True, True]
    assert torch.equal(seen[0][0], x.abs().amax().reshape(1))
    assert torch.equal(seen[1][0], amax)
    assert by_route[0] == by_slots[0] == 2 * x.abs().amax()
    assert dict(routes) == {"from_amax": 2}
    quant.quantize_input(x)
    assert dict(routes) == {"from_amax": 2, "grid": 1}
    with spatial.sharded(spatial.Shard(None, 2, 0)), \
            pytest.raises(RuntimeError, match="scaled"):
        quant.quantize_input(x)


# csrc/quantize.cu quantize_one's constants
MAGIC, MAGIC_BITS, TIE_BAND = 12582912.0, 0x4B400000, 1.0 / 16384


def _rehearse_quantize_one(x, sx):
    """K7's per-element arithmetic in float32 torch ops (each one rounded
    to nearest even, as the kernel's __fmul_rn / __fadd_rn / __fdiv_rn):
    the product with the correctly rounded 1 / sx, clipped, rounded by
    adding 1.5 * 2^23; the quotient only within TIE_BAND of a half-integer.
    Returns (xq, how many elements took the quotient)."""
    one = torch.ones((), dtype=torch.float32)
    rcp = one / sx

    def rounded(c):
        return c + torch.tensor(MAGIC)
    c = torch.clamp(x * rcp, -127.0, 127.0)
    t = rounded(c)
    near = ((c - (t - torch.tensor(MAGIC))).abs() - 0.5).abs() < TIE_BAND
    t = torch.where(near, rounded(torch.clamp(x / sx, -127.0, 127.0)), t)
    return (t.view(torch.int32) - MAGIC_BITS).to(torch.int8), int(near.sum())


@pytest.mark.parametrize("case", ["randn", "ties", "near_ties", "tiny"])
def test_quantize_one_rehearsal_equals_true_division(case):
    """The kernel's product-and-check rounding equals round-half-even of
    the true quotient, clipped, on every element: random activations at
    scales that are not powers of two, exact half-way ties, values a few
    ulps either side of k + 0.5 (where the product alone would round the
    other way), and an absmax below the 1e-12 floor."""
    rng = np.random.default_rng(17)
    n = 1 << 18
    if case == "randn":
        x = rng.normal(size=n) * 2.7182817
    elif case == "ties":
        x = _tie_input((n,), 18).astype(np.float64)
    elif case == "tiny":
        x = rng.normal(size=n) * 1e-14
    else:
        x = rng.normal(size=n) * 3.3
    xt = torch.from_numpy(x.astype(np.float32))
    amax = xt.abs().amax()
    sx = quant.over_qmax(torch.clamp(amax, min=1e-12))
    if case == "near_ties":
        k = torch.from_numpy(rng.integers(-127, 127, size=n)).float()
        half = (k + 0.5) * sx
        ulps = torch.from_numpy(rng.integers(-4, 5, size=n)).to(torch.int32)
        xt = (half.view(torch.int32) + ulps).view(torch.float32)
        xt = torch.clamp(xt, -amax, amax)
    want, _ = quant.quantize_absmax_plain(xt) if case != "near_ties" else \
        quant.quantize_from_amax_plain(xt, amax.reshape(1))
    got, fallbacks = _rehearse_quantize_one(xt, sx)
    assert torch.equal(got, want)
    if case == "near_ties":
        by_product = torch.round(torch.clamp(xt * (1 / sx), -127, 127))
        # the product alone rounds some of them the other way
        assert (by_product.to(torch.int8) != want).any() and fallbacks


# ---- the amax-fed conv against JAX ----

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("residual", [False, True], ids=["nores", "res"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_amax_fed_conv_equals_jax_conv3d_int8(layout, residual, dtype):
    """The norm's output through the port's amax-fed int8 conv (K7's
    one-pass route, then K6's plain version) equals
    ``dctseg.ops.quant.conv3d_int8`` of the same values, run eagerly, bit
    for bit, with the bias added after the cast as the model adds it."""
    shape, fine = LAYOUTS[layout]
    dt = DTYPES[dtype]
    ci = shape[-1]
    x = _t(_normal(*shape, seed=9, scale=2.0), dt)
    r = _t(_normal(*shape, seed=10), dt) if residual else None
    y, amax = fusednorm.fused_instance_norm_act_amax(x, fine, act="lrelu",
                                                     residual=r)
    w = _normal(24, ci, 3, 3, 3, seed=11, scale=0.1)
    b = _normal(24, seed=12)
    wq, sw = quant.prepare_weight(_t(w))
    got = quant.conv3d_int8_prepared(y, wq, sw, 1, 1, _t(b, dt), amax)
    two_pass = quant.conv3d_int8_prepared(y, wq, sw, 1, 1, _t(b, dt))
    yj = jnp.asarray(y.float().numpy()).astype(JNP[dt])
    want = jax_quant.conv3d_int8(yj, jnp.asarray(_conv(w)))
    want = want + jnp.asarray(b).astype(want.dtype)
    assert got.dtype == dt and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert torch.equal(got, two_pass)


# ---- the tiny int8 forward ----

PATHS = {"direct": dict(s2d_fullres=False, s2d_halfres=False),
         "s2d": dict(s2d_fullres=True, s2d_halfres=True)}
# K7 calls by route in one tiny forward.  base_channels 4: on the direct
# path only the conv_semantic_* convs reach 64 input channels, none of
# them fed by a norm, and the three share one quantization; on the s2d
# path every dense s2d conv is int8.  The direct path at base_channels 16
# quantizes EnBlock3/4, Enblock8 and DeBlock4, as at full width
TINY_K7 = {("direct", 4, "int8"): {"from_amax": 0, "grid": 1},
           ("direct", 4, "int8_all"): {"from_amax": 0, "grid": 1},
           ("direct", 16, "int8"): {"from_amax": 14, "grid": 7},
           ("direct", 16, "int8_all"): {"from_amax": 14, "grid": 11},
           ("s2d", 4, "int8"): {"from_amax": 14, "grid": 4},
           ("s2d", 4, "int8_all"): {"from_amax": 14, "grid": 11}}


def _count_routes(monkeypatch, replace=None):
    """Count K7's calls by route; with ``replace``, run each through
    ``replace(x)`` instead."""
    counts = collections.Counter()
    for name, route in (("quantize_absmax", "grid"),
                        ("quantize_from_amax", "from_amax")):
        orig = getattr(quant, name)

        def counted(x, *amax, _orig=orig, _route=route):
            counts[_route] += 1
            return replace(x) if replace else _orig(x, *amax)
        monkeypatch.setattr(quant, name, counted)
    return counts


@pytest.mark.parametrize("path,base,spec", sorted(TINY_K7))
def test_tiny_int8_forward_equals_two_pass(monkeypatch, path, base, spec):
    """seg_probs of the tiny int8 model with fused norms: the norms' absmax
    feeding the one-pass route equals the forward with every conv's input
    quantized by quantize_absmax_plain, bit for bit; K7's calls by route
    as pinned."""
    model = cwf.build_model(tiny_model_config(
        **PATHS[path], base_channels=base, quantize=spec, fused_norms=True,
        use_pallas_attention=True), device="cpu",
        generator=torch.Generator().manual_seed(13))
    x = _normal(1, 32, 32, 32, 4, seed=14)
    predictor = Predictor(model, device="cpu")
    routes = _count_routes(monkeypatch)
    got = predictor.seg_probs(x)
    assert dict(routes) == {k: n for k, n in TINY_K7[path, base, spec]
                            .items() if n}
    monkeypatch.undo()
    plain = _count_routes(monkeypatch, replace=quant.quantize_absmax_plain)
    want = predictor.seg_probs(x)
    assert plain == routes
    assert torch.equal(got, want) and torch.isfinite(got).all()


# ---- the launch plans and the kernels' arguments ----

@pytest.mark.parametrize("route", quant.QUANT_ROUTES)
@pytest.mark.parametrize("numel,dtype,aligned,vec", [
    (8 * 32 ** 3 * 64, torch.bfloat16, 256, 8),
    (8 * 64 ** 3 * 128, torch.bfloat16, 256, 8),
    (8 * 32 ** 3 * 64, torch.float32, 256, 4),
    (3 * 5 * 7, torch.bfloat16, 256, 1),
    (8 * 16, torch.float16, 4, 2),
    (4 * 32, torch.float32, 8, 2)])
def test_quantize_plan(route, numel, dtype, aligned, vec):
    """The widest vector that fits the length and the address; one thread
    a vector, at most max_blocks blocks."""
    plan = quant.plan_quantize(numel, dtype, aligned, route, max_blocks=1056)
    assert plan.route == route and plan.vec == vec
    blocks = -(-numel // vec // quant.THREADS)
    assert plan.grid == max(1, min(blocks, 1056))
    assert quant.plan_quantize(numel, dtype, aligned, route,
                               max_blocks=7).grid == min(max(1, blocks), 7)
    with pytest.raises(ValueError, match="route"):
        quant.plan_quantize(numel, dtype, aligned, "two_pass")


class _Recorder:
    """Stands in for the kernel library: records each entry's int64
    argument array and answers the occupancy queries."""

    def __init__(self, sizes):
        self.sizes, self.calls = sizes, []

    def __getattr__(self, name):
        def entry(*args):
            if name.endswith("coresident"):
                for ref, value in zip(
                        [a for a in args if hasattr(a, "_obj")],
                        (1056, 49152)):
                    ref._obj.value = value
            else:
                n = self.sizes[name]
                self.calls.append((name, list(
                    (ctypes.c_int64 * n).from_address(args[0]))))
            return 0
        return entry


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder({"dctseg_quantize": len(quant.QUANT_ARGS),
                     "dctseg_fusednorm": len(fusednorm.LAUNCH_ARGS)})
    monkeypatch.setattr(_build, "lib", lambda: rec)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    for mod, name in ((quant, "_quant_workspaces"),
                      (quant, "_quant_coresident"),
                      (fusednorm, "_workspaces"),
                      (fusednorm, "_coresident")):
        monkeypatch.setattr(mod, name, {})
    fusednorm.plan_for.cache_clear()
    yield rec
    fusednorm.plan_for.cache_clear()


def test_k7_launch_arguments(recorder, monkeypatch):
    """The argument arrays K7's wrapper hands ``dctseg_quantize`` on each
    route (x, q, stats, n, dtype, vec, grid, route, slots, slot count,
    workspace: no per-call epoch, so two grid calls differ only in their
    output pointers), and its counters: one launch a call, each route on
    its operator's."""
    for counter in (quant.quantize_absmax, quant.quantize_from_amax):
        monkeypatch.setattr(counter, "launches", 0)
    x = torch.zeros(2, 8, 8, 8, 16, dtype=torch.bfloat16)
    amax = torch.zeros(2)
    xq, stats = quant._quantize_launch(x, amax)
    quant._quantize_launch(x)
    quant._quantize_launch(x)
    (_, a), (_, g1), (_, g2) = recorder.calls
    grid = -(-x.numel() // 8 // quant.THREADS)
    assert a[:2] == [x.data_ptr(), xq.data_ptr()]
    assert a[3:10] == [x.numel(), 1, 8, grid, 0, amax.data_ptr(), 2]
    assert a[10:] == [0]
    ws = quant._quant_workspaces[-1, 0]
    assert ws.dtype == torch.int32 and not ws.any()
    assert g1[7:] == [1, 0, 0, ws.data_ptr()]
    assert len(g1) == len(quant.QUANT_ARGS) and g2[3:] == g1[3:]
    assert quant.quantize_from_amax.launches == 1
    assert quant.quantize_absmax.launches == 2
    assert xq.dtype == torch.int8 and stats.shape == (2,)
    with pytest.raises(ValueError, match="amax"):
        quant._quantize_launch(x, amax.double())


def test_k7_amax_route_arguments(recorder, monkeypatch):
    """Route amax: x, no xq (0), its (1,) float32 slot in the stats'
    place, route 2, a grid of at most one wave's blocks, and the grid
    route's workspace, which both routes share; counted on
    quantize_amax."""
    for counter in (quant.quantize_absmax, quant.quantize_amax):
        monkeypatch.setattr(counter, "launches", 0)
    x = torch.zeros(2, 8, 8, 8, 16, dtype=torch.bfloat16)
    slot = quant._amax_launch(x)
    quant._quantize_launch(x)
    (_, a), (_, g) = recorder.calls
    ws = quant._quant_workspaces[-1, 0]
    assert slot.shape == (1,) and slot.dtype == torch.float32
    grid = -(-x.numel() // 8 // quant.THREADS)
    assert a == [x.data_ptr(), 0, slot.data_ptr(), x.numel(), 1, 8, grid, 2,
                 0, 0, ws.data_ptr()]
    assert g[10] == ws.data_ptr() and g[7] == 1
    assert quant.quantize_amax.launches == quant.quantize_absmax.launches == 1


@pytest.mark.parametrize("amax", [False, True], ids=["plain", "amax"])
def test_fusednorm_ext_launch_arguments(recorder, monkeypatch, amax):
    """The external-statistics pair hands both launches the same plan (its
    variant's split plan) and, with absmax slots, their address as the
    19th argument in both phases (0 without); the sums' address last.
    Each launch counts on its own wrapper: fused_norm_stats and
    fused_norm_apply, or with slots fused_norm_stats_amax and
    fused_norm_apply_amax."""
    for fn in (fusednorm.fused_norm_stats, fusednorm.fused_norm_apply,
               fusednorm.fused_norm_stats_amax,
               fusednorm.fused_norm_apply_amax):
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(recorder, "sizes", {
        "dctseg_fusednorm_ext": len(fusednorm.LAUNCH_ARGS) + 1})
    x = torch.zeros(2, 8, 8, 8, 16, dtype=torch.bfloat16)
    rows = fusednorm.VARIANTS
    if amax:
        sums, slots = fusednorm._launch(rows["fused_norm_stats_amax"], x,
                                        None, 16, 0.0, "none", 0.0)
        out = fusednorm._launch(rows["fused_norm_apply_amax"], x, None, 16,
                                1e-5, "relu", 0.01, sums, 1024.0, slots)
    else:
        sums, slots = fusednorm._launch(rows["fused_norm_stats"], x, None,
                                        16, 0.0, "none", 0.0), None
        out = fusednorm._launch(rows["fused_norm_apply"], x, None, 16, 1e-5,
                                "relu", 0.01, sums, 1024.0)
    (_, st), (_, ap) = recorder.calls
    plan = fusednorm.ext_plan_for(tuple(x.shape), x.dtype, 8, False, -1,
                                  amax)
    assert {key[-1] for key in fusednorm._coresident} == {amax}
    for args in (st, ap):
        assert args[11:13] == [plan.blocks, plan.rows_per_block]
        assert args[18] == (slots.data_ptr() if amax else 0)
        assert args[19] == sums.data_ptr()
    assert st[2] == 0 and ap[2] == out.data_ptr()
    assert (fusednorm.fused_norm_stats_amax.launches,
            fusednorm.fused_norm_apply_amax.launches,
            fusednorm.fused_norm_stats.launches,
            fusednorm.fused_norm_apply.launches) == ((1, 1, 0, 0) if amax
                                                     else (0, 0, 1, 1))


@pytest.mark.parametrize("amax", [False, True], ids=["plain", "amax"])
def test_fusednorm_launch_arguments(recorder, monkeypatch, amax):
    """Each variant hands the kernel its own plan (from its own occupancy
    query) and the absmax variant a pointer to its (N,) float32 slots as
    the 19th argument (0 for the plain variant); each counts its launches
    apart."""
    for fn in (fusednorm.fused_instance_norm_act,
               fusednorm.fused_instance_norm_act_amax):
        monkeypatch.setattr(fn, "launches", 0)
    x = torch.zeros(2, 8, 8, 8, 16, dtype=torch.bfloat16)
    got = fusednorm._launch(
        fusednorm.VARIANTS["fused_instance_norm_act_amax" if amax
                           else "fused_instance_norm_act"],
        x, None, 16, 1e-5, "relu", 0.01)
    (_, args), = recorder.calls
    plan = fusednorm.plan_for(tuple(x.shape), x.dtype, 8, False, -1, amax)
    # each variant's plan comes from its own kernels' occupancy
    assert {key[-1] for key in fusednorm._coresident} == {amax}
    assert args[11:13] == [plan.blocks, plan.rows_per_block]
    if amax:
        out, slots = got
        assert slots.shape == (2,) and slots.dtype == torch.float32
        assert args[18] == slots.data_ptr()
    else:
        out = got
        assert args[18] == 0
    assert args[:3] == [x.data_ptr(), 0, out.data_ptr()]
    counted = (fusednorm.fused_instance_norm_act_amax if amax
               else fusednorm.fused_instance_norm_act)
    other = (fusednorm.fused_instance_norm_act if amax
             else fusednorm.fused_instance_norm_act_amax)
    assert counted.launches == plan.launches and other.launches == 0


# ---- the full-width counts chip_smoke.py pins ----

@pytest.mark.parametrize("path,spec", sorted(chip_smoke.K7_CALLS))
def test_full_width_k7_calls_by_route(monkeypatch, path, spec):
    """K7's calls by route in one full-width B=8 forward, traced on fake
    tensors, as chip_smoke.K7_CALLS pins them; together, the int8 convs of
    chip_smoke.INT8_CONVS but 4: the three conv_mid_fea_* and the three
    conv_semantic_* quantize their shared input once."""
    routes = _count_routes(monkeypatch)
    model = cwf.ClsWiseFormer(ModelConfig(**PATHS[path], quantize=spec))
    with FakeTensorMode(allow_non_fake_inputs=True), torch.inference_mode():
        model(torch.empty(8, 128, 128, 128, 4))
    assert dict(routes) == chip_smoke.K7_CALLS[path, spec]
    assert sum(routes.values()) == chip_smoke.INT8_CONVS[path, spec] - 4


# ---- the serving bundle ----

def test_int8_bundle_carries_the_absmax_operators(tmp_path):
    """A tiny s2d int8 ``single`` bundle exported with fused norms holds
    the absmax variant and both K7 operators as graph nodes, as many as
    the forward calls, and predicts the live engine's probabilities bit
    for bit."""
    from dctseg_torch.infer.serving import ServingBundle, export_bundle
    model = cwf.build_model(tiny_model_config(
        **PATHS["s2d"], quantize="int8", fused_norms=True,
        use_pallas_attention=True), device="cpu",
        generator=torch.Generator().manual_seed(15))
    predictor = Predictor(model, device="cpu")
    out = str(tmp_path / "s2d_int8")
    export_bundle(predictor, out, strategy="single",
                  input_shape=(32, 32, 32))
    bundle = ServingBundle.load(out, device="cpu")
    targets = [n.target for n in bundle._p["forward"].graph.nodes
               if n.op == "call_function"]
    ops = torch.ops.dctseg
    pinned = TINY_K7["s2d", 4, "int8"]
    assert targets.count(ops.quantize_from_amax.default) == \
        pinned["from_amax"]
    assert targets.count(ops.fused_instance_norm_act_amax.default) == \
        pinned["from_amax"]
    assert targets.count(ops.quantize_absmax.default) == pinned["grid"]
    x = torch.from_numpy(_normal(1, 32, 32, 32, 4, seed=16))
    assert torch.equal(bundle.predict(x), predictor.seg_probs(x))
