"""K9 (``dctseg_torch/ops/layernorm.py``, ``csrc/layernorm.cu``): the
encoder LayerNorms of Swin UNETR with the pad, shift and window partition in
their addressing.

On the CPU: each route's plain version against the torch sequence the model
ran before K9 (written out here), bit for bit, over padded and unpadded,
shifted and unshifted, clamped and non-cubic grids; the kernel's index
arithmetic rehearsed against that sequence; the lane plan; the Swin
encoder against its forward before K9; the counters.  On a card (marker
``card``; ``python3 -m pytest --noconftest -m card
tests/test_torch_layernorm.py``): each route against its f32 plain version
at the four stages' B=8 shapes.  This file imports no JAX.
"""

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from dctseg_torch.models import swin_unetr as su
from dctseg_torch.ops import _build
from dctseg_torch.ops import layernorm as ln

WS, SHIFT = 7, 3
# (grid, window and shift as configured): get_window_size gives the rest
GEOMETRIES = {
    "unpadded": ((14, 14, 14), 0),
    "unpadded_shifted": ((14, 14, 14), SHIFT),
    "pad8to14_shifted": ((8, 8, 8), SHIFT),
    "pad16to21": ((16, 16, 16), 0),
    "pad16to21_shifted": ((16, 16, 16), SHIFT),
    "clamped4": ((4, 4, 4), SHIFT),
    "noncubic_shifted": ((9, 4, 12), SHIFT),
}
WIDTHS = (48, 96, 384)
DTYPES = (torch.bfloat16, torch.float32)


def geometry(name):
    grid, shift = GEOMETRIES[name]
    return (grid,) + su.get_window_size(grid, (WS,) * 3, (shift,) * 3)


def inputs(grid, c, dtype, batch=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((batch, *grid, c), generator=g) * 2 + 0.5).to(dtype)
    w = torch.randn(c, generator=g) * 0.5 + 1
    b = torch.randn(c, generator=g) * 0.1
    return x, w, b


# ---- the model's sequence before K9, as it was ----

def old_norm(x, w, b, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(x.dtype)


def old_to_windows(x, w, b, eps, window, shift):
    b_, d, h, wd = x.shape[:4]
    y = old_norm(x, w, b, eps)
    pads = [(-n) % wn for n, wn in zip((d, h, wd), window)]
    if any(pads):
        y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    if any(shift):
        y = torch.roll(y, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
    return su.window_partition(y, window)


def old_residual(windows, x, w, b, eps, window, shift):
    b_, d, h, wd = x.shape[:4]
    pads = [(-n) % wn for n, wn in zip((d, h, wd), window)]
    dims = (b_, d + pads[0], h + pads[1], wd + pads[2])
    ww = window
    y = windows.view(b_, dims[1] // ww[0], dims[2] // ww[1], dims[3] // ww[2],
                     ww[0], ww[1], ww[2], -1)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(*dims, -1)
    if any(shift):
        y = torch.roll(y, shifts=shift, dims=(1, 2, 3))
    if any(pads):
        y = y[:, :d, :h, :wd]
    x = x + y
    return x, old_norm(x, w, b, eps)


def old_block(blk, x):
    """SwinTransformerBlock.forward before K9."""
    window, shift = su.get_window_size(x.shape[1:4], blk.window, blk.shift)
    pads = [(-n) % wn for n, wn in zip(x.shape[1:4], window)]
    dims = [n + p for n, p in zip(x.shape[1:4], pads)]
    ids = su.region_ids(dims, window, shift, x.device) if any(shift) \
        else None
    n1, n2 = blk.norm1, blk.norm2
    y = blk.attn(old_to_windows(x, n1.weight, n1.bias, n1.eps, window,
                                shift), ids)
    x, y = old_residual(y, x, n2.weight, n2.bias, n2.eps, window, shift)
    y = blk.mlp["linear2"](F.gelu(blk.mlp["linear1"](y), approximate="none"))
    return x + y


# ---- the plain routes are that sequence ----

@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_to_windows_plain_is_the_old_sequence(geo, c, dtype):
    grid, window, shift = geometry(geo)
    x, w, b = inputs(grid, c, dtype)
    want = old_to_windows(x, w, b, 1e-5, window, shift)
    got = ln.layer_norm_to_windows_plain(x, w, b, 1e-5, window, shift)
    assert got.shape == ln._to_windows_shape(x, window)
    assert torch.equal(got, want)
    # the operator on a CPU tensor is the plain version
    assert torch.equal(ln.layer_norm_to_windows(x, w, b, 1e-5, window,
                                                shift), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_windows_residual_plain_is_the_old_sequence(geo, c, dtype):
    grid, window, shift = geometry(geo)
    x, w, b = inputs(grid, c, dtype)
    g = torch.Generator().manual_seed(1)
    windows = torch.randn(ln._to_windows_shape(x, window),
                          generator=g).to(dtype)
    want = old_residual(windows, x, w, b, 1e-5, window, shift)
    for got in (ln.windows_residual_layer_norm_plain(
                    windows, x, w, b, 1e-5, window, shift),
                ln.windows_residual_layer_norm(windows, x, w, b, 1e-5,
                                               window, shift)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("c", (48, 384, 768, 3072))
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_plain_is_f_layer_norm(c, dtype, affine):
    """The plain route (PatchMerging's 8C norm up to 3072, proj_out without
    parameters) against F.layer_norm in f32, cast back."""
    x, w, b = inputs((3, 2, 2), c, dtype)
    if not affine:
        w = b = None
    want = F.layer_norm(x.float(), (c,), w, b, 1e-5).to(dtype)
    assert torch.equal(ln.layer_norm_plain(x, w, b, 1e-5), want)
    assert torch.equal(ln.layer_norm(x, w, b, 1e-5), want)


# ---- the kernel's addressing, rehearsed ----

def source_rows(batch, grid, window, shift):
    """csrc/layernorm.cu window_source over every output row of the
    windows: the row of x it reads, or -1 in the padding."""
    d, h, w = grid
    dp, hp, wp = ln.padded(grid, window)
    wd, wh, ww = window
    n = wd * wh * ww
    nwh, nww = hp // wh, wp // ww
    nw = (dp // wd) * nwh * nww
    o = torch.arange(batch * nw * n)
    t, win = o % n, o // n
    b, wi = win // nw, win % nw
    iw, ih, id_ = wi % nww, (wi // nww) % nwh, wi // (nww * nwh)
    tw, th, td = t % ww, (t // ww) % wh, t // (ww * wh)
    qd = (id_ * wd + td + shift[0]) % dp
    qh = (ih * wh + th + shift[1]) % hp
    qw = (iw * ww + tw + shift[2]) % wp
    src = ((b * d + qd) * h + qh) * w + qw
    return torch.where((qd < d) & (qh < h) & (qw < w), src, -1)


def window_rows(batch, grid, window, shift):
    """csrc/layernorm.cu window_row over every token of the grid: the row
    of the windows it reads."""
    d, h, w = grid
    dp, hp, wp = ln.padded(grid, window)
    wd, wh, ww = window
    q = torch.arange(batch * d * h * w)
    qw, qh, bd = q % w, (q // w) % h, q // (w * h)
    qd, b = bd % d, bd // d
    pd, ph, pw = (qd - shift[0]) % dp, (qh - shift[1]) % hp, \
        (qw - shift[2]) % wp
    nwh, nww = hp // wh, wp // ww
    nw = (dp // wd) * nwh * nww
    win = ((pd // wd) * nwh + ph // wh) * nww + pw // ww
    t = ((pd % wd) * wh + ph % wh) * ww + pw % ww
    return (b * nw + win) * (wd * wh * ww) + t


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_kernel_addressing_rehearsed(geo):
    """The kernel's closed-form maps give the plain sequence: route
    ``to_windows`` reads x's row ``source_rows`` (zeros where -1), route
    ``windows_residual`` the window row ``window_rows``."""
    grid, window, shift = geometry(geo)
    x, w, b = inputs(grid, 8, torch.float32, batch=3)
    rows = x.reshape(-1, 8)
    normed = F.layer_norm(rows, (8,), w, b, 1e-5)
    src = source_rows(3, grid, window, shift)
    want = ln.layer_norm_to_windows_plain(x, w, b, 1e-5, window, shift)
    got = torch.where((src >= 0)[:, None], normed[src.clamp(min=0)], 0.0)
    assert torch.equal(got, want.reshape(-1, 8))
    windows = torch.randn(want.shape, generator=torch.Generator()
                          .manual_seed(2))
    total, _ = ln.windows_residual_layer_norm_plain(windows, x, w, b, 1e-5,
                                                    window, shift)
    idx = window_rows(3, grid, window, shift)
    assert torch.equal(rows + windows.reshape(-1, 8)[idx],
                       total.reshape(-1, 8))
    # each token of the grid is read by exactly one window row and back
    assert torch.equal(torch.sort(src[src >= 0]).values,
                       torch.arange(rows.shape[0]))
    assert torch.equal(src[idx], torch.arange(rows.shape[0]))


@pytest.mark.parametrize("c,dtype,plan", [
    (48, torch.bfloat16, (3, 2)), (96, torch.bfloat16, (3, 4)),
    (192, torch.bfloat16, (3, 8)), (384, torch.bfloat16, (3, 16)),
    (768, torch.bfloat16, (3, 32)), (1536, torch.bfloat16, (6, 32)),
    (3072, torch.bfloat16, (12, 32)), (48, torch.float32, (3, 4)),
    (3072, torch.float32, (24, 32)), (24, torch.float16, (3, 1)),
    (64, torch.bfloat16, (1, 8))])
def test_lane_plan(c, dtype, plan):
    """A group of G lanes a row, V 16-byte vectors a lane: 2 lanes at 48
    channels in bf16, a warp from 768."""
    v, lanes = ln.plan_lanes(c, dtype)
    assert (v, lanes) == plan
    assert v * lanes * 16 // (torch.finfo(dtype).bits // 8) == c


@pytest.mark.parametrize("c,dtype", [(44, torch.bfloat16),
                                     (40, torch.bfloat16),
                                     (6144, torch.bfloat16)])
def test_lane_plan_refuses(c, dtype):
    with pytest.raises(ValueError):
        ln.plan_lanes(c, dtype)


def test_wrappers_refuse_bad_arguments():
    x, w, b = inputs((8, 8, 8), 48, torch.bfloat16)
    with pytest.raises(ValueError):
        ln.layer_norm_to_windows(x, w, b, 1e-5, (7, 7, 7), (7, 3, 3))
    with pytest.raises(ValueError):
        ln.layer_norm_to_windows(x, w.double(), b, 1e-5, (7, 7, 7),
                                 (3, 3, 3))
    with pytest.raises(ValueError):
        ln.layer_norm_to_windows(x[0], w, b, 1e-5, (7, 7, 7), (3, 3, 3))
    with pytest.raises(ValueError):
        ln.windows_residual_layer_norm(x.new_zeros(2, 343, 48), x, w, b,
                                       1e-5, (7, 7, 7), (3, 3, 3))


def test_operators_trace_on_fake_tensors():
    """The fake implementations give each route's shapes (the profiler
    counts a forward under a FakeTensorMode)."""
    with FakeTensorMode():
        x = torch.empty(2, 8, 8, 8, 48, dtype=torch.bfloat16)
        w, b = torch.empty(48), torch.empty(48)
        win = ln.layer_norm_to_windows(x, w, b, 1e-5, (7, 7, 7), (3, 3, 3))
        total, normed = ln.windows_residual_layer_norm(
            win, x, w, b, 1e-5, (7, 7, 7), (3, 3, 3))
        plain = ln.layer_norm(x, None, None, 1e-5)
    assert win.shape == (2 * 8, 343, 48) and win.dtype == torch.bfloat16
    assert total.shape == normed.shape == plain.shape == x.shape


# ---- the model ----

def tiny_swin(dtype="float32"):
    cfg = su.SwinUNETRConfig(feature_size=24, compute_dtype=dtype)
    return su.build_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(7))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swin_encoder_equals_its_forward_before_k9(dtype, monkeypatch):
    """The encoder (every K9 site: 8 to_windows, 8 windows_residual, 4
    merging norms, 5 proj_out) against the same encoder with the torch
    sequence before K9 at those sites, and a shifted block against its
    forward before K9, bit for bit; a CPU forward moves no K9 counter."""
    model = tiny_swin(dtype)
    x = torch.randn(2, 32, 32, 32, 4, generator=torch.Generator()
                    .manual_seed(8)).to(getattr(torch, dtype))
    before = _build.launch_counts()
    with torch.no_grad():
        got = model.swinViT(x)
        h = model.swinViT.patch_embed(x)
        blk = model.swinViT.layers1[0].blocks[1]
        assert blk.shift == (SHIFT,) * 3
        assert torch.equal(blk(h), old_block(blk, h))
    assert _build.launches_since(before) == {}
    monkeypatch.setattr(su, "layer_norm_to_windows", old_to_windows)
    monkeypatch.setattr(su, "windows_residual_layer_norm", old_residual)
    monkeypatch.setattr(su, "layer_norm", old_norm)
    with torch.no_grad():
        want = model.swinViT(x)
    assert len(got) == len(want) == 5
    for u, v in zip(got, want):
        assert torch.equal(u, v)


def test_counted_lists_k9():
    assert _build.COUNTED["layernorm"] == (
        "layer_norm_to_windows", "windows_residual_layer_norm", "layer_norm")
    fns = {fn.__name__ for fn in _build.counted_ops()}
    assert {"layer_norm_to_windows", "windows_residual_layer_norm",
            "layer_norm"} <= fns


# ---- on a card ----

# the four stages of a B=8 forward on 128^3 crops: (tokens a side, channels)
STAGES = ((64, 48), (32, 96), (16, 192), (8, 384))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def bf16_ulp(v):
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126)))
                      - 7)


def within_ulp(got, want):
    """got (bf16) within one bf16 ulp of the f32 ``want`` (+ 1e-6)."""
    return bool(((got.float() - want).abs()
                 <= bf16_ulp(want) + 1e-6).all())


@pytest.mark.card
@pytest.mark.parametrize("shift", [0, SHIFT])
@pytest.mark.parametrize("edge,c", STAGES)
def test_k9_routes_on_the_card(card, edge, c, shift):
    """Each route at the stage's B=8 shape: within one bf16 ulp of its
    plain version on f32 inputs; the residual sum bit for bit; one launch a
    call, counted on its wrapper; two calls equal."""
    grid = (edge,) * 3
    window, sh = su.get_window_size(grid, (WS,) * 3, (shift,) * 3)
    x, w, b = inputs(grid, c, torch.bfloat16, batch=8)
    x, w, b = x.to(card), w.to(card), b.to(card)
    before = _build.launch_counts()
    win = ln.layer_norm_to_windows(x, w, b, 1e-5, window, sh)
    want = ln.layer_norm_to_windows_plain(x.float(), w, b, 1e-5, window, sh)
    assert within_ulp(win, want)
    assert torch.equal(win, ln.layer_norm_to_windows(x, w, b, 1e-5, window,
                                                     sh))
    y = torch.randn(win.shape, device=card).bfloat16()
    total, normed = ln.windows_residual_layer_norm(y, x, w, b, 1e-5, window,
                                                   sh)
    want_total, _ = ln.windows_residual_layer_norm_plain(y, x, w, b, 1e-5,
                                                         window, sh)
    assert torch.equal(total, want_total)
    assert within_ulp(normed, ln.layer_norm_plain(total.float(), w, b,
                                                  1e-5))
    merged = torch.randn(8, edge // 2, edge // 2, edge // 2, 8 * c,
                         device=card).bfloat16()
    wm = torch.randn(8 * c, device=card)
    got = ln.layer_norm(merged, wm, None, 1e-5)
    assert within_ulp(got, ln.layer_norm_plain(merged.float(), wm, None,
                                               1e-5))
    assert within_ulp(ln.layer_norm(x, None, None, 1e-5),
                      ln.layer_norm_plain(x.float(), None, None, 1e-5))
    torch.cuda.synchronize()
    moved = {(fn.__name__, kind): n for (fn, _, kind), n
             in _build.launches_since(before).items()}
    assert moved == {("layer_norm_to_windows", None): 2,
                     ("windows_residual_layer_norm", None): 1,
                     ("layer_norm", None): 2}
