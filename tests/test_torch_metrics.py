"""The port's EDT, order-statistic search and metrics against the JAX
package's, on the CPU.

Every comparison is exact: the EDT and the searches work on integers exact
in float32 (the JAX side runs its Pallas kernels in interpret mode and its
XLA twins), and DeviceMetrics finishes in float64 from exact integer counts
and order statistics, as the host scipy functions do.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy import ndimage as ndi

from dctseg import metrics as jax_metrics
from dctseg.ops import edt as jax_edt
from dctseg.ops.pallas import minplus as jax_minplus
from dctseg.ops.pallas import orderstats as jax_orderstats

from dctseg_torch import metrics
from dctseg_torch.ops import edt, minplus, orderstats

VMAX = metrics.VMAX
EDT_SHAPES = [(2, 10, 9, 11), (1, 11, 13, 6), (3, 5, 6, 7), (1, 1, 4, 3),
              (16, 16, 16), (13, 17, 9)]


def _mask(shape, seed, p=0.12):
    return np.random.default_rng(seed).random(shape) < p


@pytest.mark.parametrize("shape", EDT_SHAPES,
                         ids=["x".join(map(str, s)) for s in EDT_SHAPES])
def test_squared_edt_matches_pallas_xla_and_scipy(shape):
    m = _mask(shape, sum(shape))
    got = edt.squared_edt(torch.from_numpy(m)).numpy()
    f = jnp.where(jnp.asarray(m), jnp.float32(0), jax_edt.INF)
    np.testing.assert_array_equal(
        got, np.asarray(jax_minplus.squared_edt_3d(f, 4, 1, interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_edt.squared_edt(jnp.asarray(m), impl="xla")))
    if len(shape) == 3 and m.any():
        np.testing.assert_array_equal(
            got, np.round(ndi.distance_transform_edt(~m) ** 2))


def test_squared_edt_all_false_keeps_inf():
    m = np.zeros((1, 6, 7, 8), bool)
    got = edt.squared_edt(torch.from_numpy(m)).numpy()
    assert (got == edt.INF).all()
    np.testing.assert_array_equal(
        got, np.asarray(jax_edt.squared_edt(jnp.asarray(m), impl="xla")))


@pytest.mark.parametrize("shape", [(3, 7, 5), (1, 1, 9), (2, 33, 1)])
def test_minplus_pass_matches_pallas(shape):
    """The one-axis pass along axis 1 of (A, D, B), including D = 1 and
    B = 1, on sentinel-and-integer inputs."""
    rng = np.random.default_rng(5)
    x = np.where(rng.random(shape) < 0.3, rng.integers(0, 50, shape),
                 1e7).astype(np.float32)
    got = minplus.minplus_pass(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_minplus.minplus_sublane(jnp.asarray(x), 8,
                                                    interpret=True)))


def test_minplus_pass_plain_chunks_rows(monkeypatch):
    x = torch.from_numpy(np.random.default_rng(6).integers(
        0, 100, (2, 9, 5)).astype(np.float32))
    whole = minplus.minplus_pass_plain(x)
    monkeypatch.setattr(minplus, "_CHUNK_BYTES", 4 * 2 * 9 * 5 * 2)
    np.testing.assert_array_equal(minplus.minplus_pass_plain(x).numpy(),
                                  whole.numpy())


@pytest.mark.parametrize("shape", [(5, 7), (9, 1), (1, 33), (40, 3)])
def test_minplus_pass_minor_plain_is_the_pass_on_the_transpose(shape):
    """The minor-axis pass (R, D): the plain pass on the (1, D, R) view, and
    the same as the (A, D, B) pass with B = 1; the CPU wrapper launches
    nothing."""
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(np.where(rng.random(shape) < 0.4,
                                  rng.integers(0, 900, shape), edt.INF)
                         .astype(np.float32))
    minplus.minplus_pass.launches = 0
    got = minplus.minplus_pass_minor(x)
    assert got.is_contiguous() and minplus.minplus_pass.launches == 0
    np.testing.assert_array_equal(
        got.numpy(), minplus.minplus_pass_plain(x.t()[None])[0].t().numpy())
    np.testing.assert_array_equal(
        got.numpy(), minplus.minplus_pass_plain(x[:, :, None])[:, :, 0])


def _envelope_column(f):
    """csrc/minplus.cu's scan on one column, in the kernel's integer
    arithmetic and in-place layout: slot k holds entry k (vertex << 24 |
    value) once the scan has consumed position k.  The top's lower boundary
    is the fraction tn / (2 td); pops compare crossed-out products."""
    d = len(f)
    slot = [int(v) for v in f]
    if all(x == slot[0] for x in slot):    # a constant column is its output
        return np.asarray(slot, np.float32)
    out = [0] * d
    tv, tc, tn, td, sv, sc, n = 0, slot[0], 0, 1, 0, 0, 1
    q = 1
    while q < d:                       # each turn pops or takes position q
        fq = slot[q]
        cq = fq + q * q
        if n > 0 and (cq - tc) * td <= tn * (q - tv):
            n -= 1
            if n > 0:
                tv, tc = sv, sc
                if n >= 2:
                    e = slot[n - 2]
                    sv = e >> 24
                    sc = (e & 0xFFFFFF) + sv * sv
                    tn, td = tc - sc, tv - sv
                else:
                    tn, td = 0, 1
            continue
        num, den = cq - tc, q - tv
        push = True
        if n == 0:
            tn, td = 0, 1
        elif num > 2 * den * (d - 1):
            push = False
        else:
            assert abs(num * td) < 1 << 40 and abs(tn * den) < 1 << 40
            tn, td, sv, sc = num, den, tv, tc
        if push:
            assert n <= q and fq < 1 << 24
            slot[n] = (q << 24) | fq
            n, tv, tc = n + 1, q, cq
        q += 1
    k = n - 1
    v, fv, lv, lf = tv, tc - tv * tv, sv, sc - sv * sv
    for i in range(d - 1, -1, -1):
        while k > 0 and lf + (i - lv) ** 2 < fv + (i - v) ** 2:
            v, fv = lv, lf
            k -= 1
            if k > 0:
                lv, lf = slot[k - 1] >> 24, slot[k - 1] & 0xFFFFFF
        out[i] = fv + (i - v) ** 2
        assert out[i] < 1 << 24
    return np.asarray(out, np.float32)


# the kernel's value range: [0, 2^24 - 3 * 255^2), as after the EDT's passes
ENVELOPE_HI = (1 << 24) - 3 * 255 ** 2
ENVELOPE_KINDS = {
    "random": lambda g, d: g.integers(0, ENVELOPE_HI, (4, d)),
    "sparse": lambda g, d: np.where(g.random((4, d)) < 0.05,
                                    g.integers(0, 3 * 255 ** 2, (4, d)),
                                    edt.INF),
    "all_sentinel": lambda g, d: np.full((2, d), edt.INF),
    "all_equal": lambda g, d: np.full((2, d), g.integers(0, ENVELOPE_HI)),
    "ties": lambda g, d: g.integers(0, 3, (4, d)) * g.integers(1, 400),
}


@pytest.mark.parametrize("kind", list(ENVELOPE_KINDS))
@pytest.mark.parametrize("d", [1, 2, 3, 155, 240, 256])
def test_envelope_integer_arithmetic_matches_plain(d, kind):
    """The lower envelope as the CUDA kernel computes it, rehearsed here in
    its integer arithmetic: equal to minplus_pass_plain on every column."""
    g = np.random.default_rng(d * 7 + len(kind))
    f = ENVELOPE_KINDS[kind](g, d).astype(np.float32)
    want = minplus.minplus_pass_minor_plain(torch.from_numpy(f)).numpy()
    got = np.stack([_envelope_column(col) for col in f])
    np.testing.assert_array_equal(got, want)


def _order_stats_case(trial, hi):
    rng = np.random.default_rng(11 + trial)
    c, m = 3, int(rng.integers(100, 3000))
    vals = np.where(rng.random((c, m)) < 0.4,
                    rng.integers(0, hi, (c, m)).astype(np.float64),
                    1e7).astype(np.float32)
    nval = max(1, int((vals < VMAX).sum(1).min()))
    ks = rng.integers(0, nval, (c, 2)).astype(np.int32)
    return vals, ks


@pytest.mark.parametrize("fanout", [4, 8])
@pytest.mark.parametrize("hi", [5, 2500, 195075])
def test_order_stats_match_pallas_and_binary_search(hi, fanout):
    vals, ks = _order_stats_case(hi % 7, hi)
    want = np.asarray(jax_orderstats.masked_order_stats(
        jnp.asarray(vals), jnp.asarray(ks), VMAX, tile_rows=4,
        fanout=fanout, interpret=True))
    np.testing.assert_array_equal(want, np.asarray(jax_edt.masked_order_stats(
        jnp.asarray(vals), jnp.asarray(ks), VMAX, impl="xla")))
    tv, tk = torch.from_numpy(vals), torch.from_numpy(ks)
    np.testing.assert_array_equal(
        orderstats.masked_order_stats(tv, tk, VMAX).numpy(), want)
    np.testing.assert_array_equal(
        edt.binary_search_order_stats(tv, tk, VMAX).numpy(), want)
    np.testing.assert_array_equal(edt.masked_order_stats(tv, tk, VMAX).numpy(),
                                  want)


def test_count_leq_plain_counts():
    vals = torch.tensor([[0., 1., 2., 1e7], [3., 3., 3., 3.]])
    cuts = torch.tensor([[-1., 1., 1e7], [2., 3., 4.]])
    assert orderstats.count_leq(vals, cuts).tolist() == [[0, 2, 4],
                                                         [0, 4, 4]]
    assert orderstats.count_leq(vals, cuts).dtype == torch.int32


def _search_rehearsal(vals, ks, vmax):
    """The CUDA kernel's search mode (csrc/orderstats.cu search_kernel),
    pass by pass: the cuts and the narrowing scalar by scalar in float32,
    the counts as the kernel takes them -- a float4 whose smallest value is
    above every rank's hi skips, a value at or below lo - 1 counts once for
    all 7 cuts of its rank, one above hi for none, the rest against each
    cut -- with the counts compared to the ranks as integers."""
    f32 = np.float32
    c, m = vals.shape
    k = ks.shape[1]
    steps = orderstats.FANOUT - 1
    quads = np.full((c, -(-m // 4) * 4), np.nan, np.float32)
    quads[:, :m] = vals
    if m % 4:                      # the scalar-load instantiation
        quads = np.full((c, 4 * m), np.nan, np.float32)
        quads[:, ::4] = vals
    quads = quads.reshape(c, -1, 4)
    bounds = [[(f32(0), f32(vmax))] * k for _ in range(c)]
    passes = orderstats._passes(vmax)
    out = np.zeros((c, k), np.float32)
    for p in range(passes):
        for ci in range(c):
            cuts = []
            for r in range(k):
                lo, hi = bounds[ci][r]
                length = hi - lo + f32(1)
                cuts.append([lo - f32(1) + np.floor(f32(s) * length / f32(8))
                             for s in range(1, steps + 1)])
            cmax = max(hi for _, hi in bounds[ci])
            live = np.fmin.reduce(quads[ci], axis=1) <= cmax
            x = quads[ci][live].reshape(-1)
            for r in range(k):
                lo, hi = bounds[ci][r]
                below = x <= lo - f32(1)
                inside = ~below & (x <= hi)
                counts = [int(below.sum()) + int((x[inside] <= cut).sum())
                          for cut in cuts[r]]
                need = int(ks[ci, r]) + 1
                new_lo, new_hi = lo, hi
                for cs, cnt in zip(cuts[r], counts):
                    ok = cnt >= need
                    new_lo = max(new_lo, lo if ok else cs + f32(1))
                    new_hi = min(new_hi, cs if ok else hi)
                bounds[ci][r] = (f32(new_lo), f32(new_hi))
                if p == passes - 1:
                    out[ci, r] = new_hi
    return out


def _search_case(kind):
    """Small pools with the edge cases of the search: ties, all masked,
    one finite value, ranks 0 and n - 1, a row length not a multiple of
    4."""
    rng = np.random.default_rng(len(kind))
    inf = np.float32(edt.INF)
    if kind == "ties":
        vals = np.where(rng.random((3, 512)) < 0.5, 7.0, inf)
        vals[1, :100] = 3.0
    elif kind == "all_masked":
        vals = np.full((3, 256), inf)
    elif kind == "one_value":
        vals = np.full((3, 300), inf)
        vals[:, 17] = [0.0, 42.0, VMAX - 1]
    elif kind == "extreme_ranks":
        vals = np.where(rng.random((3, 1000)) < 0.3,
                        rng.integers(0, 195075, (3, 1000)), inf)
    else:                                   # "odd_length"
        vals = np.where(rng.random((2, 333)) < 0.4,
                        rng.integers(0, 2500, (2, 333)), inf)
    vals = vals.astype(np.float32)
    n = (vals < VMAX).sum(1)
    if kind == "extreme_ranks":
        ks = np.stack([np.zeros_like(n), n - 1], 1)
    else:
        ks = metrics.percentile_ranks(torch.from_numpy(n.astype(np.int32)))
        ks = ks.numpy()
    return vals, ks.astype(np.int32)


@pytest.mark.parametrize("kind", ["ties", "all_masked", "one_value",
                                  "extreme_ranks", "odd_length"])
def test_search_kernel_rehearsal_matches_plain_binary_and_pallas(kind):
    """The kernel's search rehearsed in Python equals the torch search the
    CPU runs, its plain version, the binary search and the JAX Pallas
    search in interpret mode."""
    vals, ks = _search_case(kind)
    got = _search_rehearsal(vals, ks, VMAX)
    tv, tk = torch.from_numpy(vals), torch.from_numpy(ks)
    np.testing.assert_array_equal(
        got, orderstats.masked_order_stats(tv, tk, VMAX).numpy())
    np.testing.assert_array_equal(
        got, orderstats.masked_order_stats_plain(tv, tk, VMAX).numpy())
    np.testing.assert_array_equal(
        got, edt.binary_search_order_stats(tv, tk, VMAX).numpy())
    np.testing.assert_array_equal(got, np.asarray(
        jax_orderstats.masked_order_stats(jnp.asarray(vals), jnp.asarray(ks),
                                          VMAX, tile_rows=4, interpret=True)))
    if kind == "all_masked":
        assert (got == VMAX).all()


@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 17, 9), (1, 5, 6, 7)])
def test_erode_cross_and_surface_match_jax_and_scipy(shape):
    m = _mask(shape, 1, p=0.6)
    got = edt.erode_cross(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_edt.erode_cross(jnp.asarray(m))))
    st = ndi.generate_binary_structure(len(shape), 1) if len(shape) == 3 \
        else None
    if st is not None:
        np.testing.assert_array_equal(got, ndi.binary_erosion(m, structure=st))
    np.testing.assert_array_equal(
        edt.surface(torch.from_numpy(m)).numpy(),
        np.asarray(jax_edt.surface(jnp.asarray(m))))


def test_percentile_ranks_match_numpy_float64():
    ns = np.concatenate([
        np.arange(0, 2001),
        np.random.default_rng(3).integers(0, 2 * 240 * 240 * 155, 5000),
        np.arange(0, 41) * 892800,          # multiples of 20 at scale
        np.array([2 * 240 * 240 * 155]),    # the largest pooled count
    ]).astype(np.int64)
    idx = 0.95 * (np.maximum(ns, 1) - 1).astype(np.float64)
    want = np.stack([np.floor(idx), np.ceil(idx)], -1).astype(np.int64)
    got = metrics.percentile_ranks(torch.from_numpy(ns.astype(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


def _blobby_labels(seed, shape=(24, 24, 24)):
    r = np.random.default_rng(seed)
    arr = np.zeros(shape, np.int32)
    zz, yy, xx = np.ogrid[:shape[0], :shape[1], :shape[2]]
    for lab in (1, 2, 3):
        c = r.integers(4, 20, 3)
        rad = r.integers(2, 6)
        arr[(zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
            < rad ** 2] = lab
    return arr


@pytest.mark.parametrize("bcs", [True, False], ids=["reference", "surface"])
def test_device_metrics_equal_jax_and_host(bcs):
    dm = metrics.DeviceMetrics(batched_call_shape=bcs, device="cpu")
    jdm = jax_metrics.DeviceMetrics(batched_call_shape=bcs)
    for seed in range(3):
        out, tgt = _blobby_labels(seed), _blobby_labels(seed + 100)
        d = dm(out, tgt)
        assert d == jdm(out, tgt)
        assert d["dice"] == metrics.softmax_output_dice(out, tgt)
        assert d["miou"] == metrics.softmax_output_miou(out, tgt)
        assert d["hd95"] == metrics.cal_hausdorff(out, tgt,
                                                  batched_call_shape=bcs)
        assert d["hd95"] == jax_metrics.cal_hausdorff(out, tgt,
                                                      batched_call_shape=bcs)


def test_device_metrics_degenerate_batch_axis_and_no_hd95():
    dm = metrics.DeviceMetrics(device="cpu")
    z = np.zeros((8, 8, 8), np.int32)
    assert dm(z, z)["hd95"] == [0.0, 0.0, 0.0]
    assert dm(z, z) == jax_metrics.DeviceMetrics()(z, z)
    out, tgt = _blobby_labels(7), _blobby_labels(8)
    # a leading batch-1 axis is stripped (validate passes (1, D, H, W))
    assert dm(out[None], tgt[None]) == dm(out, tgt)
    assert dm(torch.from_numpy(out), torch.from_numpy(tgt)) == dm(out, tgt)
    no_hd = metrics.DeviceMetrics(use_hd95=False, device="cpu")(out, tgt)
    assert no_hd == jax_metrics.DeviceMetrics(use_hd95=False)(out, tgt)
    assert no_hd["hd95"] == [0.0, 0.0, 0.0]


def test_host_metrics_match_jax():
    out, tgt = _blobby_labels(1), _blobby_labels(2)
    for name in ("softmax_output_dice", "softmax_output_miou",
                 "softmax_miou_score"):
        assert getattr(metrics, name)(out, tgt) == \
            getattr(jax_metrics, name)(out, tgt)
    a, b = out > 0, tgt > 0
    assert metrics.hausdorff_distance(a, b) == \
        jax_metrics.hausdorff_distance(a, b)
    assert np.isnan(metrics.hausdorff_distance_95(
        np.zeros_like(a), b, nan_for_nonexisting=True))


def test_cpu_wrappers_launch_nothing():
    minplus.minplus_pass.launches = 0
    orderstats.count_leq.launches = 0
    orderstats.masked_order_stats.launches = 0
    metrics.DeviceMetrics(device="cpu")(_blobby_labels(3), _blobby_labels(4))
    assert minplus.minplus_pass.launches == 0
    assert orderstats.count_leq.launches == 0
    assert orderstats.masked_order_stats.launches == 0


def test_wrappers_reject_bad_arguments():
    with pytest.raises(ValueError, match="A, D, B"):
        minplus.minplus_pass(torch.zeros(4, 4))
    with pytest.raises(ValueError, match="above"):
        minplus.minplus_pass(torch.zeros(1, 257, 1))
    v = torch.zeros(2, 10)
    with pytest.raises(ValueError, match="cut points"):
        orderstats.count_leq(v, torch.zeros(2, 33))
    with pytest.raises(ValueError, match="float32"):
        orderstats.count_leq(v.double(), torch.zeros(2, 3))
    # 5 ranks x (FANOUT - 1) cut points exceed what one launch takes
    with pytest.raises(ValueError, match="cut points"):
        orderstats.masked_order_stats(v, torch.zeros(2, 5, dtype=torch.int32),
                                      VMAX)


def test_search_fanout_and_pass_count(monkeypatch):
    """A power-of-two fanout, and the 7 passes per search that the chip
    check asserts at BraTS vmax."""
    assert orderstats.FANOUT & (orderstats.FANOUT - 1) == 0
    calls = []
    real = orderstats.count_leq
    monkeypatch.setattr(orderstats, "count_leq", lambda v, c: (
        calls.append(tuple(c.shape)), real(v, c))[1])
    vals, ks = _order_stats_case(0, 2500)
    orderstats.masked_order_stats(torch.from_numpy(vals),
                                  torch.from_numpy(ks), VMAX)
    assert calls == [(3, 2 * (orderstats.FANOUT - 1))] * 7


@pytest.mark.parametrize("form", ["1d", "batched", "broadcast_ks"])
def test_order_stats_any_leading_shape_goes_through_count_leq(form,
                                                              monkeypatch):
    """Every form of the search runs as one (C, M) / (C, K) count: the
    route a CUDA tensor takes to the kernel."""
    vals, ks = _order_stats_case(3, 2500)
    if form == "1d":
        tv, tk = torch.from_numpy(vals[0]), torch.from_numpy(ks[0])
    elif form == "batched":
        tv = torch.from_numpy(np.stack([vals, vals[::-1]]))       # (2, 3, M)
        tk = torch.from_numpy(np.stack([ks, ks[::-1]]))           # (2, 3, K)
    else:
        tv, tk = torch.from_numpy(vals), torch.from_numpy(ks[:1])  # (1, K)
    shapes = []
    real = orderstats.count_leq
    monkeypatch.setattr(orderstats, "count_leq", lambda v, c: (
        shapes.append((v.dim(), c.dim())), real(v, c))[1])
    got = edt.masked_order_stats(tv, tk, VMAX)
    assert set(shapes) == {(2, 2)}
    np.testing.assert_array_equal(
        got.numpy(), edt.binary_search_order_stats(tv, tk, VMAX).numpy())
