"""K6's tma route (``csrc/int8conv.cu``: TMA boxes into a ring, wgmma,
a persistent grid) rehearsed on the CPU.

The kernel runs only on the card; what surrounds it is Python that runs
here.  The launch plan (``ops/quant.py`` ``plan_int8_conv``) at every conv
signature of the full-width forwards and at ragged ones: its route, tile,
ring and grid; and at the calls of one rank's D slab under a mesh, whose
D is the slab's plus its int8 halo, padded by none.  The persistent
schedule: every tile exactly once, for
grids of 1 to 132 blocks.  The accumulator fragments of each wgmma width:
every element of a tile exactly once.  And the whole walk in torch --
the persistent schedule, the stages of (tap, chunk) units, each tap's A
box at its shifted corner with TMA's out-of-bounds zero fill and element
strides, B's boxes, the 32-byte wgmma k-steps and the epilogue's fragment
rows and columns -- against a float64 ``F.conv3d``, exactly.  And the
patches ``dctseg_torch/tools/k6_probe.py`` makes to the kernel's source.
"""

import math

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

import chip_smoke
import dctseg_torch.models.clswiseformer as cwf
from dctseg_torch.config import ModelConfig
from dctseg_torch.ops import _build, quant
from dctseg_torch.parallel import spatial
from dctseg_torch.tools import k6_probe

torch.set_num_threads(1)

PAD1, PAD0 = ((1, 1),) * 3, ((0, 0),) * 3
DOWN = ((1, 0),) * 3
# the distinct K6 calls of the full-width B=8 forwards (both paths, int8
# and int8_all): input, weight, stride, padding
FORWARD_CALLS = [
    ((8, 16, 16, 16, 128), (64, 1, 1, 1, 128), (1, 1, 1), PAD0),
    ((8, 16, 16, 16, 128), (128, 3, 3, 3, 128), (1, 1, 1), PAD1),
    ((8, 16, 16, 16, 128), (256, 3, 3, 3, 128), (1, 1, 1), PAD1),
    ((8, 16, 16, 16, 256), (128, 3, 3, 3, 256), (1, 1, 1), PAD1),
    ((8, 32, 32, 32, 32), (256, 1, 1, 1, 32), (1, 1, 1), PAD0),
    ((8, 32, 32, 32, 64), (32, 1, 1, 1, 64), (1, 1, 1), PAD0),
    ((8, 32, 32, 32, 64), (64, 3, 3, 3, 64), (1, 1, 1), PAD1),
    ((8, 32, 32, 32, 64), (128, 3, 3, 3, 64), (2, 2, 2), PAD1),
    ((8, 32, 32, 32, 96), (32, 3, 3, 3, 96), (1, 1, 1), PAD1),
    ((8, 32, 32, 32, 128), (64, 1, 1, 1, 128), (1, 1, 1), PAD0),
    ((8, 32, 32, 32, 256), (64, 2, 2, 2, 256), (1, 1, 1), DOWN),
    ((8, 32, 32, 32, 256), (128, 1, 1, 1, 256), (1, 1, 1), PAD0),
    ((8, 32, 32, 32, 256), (256, 3, 3, 3, 256), (1, 1, 1), PAD1),
    ((8, 32, 32, 32, 512), (256, 1, 1, 1, 512), (1, 1, 1), PAD0),
    ((8, 64, 64, 64, 16), (128, 1, 1, 1, 16), (1, 1, 1), PAD0),
    ((8, 64, 64, 64, 32), (128, 3, 3, 3, 32), (1, 1, 1), PAD1),
    ((8, 64, 64, 64, 64), (32, 1, 1, 1, 64), (1, 1, 1), PAD0),
    ((8, 64, 64, 64, 128), (32, 2, 2, 2, 128), (1, 1, 1), DOWN),
    ((8, 64, 64, 64, 128), (128, 3, 3, 3, 128), (1, 1, 1), PAD1),
    ((8, 64, 64, 64, 256), (128, 1, 1, 1, 256), (1, 1, 1), PAD0),
]
# chip_smoke.py's ragged calls (Ci not a multiple of 16), each with the
# mma_sync route's gather width
RAGGED_CALLS = [
    ((2, 9, 7, 5, 72), (40, 3, 3, 3, 72), (1, 1, 1), PAD1, 8),
    ((3, 5, 6, 7, 36), (24, 3, 3, 3, 36), (2, 1, 2),
     ((1, 0), (1, 1), (0, 1)), 4),
]


def _plan(x_shape, w_shape, stride, pads, aligned=256):
    out = quant.out_shape(x_shape, w_shape, stride, pads)
    return quant.plan_int8_conv(tuple(x_shape), tuple(w_shape), out[1:4],
                                tuple(stride), aligned)


def _check_tma_plan(plan, x_shape, w_shape, stride, pads):
    """The tma plan's invariants for one call."""
    out = quant.out_shape(x_shape, w_shape, stride, pads)
    ci, co = x_shape[-1], w_shape[0]
    assert plan.route == "tma" and plan.vec == 0
    assert plan.bn in quant.TMA_WIDTHS and (co <= plan.bn or plan.bn == 256)
    assert plan.bn == min(w for w in quant.TMA_WIDTHS if w >= min(co, 256))
    assert plan.m_sub == (2 if plan.bn <= 128 else 1)
    assert math.prod(plan.block) == 128 * plan.m_sub
    assert all(b & (b - 1) == 0 for b in plan.block)
    assert all(b * s <= quant.TMA_MAX_BOX
               for b, s in zip(plan.block, stride))
    assert plan.chunk in (32, 64, 128)
    assert ci % plan.chunk == 0 or plan.chunk == 32
    assert plan.group * plan.chunk == quant.STAGE_K
    assert plan.tiles == x_shape[0] * math.ceil(co / plan.bn) * math.prod(
        math.ceil(o / b) for o, b in zip(out[1:4], plan.block))
    assert plan.grid == (min(plan.tiles, quant.H100_SMS),)
    assert 2 <= plan.stages <= quant.MAX_STAGES
    assert plan.stages * plan.stage_bytes() <= quant.SMEM_BYTES
    assert plan.smem_bytes() <= quant.SMEM_BYTES
    # as deep as shared memory allows
    assert plan.stages == quant.MAX_STAGES or plan._replace(
        stages=plan.stages + 1).smem_bytes() > quant.SMEM_BYTES


@pytest.mark.parametrize("x_shape,w_shape,stride,pads", FORWARD_CALLS)
def test_tma_plan_at_every_forward_call(x_shape, w_shape, stride, pads):
    plan = _plan(x_shape, w_shape, stride, pads)
    _check_tma_plan(plan, x_shape, w_shape, stride, pads)
    # the model's extents are 16, 32 or 64: the blocks tile them exactly
    out = quant.out_shape(x_shape, w_shape, stride, pads)
    assert all(o % b == 0 for o, b in zip(out[1:4], plan.block))


@pytest.mark.parametrize("x_shape,w_shape,stride,pads,vec", RAGGED_CALLS)
def test_ragged_channels_take_the_mma_sync_route(x_shape, w_shape, stride,
                                                 pads, vec):
    plan = _plan(x_shape, w_shape, stride, pads)
    out = quant.out_shape(x_shape, w_shape, stride, pads)
    assert plan == quant.plan_mma_sync(x_shape, w_shape, out[1:4], 256)
    assert plan.route == "mma_sync" and plan.vec == vec


def test_route_follows_alignment_and_stride():
    x, w = (1, 8, 8, 8, 32), (16, 3, 3, 3, 32)
    assert _plan(x, w, (1, 1, 1), PAD1, aligned=16).route == "tma"
    assert _plan(x, w, (1, 1, 1), PAD1, aligned=8).route == "mma_sync"
    assert _plan(x, w, (1, 9, 1), PAD1).route == "mma_sync"


@pytest.mark.parametrize("path,spec", sorted(chip_smoke.INT8_CONVS))
def test_every_full_width_call_takes_the_tma_route(monkeypatch, path, spec):
    """The forward's calls, traced on fake tensors, are FORWARD_CALLS and
    each plans onto the tma route."""
    calls = []

    def recording(xq, stats, wq, sw, bias, stride, padding, out_dtype):
        calls.append((tuple(xq.shape), tuple(wq.shape),
                      quant._triple(stride), quant._pairs(padding)))
        return quant._conv_fake(xq, stats, wq, sw, bias,
                                list(quant._triple(stride)),
                                [p for pair in quant._pairs(padding)
                                 for p in pair], out_dtype)
    monkeypatch.setattr(quant, "int8_conv3d", recording)
    model = cwf.ClsWiseFormer(ModelConfig(**chip_smoke.PATHS[path],
                                          quantize=spec))
    with FakeTensorMode(allow_non_fake_inputs=True), torch.inference_mode():
        model(torch.empty(8, 128, 128, 128, 4))
    assert len(calls) == chip_smoke.INT8_CONVS[path, spec]
    assert set(calls) <= set(FORWARD_CALLS)
    for call in set(calls):
        _check_tma_plan(_plan(*call), *call)


@pytest.mark.parametrize("space", [2, 4])
def test_every_slab_call_takes_the_tma_route(monkeypatch, space):
    """The direct int8 forward at full width on one rank's D slab of a
    (data=1, space) mesh, traced on fake tensors (the collectives stand in
    with this rank's own tensor): as many K6 calls as unsharded; a 3^3
    conv's input holds the slab's D planes plus its halo, (1, 1) at stride
    1 and (1, 0) at stride 2, so D is no power of two, and K6 pads D by
    none; every call plans onto the tma route."""
    calls = []

    def recording(xq, stats, wq, sw, bias, stride, padding, out_dtype):
        calls.append((tuple(xq.shape), tuple(wq.shape),
                      quant._triple(stride), quant._pairs(padding)))
        return quant._conv_fake(xq, stats, wq, sw, bias,
                                list(quant._triple(stride)),
                                [p for pair in quant._pairs(padding)
                                 for p in pair], out_dtype)
    monkeypatch.setattr(quant, "int8_conv3d", recording)
    monkeypatch.setattr(spatial, "all_gather",
                        lambda t, group: [t.contiguous()] * space)
    monkeypatch.setattr(spatial, "all_reduce",
                        lambda t, group, op=None: t.clone())
    model = cwf.ClsWiseFormer(ModelConfig(quantize="int8"))
    with FakeTensorMode(allow_non_fake_inputs=True), \
            torch.inference_mode(), \
            spatial.sharded(spatial.Shard(None, space, 0)), \
            spatial.scaled(object()):
        model(torch.empty(8, 128, 128, 128, 4))
    assert len(calls) == chip_smoke.INT8_CONVS["direct", "int8"]
    halos = set()
    for x_shape, w_shape, stride, pads in set(calls):
        k, full_d = w_shape[1], x_shape[2]   # the grid is a cube
        slab = full_d // space if x_shape[1] != full_d else full_d
        assert pads[0] == (0, 0) or x_shape[1] == full_d
        if pads[0] == (0, 0) and k == 3:
            halos.add(x_shape[1] - slab)
            assert x_shape[1] - slab == (2 if stride[0] == 1 else 1)
        _check_tma_plan(_plan(x_shape, w_shape, stride, pads), x_shape,
                        w_shape, stride, pads)
    assert halos == {1, 2}


# ---- the persistent schedule and the fragments ----

def _block_tiles(tiles, grid, block):
    """The tiles block ``block`` of ``grid`` walks: the static stride."""
    return range(block, tiles, grid)


@pytest.mark.parametrize("tiles", [1, 7, 128, 131, 133, 1000, 8192])
def test_persistent_schedule_covers_each_tile_once(tiles):
    for grid in range(1, quant.H100_SMS + 1):
        seen = torch.zeros(tiles, dtype=torch.long)
        for block in range(min(grid, tiles)):
            idx = torch.tensor(list(_block_tiles(tiles, grid, block)),
                               dtype=torch.long)
            seen.index_add_(0, idx, torch.ones_like(idx))
        assert torch.equal(seen, torch.ones(tiles, dtype=torch.long))


def _fragments(bn, m_sub):
    """(row, column) in the tile of every accumulator the epilogue stores:
    consumer warpgroup wg, warp, lane, m64 block i, half h, 8-column block
    j and element e, the wgmma m64nNk32 s32 layout."""
    wg, warp, lane, i, h, j, e = torch.meshgrid(
        torch.arange(2), torch.arange(4), torch.arange(32),
        torch.arange(m_sub), torch.arange(2), torch.arange(bn // 8),
        torch.arange(2), indexing="ij")
    row = (wg * m_sub + i) * 64 + warp * 16 + h * 8 + lane // 4
    col = 8 * j + 2 * (lane % 4) + e
    return row.reshape(-1), col.reshape(-1)


@pytest.mark.parametrize("bn,m_sub", [(32, 2), (64, 2), (128, 2), (256, 1)])
def test_fragments_cover_the_tile_once(bn, m_sub):
    row, col = _fragments(bn, m_sub)
    hits = torch.zeros(128 * m_sub, bn, dtype=torch.long)
    hits.index_put_((row, col), torch.ones_like(row), accumulate=True)
    assert torch.equal(hits, torch.ones_like(hits))


def _quad_transpose(lanes):
    """csrc/int8conv.cu quad_transpose: the four lanes' a[0..3], each
    __shfl_xor_sync reading the partner lane's value."""
    a = [list(x) for x in lanes]
    for bit, pairs in ((1, ((0, 1), (2, 3))), (2, ((0, 2), (1, 3)))):
        for lo, hi in pairs:
            send = [a[q][lo] if q & bit else a[q][hi] for q in range(4)]
            for q in range(4):
                a[q][lo if q & bit else hi] = send[q ^ bit]
    return a


def test_quad_transpose_gives_each_lane_a_column_block():
    matrix = [[4 * q + t for t in range(4)] for q in range(4)]
    assert _quad_transpose(matrix) == [[4 * s + q for s in range(4)]
                                       for q in range(4)]


@pytest.mark.parametrize("bn,m_sub", [(32, 2), (64, 2), (128, 2), (256, 1)])
def test_wide_stores_cover_the_tile_once(bn, m_sub):
    """After the transpose lane q of a quad stores block j0 + q (8
    columns) of its rows, for j0 in steps of 4."""
    row, _ = _fragments(bn, m_sub)
    hits = torch.zeros(128 * m_sub, bn, dtype=torch.long)
    for r in row.unique():
        for lane_q in range(4):
            for j0 in range(0, bn // 8, 4):
                c = 8 * (j0 + lane_q)
                hits[r, c:c + 8] += 1
    assert torch.equal(hits, torch.ones_like(hits))


# ---- the walk ----

def _tma_load(t, coords, box, steps):
    """A TMA tiled load from ``t`` (dims outermost first) with
    ``coords``, ``box`` and ``steps`` innermost first, as the kernel passes
    them: ceil(box / step) elements along each dim from coords at the
    step, zero where out of bounds; the box outermost first."""
    idx = [c + s * torch.arange(-(-b // s))
           for c, b, s in zip(coords, box, steps)][::-1]
    grids = torch.meshgrid(*idx, indexing="ij")
    ok = torch.ones(grids[0].shape, dtype=torch.bool)
    for g, n in zip(grids, t.shape):
        ok &= (g >= 0) & (g < n)
    vals = t[tuple(g.clamp(0, n - 1) for g, n in zip(grids, t.shape))]
    return torch.where(ok, vals, 0)


def _rehearse_tma(xq, wq, stride, padding, grid=None):
    """The tma route in torch, from its plan: each block's tiles on the
    persistent schedule; per stage, the producer's boxes for its units
    (tap, chunk): A at the tap's shifted corner with TMA's zero fill and
    element strides, B at the tap's weights; the consumers' m64 blocks and
    32-byte k-steps over the units of the stage; and the epilogue's
    fragment stores (each output element checked to be stored once)."""
    n, d, h, w, ci = xq.shape
    co, k = wq.shape[0], wq.shape[1]
    pads = quant._pairs(padding)
    shape = quant.out_shape(xq.shape, wq.shape, stride, pads)
    od, oh, ow = shape[1:4]
    plan = _plan(xq.shape, wq.shape, stride, pads)
    _check_tma_plan(plan, xq.shape, wq.shape, stride, pads)
    grid = plan.grid[0] if grid is None else grid
    (bd, bh, bw), bn, ck, m_sub = plan.block, plan.bn, plan.chunk, plan.m_sub
    bm = 128 * m_sub
    nbz, nby, nbx = (math.ceil(o / b) for o, b in zip(shape[1:4],
                                                      plan.block))
    n_tiles = math.ceil(co / bn)
    chunks = math.ceil(ci / ck)
    units, group = k ** 3 * chunks, plan.group
    sd, sh, sw = stride
    xv, wv = xq.long(), wq.reshape(co, k ** 3, ci).long()
    out = torch.zeros(shape, dtype=torch.long)
    stores = torch.zeros(shape, dtype=torch.long)
    row, col = _fragments(bn, m_sub)
    for block in range(grid):
        for t in _block_tiles(plan.tiles, grid, block):
            n0, r = (t % n_tiles) * bn, t // n_tiles
            x0, r = (r % nbx) * bw, r // nbx
            y0, r = (r % nby) * bh, r // nby
            z0, nb = (r % nbz) * bd, r // nbz
            z, y, x = (z0 * sd - pads[0][0], y0 * sh - pads[1][0],
                       x0 * sw - pads[2][0])
            acc = torch.zeros(bm, bn, dtype=torch.long)
            seen = []
            for u0 in range(0, units, group):
                for u in range(u0, min(u0 + group, units)):
                    seen.append(u)
                    tap, c = u // chunks, u % chunks
                    a = _tma_load(xv, (c * ck, x + tap % k,
                                       y + tap // k % k, z + tap // (k * k),
                                       nb),
                                  (ck, bw * sw, bh * sh, bd * sd, 1),
                                  (1, sw, sh, sd, 1)).reshape(bm, ck)
                    b = _tma_load(wv, (c * ck, tap, n0), (ck, 1, bn),
                                  (1, 1, 1)).reshape(bn, ck)
                    for m64 in range(2 * m_sub):      # (wg, i) in order
                        rows = slice(64 * m64, 64 * m64 + 64)
                        for ks in range(0, ck, 32):
                            acc[rows] += (a[rows, ks:ks + 32]
                                          @ b[:, ks:ks + 32].T)
            assert seen == list(range(units))
            oz = z0 + row // (bw * bh)
            oy = y0 + row // bw % bh
            ox = x0 + row % bw
            oc = n0 + col
            keep = (oz < od) & (oy < oh) & (ox < ow) & (oc < co)
            at = (torch.full_like(oz[keep], nb), oz[keep], oy[keep],
                  ox[keep], oc[keep])
            out[at] = acc[row[keep], col[keep]]
            stores.index_put_(at, torch.ones_like(oz[keep]),
                              accumulate=True)
    assert torch.equal(stores, torch.ones_like(stores))
    return out


def _conv_f64(xq, wq, stride, padding):
    (dl, dh), (hl, hh), (wl, wh) = quant._pairs(padding)
    y = F.conv3d(F.pad(xq.permute(0, 4, 1, 2, 3).double(),
                       (wl, wh, hl, hh, dl, dh)),
                 wq.permute(0, 4, 1, 2, 3).double(), stride=stride)
    return y.permute(0, 2, 3, 4, 1).long()


@pytest.mark.parametrize("k,stride,padding,ci,co,shape,grid", [
    (3, (2, 2, 2), PAD1, 64, 70, (2, 9, 8, 7), None),      # stride 2, Co<BN
    (2, (1, 1, 1), DOWN, 32, 40, (1, 6, 5, 6), None),      # s2d down conv
    (1, (1, 1, 1), PAD0, 16, 24, (3, 4, 5, 7), None),      # pointwise, Ci 16
    (3, (1, 1, 1), PAD1, 96, 32, (1, 5, 6, 7), None),      # Ci 96, ragged
    (3, (2, 1, 2), ((1, 0), (1, 1), (0, 1)), 128, 64, (1, 5, 6, 7), None),
    (3, (1, 1, 1), PAD1, 48, 300, (1, 3, 4, 5), None),     # 2 Co tiles
    (3, (1, 1, 1), PAD1, 32, 16, (2, 8, 9, 17), 3),        # schedule wraps
    (3, (1, 1, 1), PAD1, 128, 256, (1, 3, 8, 8), None),    # BN 256
    # a D slab of 4 with its int8 halo: D padded by none
    (3, (1, 1, 1), ((0, 0), (1, 1), (1, 1)), 64, 64, (2, 6, 8, 8), None),
    (3, (2, 2, 2), ((0, 0), (1, 1), (1, 1)), 64, 32, (1, 5, 8, 8), None),
    (2, (1, 1, 1), ((0, 0), (1, 0), (1, 0)), 32, 40, (1, 5, 6, 6), None),
])
def test_tma_walk_rehearsal_equals_conv(k, stride, padding, ci, co, shape,
                                        grid):
    g = torch.Generator().manual_seed(ci + co)
    xq = torch.randint(-127, 128, (*shape, ci), generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (co, k, k, k, ci), generator=g,
                       dtype=torch.int8)
    got = _rehearse_tma(xq, wq, stride, padding, grid)
    assert torch.equal(got, _conv_f64(xq, wq, stride, padding))


@pytest.mark.parametrize("variant", sorted(k6_probe.VARIANTS))
def test_k6_probe_patches_match_the_kernel(variant):
    """Each of the probe's variants patches csrc/int8conv.cu where it
    means to: every patch matches the source once."""
    source = (_build.CSRC / "int8conv.cu").read_text()
    assert k6_probe.patched(source, k6_probe.VARIANTS[variant]) != source
