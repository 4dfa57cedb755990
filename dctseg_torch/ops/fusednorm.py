"""Fused InstanceNorm + activation (+ residual): the port of the TPU kernel
``dctseg/ops/pallas/fusednorm.py`` ``fused_instance_norm_act``.

The wrapper calls the operator ``torch.ops.dctseg.fused_instance_norm_act``
(``ops/library.py``).  On a CUDA tensor the operator launches the
hand-written kernel of ``dctseg_torch/csrc/fusednorm.cu`` or raises; on a CPU
tensor it runs the plain PyTorch version below, which follows the kernel's
order of operations: f32 per-lane sums, offsets folded onto fine channels,
y = x*a + b, activation in f32, cast, then the residual added in the output
dtype.  (The JAX package's XLA twin casts before the activation; the two
differ only where a bf16 rounding crosses zero.)

The kernel runs by one of two routes, which :func:`plan_launch` picks from
the shape and the card's occupancy: ``fused``, one cooperative launch in
which each sample's blocks meet at a barrier between the statistics and the
apply (where all samples fit on the chip at once), or ``split``, a
statistics launch and an apply launch.  Its workspace (partial sums,
scales and shifts, tickets and generation words) is kept per (device,
stream) and grows on demand; the kernel leaves the tickets at zero and
counts the fused route's calls in the generation words itself, so no call
allocates or fills anything but its output, and the launch's arguments
(:func:`launch_args`) hold nothing that changes from call to call but the
pointers: a CUDA graph can capture a call and replay it.  Inside
``_build.owned_workspaces`` (the engine's graphs) the workspace is the
owner's.  The backward recomputes the plain version under autograd, on
either device; the trainer keeps the kernel out of training, so no
backward kernel is owed.

:func:`fused_instance_norm_act_amax` (the operator
``torch.ops.dctseg.fused_instance_norm_act_amax``) also returns, per
sample, max |out| over the elements written: the statistic the int8
activation quantizer needs (``ops/quant.py`` ``quantize_from_amax``), so
that it reads the norm's output once.  Same kernel at one ``atomicMax`` a
block, with a launch plan of its own (from its own occupancy, so the plain
variant's plan does not depend on it); inference only (its backward
raises).

The external-statistics variant serves a volume whose D axis is sharded
over a space group (``parallel/spatial.py``): :func:`fused_norm_stats`
(``torch.ops.dctseg.fused_norm_stats``) is the split route's statistics
launch, writing each sample's raw f32 sums of x and x^2 per fine channel,
(N, 2, F); the caller all-reduces them over the group; and
:func:`fused_norm_apply` (``torch.ops.dctseg.fused_norm_apply``) is the
split route's apply launch on the reduced sums and the whole volume's
count.  With the local sums and count the pair gives the split route's
output bit for bit.  Where the output feeds an int8 conv on the slab, the
pair also reports its absmax slots: :func:`fused_norm_stats_amax`
(``torch.ops.dctseg.fused_norm_stats_amax``) returns (sums, slots), the
slots zeroed by the statistics launch, and :func:`fused_norm_apply_amax`
(``torch.ops.dctseg.fused_norm_apply_amax``) fills them with max |out| per
sample, bit for bit :func:`fused_instance_norm_act_amax`'s on the same
output.  Inference only (their backward raises).

:func:`fused_norm_residual_act` (``torch.ops.dctseg.fused_norm_residual_act``)
is the pre-activation residual route, MONAI's ``UnetResBlock`` ending
``lrelu(IN(conv2(h)) + r)``: y = act(x*a + b + r) in f32, cast once, where
:func:`fused_instance_norm_act` adds its residual after the activation and
the cast.  The same kernel with its own instantiations (and so its own
occupancy and plans), on either route; its launches count on
:func:`fused_instance_norm_act`'s counter, and every launch of that
counter also counts by route in its ``routes``: ``fused`` and ``split``,
and ``fused_pre`` and ``split_pre`` for this route.
"""

from __future__ import annotations

import array
import ctypes
import functools
import math
from typing import NamedTuple

import torch

from dctseg_torch.ops import _build, library

ACTS = {"none": 0, "relu": 1, "lrelu": 2}
# or-ed into the act argument: the residual goes in before the activation
# (csrc/fusednorm.cu kResidualBefore)
RESIDUAL_BEFORE = 8
# the residual's place, as plan_for, coresident and the kernel take it
RES_NONE, RES_AFTER, RES_BEFORE = 0, 1, 2
ROUTES = ("fused", "split", "fused_pre", "split_pre")
THREADS = 256           # csrc/fusednorm.cu kThreads
# The fused route runs where all samples fit in its blocks' staging shared
# memory plus this much of the H100's 50 MB L2, so the apply's second read
# of x stays on the chip; larger tensors take the split route.
FUSED_L2_BYTES = 40 << 20
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}


def _act(y: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    if act == "relu":
        return torch.clamp(y, min=0.0)
    if act == "lrelu":
        return torch.where(y >= 0, y, slope * y)
    return y


def norm_count(x: torch.Tensor, fine_channels: int) -> float:
    """The elements a sample's statistic of one fine channel sums: the
    spatial positions times the offsets folded onto the channel."""
    return float(math.prod(x.shape[1:-1]) * (x.shape[-1] // fine_channels))


def fused_norm_stats_plain(x: torch.Tensor,
                           fine_channels: int) -> torch.Tensor:
    """Plain version of the external-statistics launch: (N, 2, F) f32, the
    sums of x and of x^2 per (sample, fine channel)."""
    n, cb = x.shape[0], x.shape[-1]
    o = cb // fine_channels
    xr = x.reshape(n, -1, cb).float()
    s = xr.sum(dim=1).reshape(n, o, fine_channels).sum(dim=1)
    sq = xr.square().sum(dim=1).reshape(n, o, fine_channels).sum(dim=1)
    return torch.stack([s, sq], dim=1)


def _normed(x: torch.Tensor, sums: torch.Tensor, count: float,
            fine_channels: int, eps: float) -> torch.Tensor:
    """x*a + b in f32, (N, S, C): a and b of each lane's fine channel from
    the (N, 2, F) ``sums`` over ``count`` elements."""
    n, cb = x.shape[0], x.shape[-1]
    o = cb // fine_channels
    mean = sums[:, 0] / count
    var = torch.clamp(sums[:, 1] / count - mean.square(), min=0.0)
    a = torch.rsqrt(var + eps)
    b = -mean * a
    # lane o*C + c carries fine channel c
    a = a.repeat(1, o)[:, None, :]
    b = b.repeat(1, o)[:, None, :]
    return x.reshape(n, -1, cb).float() * a + b


def fused_norm_apply_plain(x: torch.Tensor, sums: torch.Tensor,
                           count: float, fine_channels: int,
                           eps: float = 1e-5, act: str = "none",
                           slope: float = 0.01,
                           residual: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Plain version of the external-statistics apply: the norm of x by
    the (N, 2, F) ``sums`` over ``count`` elements."""
    y = _normed(x, sums, count, fine_channels, eps)
    y = _act(y, act, slope).to(x.dtype).reshape(x.shape)
    return y + residual if residual is not None else y


def fused_norm_apply_amax_plain(x: torch.Tensor, sums: torch.Tensor,
                                count: float, fine_channels: int,
                                eps: float = 1e-5, act: str = "none",
                                slope: float = 0.01,
                                residual: torch.Tensor | None = None):
    """(out, amax): :func:`fused_norm_apply_plain` and, per sample, the
    float32 max of |out| (a NaN propagates)."""
    out = fused_norm_apply_plain(x, sums, count, fine_channels, eps, act,
                                 slope, residual)
    return out, out.reshape(out.shape[0], -1).float().abs().amax(dim=1)


def fused_norm_residual_act_plain(x: torch.Tensor, residual: torch.Tensor,
                                  fine_channels: int, eps: float = 1e-5,
                                  act: str = "none", slope: float = 0.01
                                  ) -> torch.Tensor:
    """Plain version of the pre-activation residual route:
    act(x*a + b + residual) in f32, cast once to x's dtype."""
    y = _normed(x, fused_norm_stats_plain(x, fine_channels),
                norm_count(x, fine_channels), fine_channels, eps)
    y = y + residual.reshape(y.shape).float()
    return _act(y, act, slope).to(x.dtype).reshape(x.shape)


def fused_instance_norm_act_plain(x: torch.Tensor, fine_channels: int,
                                  eps: float = 1e-5, act: str = "none",
                                  slope: float = 0.01,
                                  residual: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device, any layout)."""
    return fused_norm_apply_plain(
        x, fused_norm_stats_plain(x, fine_channels),
        norm_count(x, fine_channels), fine_channels, eps, act, slope,
        residual)


def fused_instance_norm_act_amax_plain(x: torch.Tensor, fine_channels: int,
                                       eps: float = 1e-5, act: str = "none",
                                       slope: float = 0.01,
                                       residual: torch.Tensor | None = None):
    """(out, amax): the plain version's output and, per sample, the float32
    max of |out| (a NaN propagates)."""
    out = fused_instance_norm_act_plain(x, fine_channels, eps, act, slope,
                                        residual)
    return out, out.reshape(out.shape[0], -1).float().abs().amax(dim=1)


class LaunchPlan(NamedTuple):
    """How one call runs: each of the n samples (grid y) is cut into
    ``blocks`` chunks of ``rows_per_block`` rows (grid x), a block's
    threads covering ``rows_per_iter`` rows at a time.  On the fused route
    each thread keeps its first ``staged`` rows in shared memory for the
    apply.  ``workspace_bytes``: partial sums, scales and shifts, tickets
    and generation words."""
    route: str
    blocks: int
    rows_per_block: int
    rows_per_iter: int
    staged: int
    workspace_bytes: int
    launches: int


@functools.lru_cache(maxsize=256)
def plan_launch(n: int, s: int, c: int, itemsize: int, vec: int,
                fused_blocks: int, split_blocks: int,
                stage_bytes: int) -> LaunchPlan:
    """The launch plan for x of shape (n, s, c) with ``itemsize`` bytes an
    element moved ``vec`` lanes at a time, on a card that holds
    ``fused_blocks`` blocks of the fused kernel, each with ``stage_bytes``
    of shared memory to keep rows in, or ``split_blocks`` of each split
    kernel, at once.  The fused route runs where all n samples fit in the
    staging memory plus FUSED_L2_BYTES and each gets a block of its own;
    its grid never exceeds ``fused_blocks`` (its blocks wait for each
    other).  Both grids fill the card in one wave."""
    if split_blocks < 1 or c % vec or c // vec > THREADS:
        raise ValueError(f"no plan for c={c}, vec={vec}, "
                         f"blocks={fused_blocks, split_blocks}")
    rows_per_iter = THREADS // (c // vec)
    on_chip = fused_blocks * stage_bytes + FUSED_L2_BYTES
    fused = n <= fused_blocks and n * s * c * itemsize <= on_chip
    blocks = fused_blocks // n if fused else max(1, split_blocks // n)
    # whole iterations of the block's threads, no empty block
    rows = math.ceil(math.ceil(s / blocks) / rows_per_iter) * rows_per_iter
    blocks = math.ceil(s / rows)
    staged = 0
    if fused:
        staged = min(rows // rows_per_iter,
                     stage_bytes // (THREADS * vec * itemsize))
    floats = 2 * n * c * (1 + blocks)
    return LaunchPlan("fused" if fused else "split", blocks, rows,
                      rows_per_iter, staged, 4 * (floats + 2 * n),
                      1 if fused else 2)


class _Workspace:
    """One (device, stream)'s scratch: ``floats`` holds the scales and
    shifts ([n][2][c]) then the partial sums ([n][blocks][2][c]);
    ``counters`` the tickets ([ncap], zero between calls) then the
    generation words ([ncap], the fused calls finished per sample)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.floats = torch.empty(0, dtype=torch.float32, device=device)
        self.counters = torch.zeros(0, dtype=torch.int32, device=device)

    def reserve(self, n: int, floats: int) -> None:
        grow = self.floats.numel() < floats, self.counters.numel() < 2 * n
        if any(grow):
            _build.refuse_in_capture("growing the fusednorm workspace")
        if grow[0]:
            self.floats = torch.empty(max(floats, 2 * self.floats.numel()),
                                      dtype=torch.float32, device=self.device)
        if grow[1]:
            # zeroed once here; each call's last blocks return the tickets
            # to zero, and the generations only count up
            self.counters = torch.zeros(2 * max(n, self.counters.numel()),
                                        dtype=torch.int32, device=self.device)


_workspaces: dict = {}           # (device index, stream) -> _Workspace
# (device index, dtype code, vec, fused, residual, amax) -> (blocks, stage
# bytes)
_coresident: dict = {}
# the int64 arguments of csrc/fusednorm.cu dctseg_fusednorm, in order
LAUNCH_ARGS = ("x", "residual", "out", "ab", "partial", "tickets",
               "generations", "n", "s", "c", "fine_channels", "blocks",
               "rows_per_block", "act", "dtype", "vec", "fused", "staged",
               "amax")


def _check(x, fine_channels, act, residual):
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; expected one of {list(ACTS)}")
    if x.dim() < 3 or x.shape[-1] % fine_channels:
        raise ValueError(
            f"x must be (N, *spatial, C) with fine_channels | C; got "
            f"{tuple(x.shape)}, fine_channels={fine_channels}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.is_cuda != x.is_cuda
                                 or residual.get_device() != x.get_device()):
        raise ValueError("residual must match x in shape, dtype and device")


def fused_instance_norm_act(x: torch.Tensor, fine_channels: int,
                            eps: float = 1e-5, act: str = "none",
                            slope: float = 0.01,
                            residual: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """InstanceNorm (affine-free, per fine channel) + activation (+ residual
    added after the activation).

    ``x``: (N, *spatial, C), C = O * fine_channels, lane o*fine_channels + c
    belonging to fine channel c.  ``act``: 'none' | 'relu' | 'lrelu'.
    On CUDA, ``x`` and ``residual`` must be contiguous (channels last).
    """
    _check(x, fine_channels, act, residual)
    return library.call(_OP, x, residual, fine_channels, eps, act, slope)


def fused_norm_residual_act(x: torch.Tensor, residual: torch.Tensor,
                            fine_channels: int, eps: float = 1e-5,
                            act: str = "none", slope: float = 0.01
                            ) -> torch.Tensor:
    """InstanceNorm (affine-free, per fine channel), + ``residual``, then
    the activation: act(x*a + b + residual) in f32, cast once.  ``x`` and
    ``residual``: (N, *spatial, C) of one shape and dtype; on CUDA
    contiguous (channels last)."""
    if residual is None:
        raise ValueError("the pre-activation residual route takes a "
                         "residual")
    _check(x, fine_channels, act, residual)
    return library.call(_PRE_OP, x, residual, fine_channels, eps, act, slope)


def fused_norm_stats(x: torch.Tensor, fine_channels: int) -> torch.Tensor:
    """(N, 2, F) f32: per (sample, fine channel) the sums of x and of x^2,
    the statistics launch of the external-statistics variant.  On CUDA,
    ``x`` must be contiguous (channels last)."""
    _check(x, fine_channels, "none", None)
    return library.call(_STATS_OP, x, fine_channels)


def fused_norm_stats_amax(x: torch.Tensor, fine_channels: int):
    """(sums, slots): :func:`fused_norm_stats` and the (N,) float32 absmax
    slots that :func:`fused_norm_apply_amax` fills, zeroed by this launch
    on CUDA."""
    _check(x, fine_channels, "none", None)
    return library.call(_STATS_AMAX_OP, x, fine_channels)


def _check_sums(x, sums, fine_channels):
    if sums.shape != (x.shape[0], 2, fine_channels) or \
            sums.dtype != torch.float32 or sums.device != x.device:
        raise ValueError(f"sums must be f32 ({x.shape[0]}, 2, "
                         f"{fine_channels}) on x's device; got "
                         f"{tuple(sums.shape)} {sums.dtype}")


def fused_norm_apply(x: torch.Tensor, sums: torch.Tensor, count: float,
                     fine_channels: int, eps: float = 1e-5,
                     act: str = "none", slope: float = 0.01,
                     residual: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`fused_instance_norm_act` with the statistics given: ``sums``
    (N, 2, F) f32 from :func:`fused_norm_stats`, summed over the ranks
    that hold the volume, and ``count``, the elements they sum."""
    _check(x, fine_channels, act, residual)
    _check_sums(x, sums, fine_channels)
    return library.call(_APPLY_OP, x, residual, sums.contiguous(),
                        float(count), fine_channels, eps, act, slope)


def fused_norm_apply_amax(x: torch.Tensor, sums: torch.Tensor,
                          slots: torch.Tensor, count: float,
                          fine_channels: int, eps: float = 1e-5,
                          act: str = "none", slope: float = 0.01,
                          residual: torch.Tensor | None = None):
    """(out, slots): :func:`fused_norm_apply` and, in ``slots`` (the
    (N,) float32 slots :func:`fused_norm_stats_amax` returned with
    the sums, filled in place), per sample the max of |out| over the
    elements written.  Inference only."""
    _check(x, fine_channels, act, residual)
    _check_sums(x, sums, fine_channels)
    if slots.shape != (x.shape[0],) or slots.dtype != torch.float32 or \
            slots.device != x.device or not slots.is_contiguous():
        raise ValueError(f"slots must be contiguous f32 ({x.shape[0]},) on "
                         f"x's device")
    out = library.call(_APPLY_AMAX_OP, x, residual, sums.contiguous(), slots,
                       float(count), fine_channels, eps, act, slope)
    return out, slots


def fused_instance_norm_act_amax(x: torch.Tensor, fine_channels: int,
                                 eps: float = 1e-5, act: str = "none",
                                 slope: float = 0.01,
                                 residual: torch.Tensor | None = None):
    """(out, amax): :func:`fused_instance_norm_act` and, per sample, the
    float32 max of |out| over the elements written (after the cast and the
    residual add), shape (N,).  Inference only."""
    _check(x, fine_channels, act, residual)
    return library.call(_AMAX_OP, x, residual, fine_channels, eps, act,
                        slope)


fused_instance_norm_act.launches = 0   # kernel launches on CUDA tensors
# the same launches by route (those of fused_norm_residual_act: ``*_pre``)
fused_instance_norm_act.routes = dict.fromkeys(ROUTES, 0)
fused_instance_norm_act_amax.launches = 0   # those of the absmax variant
fused_norm_stats.launches = 0   # the external-statistics variant's
fused_norm_apply.launches = 0
fused_norm_stats_amax.launches = 0   # its pair with absmax slots
fused_norm_apply_amax.launches = 0


def vector_width(x: torch.Tensor, *others) -> int:
    """Lanes per 16-byte load for the kernel: 16 bytes' worth where C and
    every pointer allow it, else 1."""
    vec = 16 // x.element_size()
    aligned = not any(t.data_ptr() % 16 for t in (x, *others))
    return vec if x.shape[-1] % vec == 0 and aligned else 1


def coresident(device: int, dtype: torch.dtype, vec: int, fused: bool,
               res: int, amax: bool = False) -> tuple:
    """(blocks, stage bytes): the blocks of the fused kernel (or of each
    split kernel) for ``dtype``, with the residual ``res`` (RES_NONE,
    RES_AFTER or RES_BEFORE; a bool reads as the first two), of the plain
    or the absmax variant (``amax``), that CUDA device ``device`` holds at
    once, and the shared memory a fused block may keep rows in.  An
    occupancy query, once per device, dtype, width, route, residual and
    variant."""
    key = (device, _build.dtype_code(dtype), vec, fused, int(res), amax)
    found = _coresident.get(key)
    if found is None:
        blocks, stage = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(_build.lib().dctseg_fusednorm_coresident(
            key[1], vec, fused, res, amax, ctypes.byref(blocks),
            ctypes.byref(stage)), "fusednorm occupancy")
        found = _coresident[key] = (blocks.value, stage.value)
    return found


@functools.lru_cache(maxsize=256)
def plan_for(shape: tuple, dtype: torch.dtype, vec: int, res: int,
             device: int, amax: bool = False) -> LaunchPlan:
    """The plan of a call on CUDA device ``device``: x of ``shape`` and
    ``dtype`` moved ``vec`` lanes at a time, with the residual ``res`` (as
    :func:`coresident` takes it), of the plain or the absmax variant
    (``amax``)."""
    n, c = shape[0], shape[-1]
    if c // vec > THREADS:
        raise ValueError(f"fusednorm kernel takes C <= {THREADS * vec} "
                         f"channels here; got C={c}")
    fused_blocks, stage_bytes = coresident(device, dtype, vec, True, res,
                                           amax)
    split_blocks = coresident(device, dtype, vec, False, res, amax)[0]
    return plan_launch(n, math.prod(shape) // (n * c), c,
                       _ITEMSIZE[dtype], vec, fused_blocks,
                       split_blocks, stage_bytes)


def launch_args(plan: LaunchPlan, x: int, residual: int, out: int,
                floats: int, counters: int, ncap: int, shape: tuple,
                fine_channels: int, act: str, dtype: torch.dtype, vec: int,
                amax: int) -> array.array:
    """The kernel's int64 arguments (:data:`LAUNCH_ARGS`) for a call of
    ``plan`` on x of ``shape``: the addresses of x, the residual, the
    output, the workspace's floats and counters (``ncap`` tickets, then as
    many generation words) and the absmax slots (0 for none), then the
    shape and the plan.  Nothing in them changes between two calls on the
    same tensors."""
    n, c = shape[0], shape[-1]
    return array.array("q", (
        x, residual, out, floats, floats + 4 * 2 * n * c, counters,
        counters + 4 * ncap, n, math.prod(shape) // (n * c), c,
        fine_channels, plan.blocks, plan.rows_per_block, ACTS[act],
        _build.dtype_code(dtype), vec, plan.route == "fused", plan.staged,
        amax))


def _launch(x, residual, fine_channels, eps, act, slope, amax=False,
            before=False):
    """The kernel's output; with ``amax`` (the absmax variant), (output,
    per-sample absmax); with ``before``, the residual added before the
    activation (:func:`fused_norm_residual_act`)."""
    if not x.is_contiguous() or (residual is not None
                                 and not residual.is_contiguous()):
        raise ValueError("the fusednorm kernel takes contiguous "
                         "(N, *spatial, C) tensors (channels last)")
    out = torch.empty_like(x)
    n, c = x.shape[0], x.shape[-1]
    slots = (torch.empty(n, dtype=torch.float32, device=x.device) if amax
             else None)
    if x.numel() == 0:
        return (out, slots.zero_()) if amax else out
    if x.numel() >= 2 ** 31 * n or n > 65535:
        raise ValueError("fusednorm kernel takes < 2^31 elements a sample "
                         "and at most 65535 samples")
    vec = vector_width(x, out, *(() if residual is None else (residual,)))
    device = x.get_device()
    res = (RES_NONE if residual is None
           else RES_BEFORE if before else RES_AFTER)
    plan = plan_for(tuple(x.shape), x.dtype, vec, res, device, amax)
    stream = _build.stream_of(x)
    cache = _build.workspaces(_workspaces)
    ws = cache.get((device, stream))
    if ws is None:
        _build.refuse_in_capture("making a fusednorm workspace")
        ws = cache[device, stream] = _Workspace(x.device)
    ws.reserve(n, 2 * n * c * (1 + plan.blocks))
    args = launch_args(
        plan, x.data_ptr(), 0 if residual is None else residual.data_ptr(),
        out.data_ptr(), ws.floats.data_ptr(), ws.counters.data_ptr(),
        ws.counters.numel() // 2, tuple(x.shape), fine_channels, act,
        x.dtype, vec, 0 if slots is None else slots.data_ptr())
    if before:
        args[LAUNCH_ARGS.index("act")] |= RESIDUAL_BEFORE
    _build.check(_build.lib().dctseg_fusednorm(
        args.buffer_info()[0], eps, slope, stream), "fusednorm")
    if amax:
        fused_instance_norm_act_amax.launches += plan.launches
    else:
        fused_instance_norm_act.launches += plan.launches
        fused_instance_norm_act.routes[
            plan.route + ("_pre" if before else "")] += plan.launches
    return (out, slots) if amax else out


def ext_plan_for(shape: tuple, dtype: torch.dtype, vec: int, res: bool,
                 device: int, amax: bool = False) -> LaunchPlan:
    """The external-statistics variant's plan on CUDA device ``device``:
    the split route's of the plain or the absmax variant (its two launches
    are called apart, with the all-reduce between them)."""
    n, c = shape[0], shape[-1]
    if c // vec > THREADS:
        raise ValueError(f"fusednorm kernel takes C <= {THREADS * vec} "
                         f"channels here; got C={c}")
    split_blocks = coresident(device, dtype, vec, False, res, amax)[0]
    return plan_launch(n, math.prod(shape) // (n * c), c, _ITEMSIZE[dtype],
                       vec, 0, split_blocks, 0)


def _launch_ext(x, residual, fine_channels, eps, act, slope, sums, count,
                phase, slots=None):
    """One launch of the external-statistics variant: phase 0 writes
    ``sums``, phase 1 the output (returned) from them; with ``slots``
    (the absmax slots), phase 0 zeroes them and phase 1 fills them."""
    if not x.is_contiguous() or (residual is not None
                                 and not residual.is_contiguous()):
        raise ValueError("the fusednorm kernel takes contiguous "
                         "(N, *spatial, C) tensors (channels last)")
    n, c = x.shape[0], x.shape[-1]
    out = torch.empty_like(x) if phase else None
    if x.numel() == 0:
        if slots is not None:
            slots.zero_()
        return out if phase else sums.zero_()
    if x.numel() >= 2 ** 31 * n or n > 65535:
        raise ValueError("fusednorm kernel takes < 2^31 elements a sample "
                         "and at most 65535 samples")
    vec = vector_width(x, *(() if out is None else (out,)),
                       *(() if residual is None else (residual,)))
    device = x.get_device()
    plan = ext_plan_for(tuple(x.shape), x.dtype, vec, residual is not None,
                        device, slots is not None)
    stream = _build.stream_of(x)
    cache = _build.workspaces(_workspaces)
    ws = cache.get((device, stream))
    if ws is None:
        _build.refuse_in_capture("making a fusednorm workspace")
        ws = cache[device, stream] = _Workspace(x.device)
    ws.reserve(n, 2 * n * c * (1 + plan.blocks))
    args = launch_args(
        plan, x.data_ptr(), 0 if residual is None else residual.data_ptr(),
        0 if out is None else out.data_ptr(), ws.floats.data_ptr(),
        ws.counters.data_ptr(), ws.counters.numel() // 2, tuple(x.shape),
        fine_channels, act, x.dtype, vec,
        0 if slots is None else slots.data_ptr())
    args.append(sums.data_ptr())
    _build.check(_build.lib().dctseg_fusednorm_ext(
        args.buffer_info()[0], eps, slope, count, phase, stream),
        "fusednorm external statistics")
    ((fused_norm_stats, fused_norm_apply) if slots is None
     else (fused_norm_stats_amax, fused_norm_apply_amax))[phase].launches += 1
    return out if phase else sums


def _launch_stats(x, fine_channels, slots=None):
    sums = torch.empty((x.shape[0], 2, fine_channels), dtype=torch.float32,
                       device=x.device)
    return _launch_ext(x, None, fine_channels, 0.0, "none", 0.0, sums, 1.0,
                       0, slots)


def _launch_stats_amax(x, fine_channels):
    slots = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    return _launch_stats(x, fine_channels, slots), slots


def _launch_apply(x, residual, sums, count, fine_channels, eps, act, slope):
    return _launch_ext(x, residual, fine_channels, eps, act, slope, sums,
                       count, 1)


def _launch_apply_amax(x, residual, sums, slots, count, fine_channels, eps,
                       act, slope):
    return _launch_ext(x, residual, fine_channels, eps, act, slope, sums,
                       count, 1, slots)


def _cpu_stats(x, fine_channels):
    return fused_norm_stats_plain(x, fine_channels)


def _cpu_stats_amax(x, fine_channels):
    return (fused_norm_stats_plain(x, fine_channels),
            x.new_zeros(x.shape[0], dtype=torch.float32))


def _cpu_apply_amax(x, residual, sums, slots, count, fine_channels, eps, act,
                    slope):
    out, amax = fused_norm_apply_amax_plain(x, sums, count, fine_channels,
                                            eps, act, slope, residual)
    slots.copy_(amax)
    return out.contiguous()


def _cpu_apply(x, residual, sums, count, fine_channels, eps, act, slope):
    return fused_norm_apply_plain(x, sums, count, fine_channels, eps, act,
                                  slope, residual).contiguous()


def _fake_stats(x, fine_channels):
    return x.new_empty((x.shape[0], 2, fine_channels), dtype=torch.float32)


def _fake_apply(x, residual, sums, count, fine_channels, eps, act, slope):
    return x.new_empty(x.shape)


def _fake_stats_amax(x, fine_channels):
    return (_fake_stats(x, fine_channels),
            x.new_empty((x.shape[0],), dtype=torch.float32))


def _fake_apply_amax(x, residual, sums, slots, count, fine_channels, eps,
                     act, slope):
    return x.new_empty(x.shape)


def _launch_pre(x, residual, fine_channels, eps, act, slope):
    return _launch(x, residual, fine_channels, eps, act, slope, before=True)


def _cpu_pre(x, residual, fine_channels, eps, act, slope):
    return fused_norm_residual_act_plain(x, residual, fine_channels, eps,
                                         act, slope).contiguous()


def _setup_context_pre(ctx, inputs, output):
    x, residual, *args = inputs
    ctx.save_for_backward(x, residual)
    ctx.args = args


def _backward_pre(ctx, grad):
    """(dx, dresidual): the plain version's autograd gradient at the saved
    inputs."""
    x, residual = ctx.saved_tensors
    fine_channels, eps, act, slope = ctx.args
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(),
                  residual.detach().requires_grad_()]
        y = fused_norm_residual_act_plain(*leaves, fine_channels, eps, act,
                                          slope)
        dx, dr = torch.autograd.grad(y, leaves, grad)
    return dx, dr, None, None, None, None


def _cpu(x, residual, fine_channels, eps, act, slope):
    return fused_instance_norm_act_plain(x, fine_channels, eps, act, slope,
                                         residual).contiguous()


def _fake(x, residual, fine_channels, eps, act, slope):
    return x.new_empty(x.shape)


def _launch_amax(x, residual, fine_channels, eps, act, slope):
    return _launch(x, residual, fine_channels, eps, act, slope, amax=True)


def _cpu_amax(x, residual, fine_channels, eps, act, slope):
    out, amax = fused_instance_norm_act_amax_plain(x, fine_channels, eps,
                                                   act, slope, residual)
    return out.contiguous(), amax


def _fake_amax(x, residual, fine_channels, eps, act, slope):
    return x.new_empty(x.shape), x.new_empty((x.shape[0],),
                                             dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    x, residual, *args = inputs
    ctx.save_for_backward(x)
    ctx.args, ctx.residual = args, residual is not None


def _backward(ctx, grad):
    """(dx, dresidual): the plain version's autograd gradient at the saved
    input; the residual, added last, passes ``grad`` through."""
    x, = ctx.saved_tensors
    fine_channels, eps, act, slope = ctx.args
    with torch.enable_grad():
        leaf = x.detach().requires_grad_()
        y = fused_instance_norm_act_plain(leaf, fine_channels, eps, act,
                                          slope)
        dx, = torch.autograd.grad(y, leaf, grad)
    return dx, grad if ctx.residual else None, None, None, None, None


_OP = library.define(
    "fused_instance_norm_act",
    "(Tensor x, Tensor? residual, int fine_channels, float eps, str act, "
    "float slope) -> Tensor",
    cuda=_launch, cpu=_cpu, fake=_fake, backward=_backward,
    setup_context=_setup_context)
_PRE_OP = library.define(
    "fused_norm_residual_act",
    "(Tensor x, Tensor residual, int fine_channels, float eps, str act, "
    "float slope) -> Tensor",
    cuda=_launch_pre, cpu=_cpu_pre, fake=_fake, backward=_backward_pre,
    setup_context=_setup_context_pre)
_AMAX_OP = library.define(
    "fused_instance_norm_act_amax",
    "(Tensor x, Tensor? residual, int fine_channels, float eps, str act, "
    "float slope) -> (Tensor, Tensor)",
    cuda=_launch_amax, cpu=_cpu_amax, fake=_fake_amax)
_STATS_OP = library.define(
    "fused_norm_stats", "(Tensor x, int fine_channels) -> Tensor",
    cuda=_launch_stats, cpu=_cpu_stats, fake=_fake_stats)
_APPLY_OP = library.define(
    "fused_norm_apply",
    "(Tensor x, Tensor? residual, Tensor sums, float count, "
    "int fine_channels, float eps, str act, float slope) -> Tensor",
    cuda=_launch_apply, cpu=_cpu_apply, fake=_fake_apply)
_STATS_AMAX_OP = library.define(
    "fused_norm_stats_amax",
    "(Tensor x, int fine_channels) -> (Tensor, Tensor)",
    cuda=_launch_stats_amax, cpu=_cpu_stats_amax, fake=_fake_stats_amax)
# the slots are the statistics launch's, filled in place: a mutable input
_APPLY_AMAX_OP = library.define(
    "fused_norm_apply_amax",
    "(Tensor x, Tensor? residual, Tensor sums, Tensor(a!) slots, "
    "float count, int fine_channels, float eps, str act, float slope) "
    "-> Tensor",
    cuda=_launch_apply_amax, cpu=_cpu_apply_amax, fake=_fake_apply_amax)
