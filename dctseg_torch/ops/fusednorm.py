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

The kernel's seven operators are the rows of :data:`VARIANTS`, each with
its schema, its plain version (the CPU implementation) and its counter;
every CUDA call goes through the one launch function :func:`_launch`.
Besides :func:`fused_instance_norm_act`:

  * :func:`fused_norm_residual_act`, the pre-activation residual route
    (MONAI's ``UnetResBlock`` ending ``lrelu(IN(conv2(h)) + r)``):
    act(x*a + b + r) in f32, cast once, on instantiations of its own and so
    with its own occupancy and plans, on either route;
  * :func:`fused_instance_norm_act_amax`, which also returns per sample
    max |out| over the elements written, the statistic the int8 quantizer
    needs (``ops/quant.py`` ``quantize_from_amax``), so that it reads the
    norm's output once: one ``atomicMax`` a block, and plans from its own
    occupancy, so that the plain variant's do not depend on it;
  * for a volume whose D axis is sharded over a space group
    (``parallel/spatial.py``), the split route's two launches called
    apart: :func:`fused_norm_stats` writes each sample's raw f32 sums of x
    and x^2 per fine channel, (N, 2, F), which the caller all-reduces, and
    :func:`fused_norm_apply` applies the reduced sums over the whole
    volume's count (with the local sums and count, the split route's
    output bit for bit); where the output feeds an int8 conv on the slab,
    :func:`fused_norm_stats_amax` also zeroes absmax slots and
    :func:`fused_norm_apply_amax` fills them, bit for bit
    :func:`fused_instance_norm_act_amax`'s on the same output.

The absmax and external-statistics operators are inference only (their
backward raises).  Each row counts its launches in its wrapper's
``.launches``, but the pre route counts in
:func:`fused_instance_norm_act`'s, and every launch of that counter also
counts by route in its ``routes``: ``fused`` and ``split``, and
``fused_pre`` and ``split_pre`` for the pre route.
"""

from __future__ import annotations

import array
import ctypes
import functools
import math
from typing import Callable, NamedTuple

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


def vector_width(x: torch.Tensor, *others) -> int:
    """Lanes per 16-byte load for the kernel: 16 bytes' worth where C and
    every pointer (of x and of each of ``others`` that is not None) allow
    it, else 1."""
    vec = 16 // x.element_size()
    aligned = not any(t.data_ptr() % 16 for t in (x, *others)
                      if t is not None)
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


_ACT_ARG = LAUNCH_ARGS.index("act")


def _launch(v, x, residual, fine_channels, eps, act, slope, sums=None,
            count=1.0, slots=None):
    """One call of the kernel as row ``v`` runs it: the norm of x, by
    :func:`plan_for`'s plan; or with external statistics one launch of
    :func:`ext_plan_for`'s, phase 0 writing the (N, 2, F) sums and phase 1
    the norm from ``sums`` over ``count`` elements.  Absmax slots
    (``v.amax``) are made here and returned beside the result, or given to
    phase 1 to fill."""
    if not x.is_contiguous() or (residual is not None
                                 and not residual.is_contiguous()):
        raise ValueError("the fusednorm kernel takes contiguous "
                         "(N, *spatial, C) tensors (channels last)")
    phase, shape = v.phase, tuple(x.shape)
    n, c = shape[0], shape[-1]
    out = None if phase == 0 else torch.empty_like(x)
    if phase == 0:
        sums = torch.empty((n, 2, fine_channels), dtype=torch.float32,
                           device=x.device)
    result = sums if phase == 0 else out
    if v.amax and phase != 1:
        slots = torch.empty(n, dtype=torch.float32, device=x.device)
        result = result, slots
    if x.numel() == 0:
        if slots is not None:
            slots.zero_()
        if phase == 0:
            sums.zero_()
        return result
    if x.numel() >= 2 ** 31 * n or n > 65535:
        raise ValueError("fusednorm kernel takes < 2^31 elements a sample "
                         "and at most 65535 samples")
    vec = vector_width(x, out, residual)
    device = x.get_device()
    res = (RES_NONE if residual is None
           else RES_BEFORE if v.before else RES_AFTER)
    plan = (plan_for if phase is None else ext_plan_for)(
        shape, x.dtype, vec, res, device, v.amax)
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
        ws.counters.data_ptr(), ws.counters.numel() // 2, shape,
        fine_channels, act, x.dtype, vec,
        0 if slots is None else slots.data_ptr())
    if v.before:
        args[_ACT_ARG] |= RESIDUAL_BEFORE
    if phase is None:
        _build.check(_build.lib().dctseg_fusednorm(
            args.buffer_info()[0], eps, slope, stream), "fusednorm")
        v.counter.launches += plan.launches
        if v.routes is not None:
            v.counter.routes[plan.route + v.routes] += plan.launches
    else:
        args.append(sums.data_ptr())
        _build.check(_build.lib().dctseg_fusednorm_ext(
            args.buffer_info()[0], eps, slope, count, phase, stream),
            "fusednorm external statistics")
        v.counter.launches += 1
    return result


def _cpu(v, x, residual, fine_channels, eps, act, slope, sums=None,
         count=1.0, slots=None):
    """Row ``v``'s plain version, on :func:`_launch`'s arguments and with
    its results (phase 0's slots zeroed)."""
    if v.phase == 0:
        sums = v.plain(x, fine_channels)
        return ((sums, x.new_zeros(x.shape[0], dtype=torch.float32))
                if v.amax else sums)
    got = v.plain(x, *((sums, count) if v.phase else ()),
                  fine_channels=fine_channels, eps=eps, act=act, slope=slope,
                  residual=residual)
    if not v.amax:
        return got.contiguous()
    out, amax = got
    if v.phase:
        slots.copy_(amax)
        return out.contiguous()
    return out.contiguous(), amax


def _fake(v, x, residual, fine_channels, eps, act, slope, sums=None,
          count=1.0, slots=None):
    """Row ``v``'s outputs: their shapes, dtypes and strides only."""
    n = x.shape[0]
    result = (x.new_empty((n, 2, fine_channels), dtype=torch.float32)
              if v.phase == 0 else x.new_empty(x.shape))
    if v.amax and v.phase != 1:
        return result, x.new_empty((n,), dtype=torch.float32)
    return result


def _setup_context(ctx, inputs, output):
    x, residual, *args = inputs
    ctx.save_for_backward(x, residual)
    ctx.args = args


def _backward(v, ctx, grad):
    """(dx, dresidual): the autograd gradient of row ``v``'s plain version
    at the saved inputs."""
    x, residual = ctx.saved_tensors
    fine_channels, eps, act, slope = ctx.args
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, residual)
                  if t is not None]
        y = v.plain(leaves[0], fine_channels=fine_channels, eps=eps, act=act,
                    slope=slope, residual=leaves[1] if len(leaves) > 1
                    else None)
        grads = torch.autograd.grad(y, leaves, grad)
    return (*grads, *[None] * (6 - len(grads)))


class Variant(NamedTuple):
    """One K1 operator, a row of :data:`VARIANTS`.  Its outputs follow from
    ``phase`` and ``amax``: the norm (phase None or 1) or the sums (phase
    0), and beside it the slots the row makes (``amax``, phase not 1)."""
    name: str
    schema: str
    plain: Callable
    # the wrapper whose .launches the row's launches add to, and with a
    # route suffix (``routes``) its .routes by the plan's route
    counter: Callable
    routes: str | None = None
    before: bool = False          # the residual added before the activation
    amax: bool = False            # absmax slots
    phase: int | None = None      # external statistics: 0 sums, 1 apply
    # (implementation, row, the operator's arguments in its schema's order)
    # -> the implementation called with _launch's; None: the schema's are
    # _launch's own
    reach: Callable | None = None
    grad: bool = False            # a backward, from the plain version


def _reach_stats(impl, v, x, fine_channels):
    return impl(v, x, None, fine_channels, 0.0, "none", 0.0)


def _reach_apply(impl, v, x, residual, sums, count, fine_channels, eps, act,
                 slope):
    return impl(v, x, residual, fine_channels, eps, act, slope, sums, count)


def _reach_apply_amax(impl, v, x, residual, sums, slots, count,
                      fine_channels, eps, act, slope):
    return impl(v, x, residual, fine_channels, eps, act, slope, sums, count,
                slots)


VARIANTS = {v.name: v for v in (
    Variant("fused_instance_norm_act",
            "(Tensor x, Tensor? residual, int fine_channels, float eps, "
            "str act, float slope) -> Tensor",
            fused_instance_norm_act_plain, fused_instance_norm_act,
            routes="", grad=True),
    # counted on fused_instance_norm_act: k1_roofline.swin reads that
    # counter's sum against the profile's count of K1's kernel launches
    Variant("fused_norm_residual_act",
            "(Tensor x, Tensor residual, int fine_channels, float eps, "
            "str act, float slope) -> Tensor",
            fused_norm_residual_act_plain, fused_instance_norm_act,
            routes="_pre", before=True, grad=True),
    Variant("fused_instance_norm_act_amax",
            "(Tensor x, Tensor? residual, int fine_channels, float eps, "
            "str act, float slope) -> (Tensor, Tensor)",
            fused_instance_norm_act_amax_plain, fused_instance_norm_act_amax,
            amax=True),
    Variant("fused_norm_stats", "(Tensor x, int fine_channels) -> Tensor",
            fused_norm_stats_plain, fused_norm_stats, phase=0,
            reach=_reach_stats),
    Variant("fused_norm_apply",
            "(Tensor x, Tensor? residual, Tensor sums, float count, "
            "int fine_channels, float eps, str act, float slope) -> Tensor",
            fused_norm_apply_plain, fused_norm_apply, phase=1,
            reach=_reach_apply),
    Variant("fused_norm_stats_amax",
            "(Tensor x, int fine_channels) -> (Tensor, Tensor)",
            fused_norm_stats_plain, fused_norm_stats_amax, amax=True,
            phase=0, reach=_reach_stats),
    # the slots are the statistics launch's, filled in place: a mutable
    # input
    Variant("fused_norm_apply_amax",
            "(Tensor x, Tensor? residual, Tensor sums, Tensor(a!) slots, "
            "float count, int fine_channels, float eps, str act, "
            "float slope) -> Tensor",
            fused_norm_apply_amax_plain, fused_norm_apply_amax, amax=True,
            phase=1, reach=_reach_apply_amax))}
for _v in VARIANTS.values():
    _v.counter.launches = 0      # kernel launches on CUDA tensors
# the same launches by route (those of fused_norm_residual_act: ``*_pre``)
fused_instance_norm_act.routes = dict.fromkeys(ROUTES, 0)


def _define(v: Variant) -> torch._ops.OpOverload:
    cuda, cpu, fake = (functools.partial(f, v) if v.reach is None
                       else functools.partial(v.reach, f, v)
                       for f in (_launch, _cpu, _fake))
    return library.define(
        v.name, v.schema, cuda=cuda, cpu=cpu, fake=fake,
        backward=functools.partial(_backward, v) if v.grad else None,
        setup_context=_setup_context if v.grad else None)


# the operators the wrappers call, in the table's order
(_OP, _PRE_OP, _AMAX_OP, _STATS_OP, _APPLY_OP, _STATS_AMAX_OP,
 _APPLY_AMAX_OP) = map(_define, VARIANTS.values())
