"""The volume's D axis sharded over a space group: what GSPMD inserts on
its own in the JAX package (``dctseg/parallel/mesh.py``'s ``space``
axis), done by hand.

Under :func:`sharded` the model runs on this rank's slab of D (the
``space`` ranks hold consecutive, equal slabs):

  * a conv exchanges the halo its kernel, stride and padding need
    (:func:`conv3d`, :func:`halo_exchange`): a 3^3 stride-1 conv one plane
    each side, a 3^3 stride-2 conv one plane below and none above, 1x1 and
    k=2 s=2 transpose convs none;
  * an InstanceNorm all-reduces its f32 sums of x and x^2 per (sample,
    channel) over the group before it applies them (:func:`reduce_stats`);
  * where the model needs the whole grid it gathers the slabs
    (:func:`gather`), and splits the result again (:func:`split`);
  * an int8 conv quantizes its slab with the tensor's scale and exchanges
    the halo of the int8 tensor (``ops/quant.py`` ``conv3d_int8_prepared``):
    the quantize is elementwise, so the halo planes hold the bits the
    neighbour computed, at half of bf16's bytes.

The int8 scale.  The JAX package takes one activation scale per conv
call, over the whole logical tensor: every batch row on ``data`` and every
D plane on ``space``.  Under :func:`scaled` the absmax slots of a conv's
input are MAX-reduced over the given group (:func:`reduce_amax`), which
the Predictor sets to every rank of its mesh.  The scale group is apart
from the space context: the couplers run on the whole grid
(``sharded(None)``) while their int8 convs still see only this rank's
batch rows.

Gradient scale.  Everything downstream of a gather runs replicated on
every space rank, and the loss is the same number on each.  The gather's
backward hands each rank S times the cotangent of its own slab, and the
split's backward gathers the slabs' cotangents and divides by S, so a
parameter used on slabs collects S times its slab's share on each rank,
and one used on the whole grid its whole gradient on each of the S ranks.
An average over all ranks (``DistributedDataParallel``'s, which divides by
data x space) then gives every parameter its gradient.

Transport.  Both backends take the CUDA tensors of the two operations
this module uses, all-gather and all-reduce, as they are: NCCL, and gloo
too (found on an H100 with PyTorch 2.11, where gloo also takes them for
broadcast, reduce-scatter and barrier, while send and recv abort the
process in gloo's TCP transport, which is why the halo exchange is an
all-gather; it takes the int8 halos' all-gather and the int32 MAX
all-reduce of the int8 scale's slots too).  So no tensor is staged through
host memory here; ``chip_smoke.py`` checks both operations on CUDA tensors
over gloo, and runs the int8 forward over them.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

@dataclasses.dataclass(frozen=True)
class Shard:
    """A space group and this rank's place in it."""
    group: object
    size: int
    index: int


def space_shard(mesh) -> Optional[Shard]:
    """The Shard of a ``parallel.mesh.Mesh``, None without a space axis."""
    if mesh is None or mesh.space == 1:
        return None
    return Shard(mesh.space_group, mesh.space, mesh.space_index)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("dctseg_space",
                                                         default=None)


@contextlib.contextmanager
def sharded(shard: Optional[Shard]):
    """Run the enclosed code on D slabs of ``shard`` (None: unsharded)."""
    token = _ACTIVE.set(shard)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[Shard]:
    return _ACTIVE.get()


_SCALE: contextvars.ContextVar = contextvars.ContextVar("dctseg_scale",
                                                        default=None)


@contextlib.contextmanager
def scaled(group):
    """Take every int8 activation scale of the enclosed code over
    ``group`` (a process group over which the logical tensor is spread;
    None: this rank's tensor is the whole tensor)."""
    token = _SCALE.set(group)
    try:
        yield
    finally:
        _SCALE.reset(token)


def scale_group():
    return _SCALE.get()


# ---- collectives ----

def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape on all), in rank order."""
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, t, group=group)
    return outs


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """The reduction over the group of every rank's ``t``, in a new
    tensor."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` (no autograd)."""
    return torch.cat(all_gather(t, group), dim=dim)


def reduce_amax(slots: torch.Tensor, group) -> torch.Tensor:
    """The elementwise MAX over ``group`` of every rank's float32 absmax
    slots (as many on every rank), reduced on their int32 view: the slots
    are non-negative, so the ints order like the floats, and a NaN's bits
    sort above inf's, so a NaN on one rank reaches every rank (a float MAX
    of the backends need not keep it)."""
    if group is None:
        return slots
    return all_reduce(slots.view(torch.int32), group,
                      dist.ReduceOp.MAX).view(torch.float32)


# ---- autograd functions ----

class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard, ctx.d = shard, x.shape[1]
        return torch.cat(all_gather(x, shard.group), dim=1)

    @staticmethod
    def backward(ctx, g):
        s = ctx.shard
        return g.narrow(1, s.index * ctx.d, ctx.d) * s.size, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        d = x.shape[1] // shard.size
        return x.narrow(1, shard.index * d, d).contiguous()

    @staticmethod
    def backward(ctx, g):
        s = ctx.shard
        return torch.cat(all_gather(g, s.group), dim=1) / s.size, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``t``, with autograd: the
    backward sums the cotangents over the group the same way (every rank's
    result feeds every rank's loss)."""
    return t if group is None else _ReduceSum.apply(t, group)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, lo, hi):
        d, i = x.shape[1], shard.index
        ctx.shard, ctx.lo, ctx.hi, ctx.d = shard, lo, hi, d
        # what the neighbours need: the first hi planes go to the rank
        # below (its upper halo), the last lo planes to the rank above
        got = all_gather(torch.cat([x.narrow(1, 0, hi),
                                    x.narrow(1, d - lo, lo)], dim=1),
                         shard.group)
        below = (got[i - 1].narrow(1, hi, lo) if i > 0
                 else x.new_zeros((x.shape[0], lo, *x.shape[2:])))
        above = (got[i + 1].narrow(1, 0, hi) if i < shard.size - 1
                 else x.new_zeros((x.shape[0], hi, *x.shape[2:])))
        return torch.cat([below, x, above], dim=1)

    @staticmethod
    def backward(ctx, g):
        s, lo, hi, d = ctx.shard, ctx.lo, ctx.hi, ctx.d
        # the halos' cotangents go back to the planes they came from
        got = all_gather(torch.cat([g.narrow(1, 0, lo),
                                    g.narrow(1, lo + d, hi)], dim=1),
                         s.group)
        dx = g.narrow(1, lo, d).clone()
        if s.index < s.size - 1 and lo:
            dx[:, d - lo:] += got[s.index + 1].narrow(1, 0, lo)
        if s.index > 0 and hi:
            dx[:, :hi] += got[s.index - 1].narrow(1, lo, hi)
        return dx, None, None, None


def gather(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The whole D axis from every rank's slab (NDHWC, D = dim 1)."""
    return x if shard is None else _Gather.apply(x, shard)


def split(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """This rank's slab of a whole (replicated) NDHWC tensor."""
    if shard is None:
        return x
    if x.shape[1] % shard.size:
        raise ValueError(f"D={x.shape[1]} does not split over "
                         f"{shard.size} ranks")
    return _Split.apply(x, shard)


def reduce_stats(t: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The sum over the space group of each rank's ``t`` (the f32 sums of
    an InstanceNorm); its backward sums the cotangents the same way."""
    return t if shard is None else _ReduceSum.apply(t, shard.group)


def halo_exchange(x: torch.Tensor, shard: Optional[Shard], lo: int,
                  hi: int) -> torch.Tensor:
    """x's slab with ``lo`` planes of the rank below in front and ``hi``
    planes of the rank above behind (zeros past the volume's ends, the
    conv's own padding)."""
    if shard is None or (lo == 0 and hi == 0):
        return x
    if x.shape[1] < max(lo, hi):
        raise ValueError(f"a slab of {x.shape[1]} planes cannot give a "
                         f"halo of ({lo}, {hi})")
    return _Halo.apply(x, shard, lo, hi)


def halo_of(kernel: int, stride: int, pad_lo: int) -> Tuple[int, int]:
    """(planes below, planes above) a slab needs for a conv whose output j
    reads input planes stride * j - pad_lo .. + kernel - 1, on slabs that
    start at a multiple of the stride."""
    hi = kernel - pad_lo - stride
    if hi < 0 or pad_lo < 0:
        raise ValueError(f"no halo for kernel {kernel}, stride {stride}, "
                         f"padding {pad_lo}")
    return pad_lo, hi


def conv_halo(x: torch.Tensor, shard: Shard, kernel: int, stride: int,
              pad_lo: int) -> torch.Tensor:
    """x's slab with the halo that a conv of ``kernel`` and ``stride``
    along D, padded by ``pad_lo`` below, needs (:func:`halo_of`)."""
    if x.shape[1] % stride:
        raise ValueError(f"a slab of {x.shape[1]} planes is not a "
                         f"multiple of the conv's stride {stride}")
    return halo_exchange(x, shard, *halo_of(kernel, stride, pad_lo))


def conv3d(x: torch.Tensor, w: torch.Tensor, bias, stride: int,
           padding: Tuple[int, int]) -> torch.Tensor:
    """conv3d of an NDHWC tensor with per-axis padding (lo, hi) (the
    weight in (O, I, k, k, k)).  Under :func:`sharded` x is a slab of D:
    the halo is exchanged and D is padded by it alone, H and W as given."""
    lo, hi = padding
    shard = active()
    if shard is not None:
        x = conv_halo(x, shard, w.shape[2], stride, lo)
        xc = x.permute(0, 4, 1, 2, 3)
        if lo == hi:
            y = F.conv3d(xc, w, bias, stride, (0, lo, lo))
        else:
            xc = F.pad(xc, (lo, hi, lo, hi, 0, 0)).contiguous(
                memory_format=torch.channels_last_3d)
            y = F.conv3d(xc, w, bias, stride, 0)
        return y.permute(0, 2, 3, 4, 1)
    xc = x.permute(0, 4, 1, 2, 3)
    if lo == hi:
        y = F.conv3d(xc, w, bias, stride, lo)
    else:
        xc = F.pad(xc, (lo, hi) * 3).contiguous(
            memory_format=torch.channels_last_3d)
        y = F.conv3d(xc, w, bias, stride, 0)
    return y.permute(0, 2, 3, 4, 1)
