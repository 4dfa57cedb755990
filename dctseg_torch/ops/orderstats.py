"""The pooled-distance order-statistic search of HD95: the port of the TPU
kernel ``dctseg/ops/pallas/orderstats.py``.

One hand-written kernel (``dctseg_torch/csrc/orderstats.cu``) serves both
functions here.  ``count_leq`` is the TPU kernel's count (``_count_leq``
there): per class, the count of values at or below each cut point; on a
CUDA tensor it is one launch of the kernel in count mode.
``masked_order_stats`` is the 8-ary search around it; on a CUDA tensor each
of its passes is one launch of the kernel in search mode, which forms the
cuts, counts and narrows the search on the card, as the TPU program's
``lax.fori_loop`` does: no torch op and no host sync between the passes.
On a CPU tensor both run the plain PyTorch versions below (the search as
torch ops over ``count_leq``).  Counts are integers, so all routes are
equal.
"""

from __future__ import annotations

import array
import math

import torch

from dctseg_torch.ops import _build

MAX_CUTS = 32        # csrc/orderstats.cu kMaxCuts: cut points per class
# Search fanout (csrc/orderstats.cu kFanout).  A power of two: the
# cut-point division s * L / FANOUT is exact in f32 only then.  At 8, one
# pass takes up to 4 ranks per class.
FANOUT = 8


def count_leq_plain(values: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    """values (C, M) f32, cuts (C, T) f32 -> (C, T) int32 counts of
    values[c] <= cuts[c, t]."""
    return (values[:, None, :] <= cuts[:, :, None]).sum(-1, dtype=torch.int32)


class _Workspace:
    """One (device, stream)'s scratch for the kernel, one int32 tensor:
    the counts ([ccap][MAX_CUTS]) and tickets ([ccap]), zero between
    launches (the kernel's last blocks leave them so), then the search's
    (lo, hi) per rank ([ccap][4][2] f32)."""

    def __init__(self):
        self.buf = None
        self.ccap = 0

    def pointers(self, values: torch.Tensor) -> tuple:
        c = values.shape[0]
        if c > self.ccap:
            # zeroed once here, never per call
            self.ccap = max(c, 2 * self.ccap)
            self.buf = torch.zeros(self.ccap * (MAX_CUTS + 1 + 8),
                                   dtype=torch.int32, device=values.device)
        base = self.buf.data_ptr()
        return (base, base + 4 * MAX_CUTS * self.ccap,
                base + 4 * (MAX_CUTS + 1) * self.ccap)


_workspaces: dict = {}           # (device index, stream) -> _Workspace


def _launch(values: torch.Tensor, cuts: torch.Tensor | None,
            ranks: torch.Tensor | None, out: torch.Tensor,
            passes: int, vmax: float) -> None:
    """``passes`` launches of the kernel: count mode with ``cuts``, search
    mode with ``ranks``."""
    c, m = values.shape
    stream = _build.stream_of(values)
    key = (values.get_device(), stream)
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = _Workspace()
    counts, tickets, bounds = ws.pointers(values)
    search = ranks is not None
    k = ranks.shape[1] if search else 0
    args = array.array("q", (
        values.data_ptr(), 0 if search else cuts.data_ptr(),
        ranks.data_ptr() if search else 0, counts, tickets, bounds,
        out.data_ptr(), c, m, (FANOUT - 1) * k if search else cuts.shape[1],
        k, 0, 0, int(search)))
    buf = args.buffer_info()[0]
    lib = _build.lib()
    what = "orderstats search" if search else "orderstats count"
    counter = masked_order_stats if search else count_leq
    for p in range(passes):
        args[11], args[12] = p, int(p == passes - 1)
        _build.check(lib.dctseg_orderstats(buf, vmax, stream), what)
        counter.launches += 1


def count_leq(values: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    """values (C, M) f32, cuts (C, T) f32 -> (C, T) int32, T <= 32."""
    if values.dim() != 2 or cuts.dim() != 2 \
            or cuts.shape[0] != values.shape[0]:
        raise ValueError(f"expected values (C, M) and cuts (C, T); got "
                         f"{tuple(values.shape)}, {tuple(cuts.shape)}")
    if values.dtype != torch.float32 or cuts.dtype != torch.float32:
        raise ValueError("values and cuts must be float32")
    if values.device != cuts.device:
        raise ValueError("values and cuts must share one device")
    if not 1 <= cuts.shape[1] <= MAX_CUTS:
        raise ValueError(f"{cuts.shape[1]} cut points per class; the kernel "
                         f"takes 1 to {MAX_CUTS}")
    if values.shape[1] >= 2 ** 31:
        raise ValueError("more values per class than an int32 count holds")
    if values.device.type == "cpu":
        return count_leq_plain(values, cuts)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    if not (values.is_contiguous() and cuts.is_contiguous()):
        raise ValueError("the count kernel takes contiguous tensors")
    out = torch.empty(cuts.shape, dtype=torch.int32, device=values.device)
    _launch(values, cuts, None, out, 1, 0.0)
    return out


count_leq.launches = 0   # kernel launches on CUDA tensors


def _passes(vmax: float) -> int:
    """Passes of the search over [0, vmax]: ceil(log_FANOUT(vmax + 2)) + 1
    (7 at BraTS vmax)."""
    return int(math.ceil(math.log(float(vmax) + 2.0, FANOUT))) + 1


def _flatten(values: torch.Tensor, ks: torch.Tensor):
    """values (..., M), ks (..., K) -> (C, M) f32, (C, K) int32 and the
    broadcast leading shape."""
    lead = torch.broadcast_shapes(values.shape[:-1], ks.shape[:-1])
    m, k = values.shape[-1], ks.shape[-1]
    if values.dtype != torch.float32:
        raise ValueError("values must be float32")
    if k * (FANOUT - 1) > MAX_CUTS:
        raise ValueError(f"{k} ranks x {FANOUT - 1} cut points per class; "
                         f"the kernel takes at most {MAX_CUTS}")
    values = values.expand(*lead, m).reshape(-1, m).contiguous()
    ks = ks.to(device=values.device, dtype=torch.int32).expand(
        *lead, k).reshape(-1, k).contiguous()
    return values, ks, lead


def _search(values: torch.Tensor, ks: torch.Tensor, vmax: float,
            count) -> torch.Tensor:
    """The search as torch ops on (C, K, S) tensors, counting through
    ``count``: (C, M) f32, (C, K) int32 -> (C, K) f32."""
    c, k = ks.shape
    s = FANOUT - 1
    dev = values.device
    lo = torch.zeros(ks.shape, dtype=torch.float32, device=dev)   # (C, K)
    hi = torch.full(ks.shape, float(vmax), dtype=torch.float32, device=dev)
    steps = torch.arange(1, FANOUT, dtype=torch.float32, device=dev)  # (S,)
    need = (ks + 1)[..., None]
    for _ in range(_passes(vmax)):
        ln = hi - lo + 1.0
        # integer cuts t_s = lo - 1 + floor(s * L / FANOUT), s = 1..S
        cuts = lo[..., None] - 1.0 + torch.floor(
            steps * ln[..., None] / FANOUT)                       # (C, K, S)
        cnt = count(values, cuts.reshape(c, k * s)).reshape(c, k, s)
        ok = cnt >= need
        # answer <= t_s iff ok_s; the interval becomes
        #   [max(lo, max{t_s + 1 : not ok_s}), min(hi, min{t_s : ok_s})]
        new_lo = torch.amax(torch.where(ok, lo[..., None], cuts + 1.0), -1)
        new_hi = torch.amin(torch.where(ok, cuts, hi[..., None]), -1)
        lo, hi = torch.maximum(lo, new_lo), torch.minimum(hi, new_hi)
    return hi


def masked_order_stats(values: torch.Tensor, ks: torch.Tensor,
                       vmax: float) -> torch.Tensor:
    """k-th smallest (0-based) of the entries of each row of ``values``
    below ``vmax`` (masked-out entries are >= vmax): values (..., M) f32,
    ks (..., K) int -> (..., K) f32, leading axes broadcast.  Every form
    runs as one (C, M) / (C, K) search: on a CUDA tensor the kernel's
    search mode, one launch per pass; on a CPU tensor the torch-op search
    over :func:`count_leq`.

    An m-ary search over the exact integers [0, vmax]: each pass counts
    FANOUT - 1 cut points per rank in one read of the values, so the search
    takes ceil(log_FANOUT(vmax + 2)) + 1 passes (7 at BraTS vmax).  All
    interval arithmetic stays on integers exact in f32.  The counts are
    compared with the ranks as integers (the TPU kernel's caller casts them
    to f32, which rounds above 2^24)."""
    k = ks.shape[-1]
    values, ks, lead = _flatten(values, ks)
    if values.device.type == "cpu":
        return _search(values, ks, vmax, count_leq).reshape(*lead, k)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    if values.shape[1] >= 2 ** 31:
        raise ValueError("more values per class than an int32 count holds")
    out = torch.empty(ks.shape, dtype=torch.float32, device=values.device)
    _launch(values, None, ks, out, _passes(vmax), float(vmax))
    return out.reshape(*lead, k)


masked_order_stats.launches = 0   # kernel launches (passes) on CUDA tensors


def masked_order_stats_plain(values: torch.Tensor, ks: torch.Tensor,
                             vmax: float) -> torch.Tensor:
    """Plain PyTorch version of the search (any device): the same torch
    ops over :func:`count_leq_plain`."""
    k = ks.shape[-1]
    values, ks, lead = _flatten(values, ks)
    return _search(values, ks, vmax, count_leq_plain).reshape(*lead, k)
