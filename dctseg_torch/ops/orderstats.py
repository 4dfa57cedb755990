"""The pooled-distance order-statistic search of HD95: the port of the TPU
kernel ``dctseg/ops/pallas/orderstats.py``.

``count_leq`` is the kernel (``_count_leq`` there): per class, the count of
values at or below each cut point.  On a CUDA tensor it launches the
hand-written kernel of ``dctseg_torch/csrc/orderstats.cu`` or raises; on a
CPU tensor it runs the plain PyTorch version below.  Counts are integers,
so the two are equal.

``masked_order_stats`` is the m-ary search around it, torch ops on
(C, K, S) tensors with a static pass count: no host sync.
"""

from __future__ import annotations

import math

import torch

from dctseg_torch.ops import _build

MAX_CUTS = 32        # csrc/orderstats.cu: cut points per class
# Search fanout.  A power of two: the cut-point division s * L / FANOUT is
# exact in f32 only then.  At 8, one pass takes up to 4 ranks per class.
FANOUT = 8


def count_leq_plain(values: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    """values (C, M) f32, cuts (C, T) f32 -> (C, T) int32 counts of
    values[c] <= cuts[c, t]."""
    return (values[:, None, :] <= cuts[:, :, None]).sum(-1, dtype=torch.int32)


def _launch(values: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    c, m = values.shape
    t = cuts.shape[1]
    out = torch.zeros((c, t), dtype=torch.int32, device=values.device)
    lib = _build.lib()
    stream = _build.stream_of(values)
    _build.check(lib.dctseg_count_leq(values.data_ptr(), cuts.data_ptr(),
                                      out.data_ptr(), c, m, t, stream),
                 "orderstats")
    count_leq.launches += 1
    return out


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
    return _launch(values, cuts)


count_leq.launches = 0   # kernel launches on CUDA tensors


def masked_order_stats(values: torch.Tensor, ks: torch.Tensor,
                       vmax: float) -> torch.Tensor:
    """k-th smallest (0-based) of the entries of each row of ``values``
    below ``vmax`` (masked-out entries are >= vmax): values (..., M) f32,
    ks (..., K) int -> (..., K) f32, leading axes broadcast.  Every form
    runs as one (C, M) / (C, K) search, so a CUDA tensor always goes
    through the count kernel.

    An m-ary search over the exact integers [0, vmax]: each pass counts
    FANOUT - 1 cut points per rank in one read of the values, so the search
    takes ceil(log_FANOUT(vmax + 2)) + 1 passes (7 at BraTS vmax).  All
    interval arithmetic stays on integers exact in f32.  The counts are
    compared with the ranks as integers (the TPU kernel's caller casts them
    to f32, which rounds above 2^24)."""
    lead = torch.broadcast_shapes(values.shape[:-1], ks.shape[:-1])
    m, k = values.shape[-1], ks.shape[-1]
    values = values.expand(*lead, m).reshape(-1, m).contiguous()
    c = values.shape[0]
    s = FANOUT - 1
    dev = values.device
    ks = ks.to(device=dev, dtype=torch.int32).expand(*lead, k).reshape(c, k)
    lo = torch.zeros(ks.shape, dtype=torch.float32, device=dev)   # (C, K)
    hi = torch.full(ks.shape, float(vmax), dtype=torch.float32, device=dev)
    iters = int(math.ceil(math.log(float(vmax) + 2.0, FANOUT))) + 1
    steps = torch.arange(1, FANOUT, dtype=torch.float32, device=dev)  # (S,)
    need = (ks + 1)[..., None]
    for _ in range(iters):
        ln = hi - lo + 1.0
        # integer cuts t_s = lo - 1 + floor(s * L / FANOUT), s = 1..S
        cuts = lo[..., None] - 1.0 + torch.floor(
            steps * ln[..., None] / FANOUT)                       # (C, K, S)
        cnt = count_leq(values, cuts.reshape(c, k * s)).reshape(c, k, s)
        ok = cnt >= need
        # answer <= t_s iff ok_s; the interval becomes
        #   [max(lo, max{t_s + 1 : not ok_s}), min(hi, min{t_s : ok_s})]
        new_lo = torch.amax(torch.where(ok, lo[..., None], cuts + 1.0), -1)
        new_hi = torch.amin(torch.where(ok, cuts, hi[..., None]), -1)
        lo, hi = torch.maximum(lo, new_lo), torch.minimum(hi, new_hi)
    return hi.reshape(*lead, k)
