"""Logical operations and bytes of Swin UNETR's serving forward, counted on
the benchmark's reference (``swin_unetr.py``) from shapes alone (meta
tensors: nothing runs), so that no change of the port's path moves the
yardstick.

  * operations: ``torch.utils.flop_counter.FlopCounterMode`` over the
    reference's forward at the batch and crop size: the convolutions, the
    linear layers and the two products of each window attention;
  * the convolutions' summed bounds: each the larger of its operations at
    the bf16 peak and its bytes at HBM's rate (``counts.py``
    ``conv_costs``: input, weight, bias and output moved once);
  * K1's bound: the norm sites of the ten residual blocks (after conv1,
    after conv3 where the widths differ: the input read and the output
    written once; after conv2, with the residual: also the residual read
    once), at HBM's rate;
  * K8's bound: each window attention's q, k and v read and its output
    written once at HBM's rate, or its 4 N^2 D flops a (window, head) at
    the bf16 peak, the larger, summed over the calls.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.counts import (BF16_FLOPS, HBM_BYTES_PER_S, bound_s,
                                        conv_costs)
from benchmark.reference.swin_unetr import SwinUNETRRef, param_specs

CROP = 128     # the engine's crops


def count(model: dict, batch: int, img: int = CROP) -> dict:
    """The counts of one forward of ``batch`` crops of ``img``^3:
    ``flops``, ``convs`` (the calls) and ``conv_bound_s``, ``k1_sites``,
    ``k1_bytes`` and ``k1_bound_s``, ``window_calls``, ``window_bytes``,
    ``window_flops`` and ``window_bound_s``."""
    rec: list = []
    params = {n: torch.empty(s, device="meta")
              for n, s, _, _ in param_specs(model)}
    ref = SwinUNETRRef(model, params, record=rec)
    x = torch.empty((batch, img, img, img, model["in_channels"]),
                    device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.forward(x)
    elem = 2 if model["compute_dtype"] in ("bfloat16", "float16") else 4
    convs = [r for r in rec if "name" in r]
    out = dict(flops=float(fc.get_total_flops()), convs=len(convs),
               conv_bound_s=sum(bound_s(*conv_costs(r, elem)["fwd"])
                                for r in convs))
    norms = [r for r in rec if "norm" in r]
    k1 = sum(math.prod(r["x"]) * elem * (3 if r["norm"] == "residual" else 2)
             for r in norms)
    out.update(k1_sites=len(norms), k1_bytes=k1,
               k1_bound_s=k1 / HBM_BYTES_PER_S)
    wins = [r for r in rec if "window_attention" in r]
    wbytes = [4 * r["bw"] * r["n"] * r["heads"] * r["d"] * elem for r in wins]
    wflops = [4 * r["bw"] * r["heads"] * r["n"] ** 2 * r["d"] for r in wins]
    out.update(window_calls=len(wins), window_bytes=sum(wbytes),
               window_flops=sum(wflops),
               window_bound_s=sum(bound_s(f, b)
                                  for f, b in zip(wflops, wbytes)))
    return out


def counts_of(ctx, batch: int = 8) -> dict:
    """The counts of the cell's configuration at ``batch``, once per run
    (kept on ``ctx.counts``)."""
    key = ("swin_unetr", batch)
    if key not in ctx.counts:
        ctx.counts[key] = count(ctx.config["model"], batch)
    return ctx.counts[key]


__all__ = ["count", "counts_of", "BF16_FLOPS", "HBM_BYTES_PER_S"]
