"""Logical operations and bytes of a configuration's work, counted on the
reference's direct path from shapes alone (meta tensors: nothing runs).

What the port executes (space-to-depth convs, casts, padding) does not
enter these counts, so a change of the port's path cannot move the
yardstick: a share of a peak or of a roofline stays at or under 100 %.

  * operations: ``torch.utils.flop_counter.FlopCounterMode`` over the
    reference's forward (and, for training, the loss and the backward);
  * each convolution's bound: the larger of its operations at the bf16
    peak and its bytes at HBM's rate, the input, weight, bias and output
    each moved once in the compute dtype; in training also the input
    gradient (not of the first conv) and the weight gradient, each its own
    kernel;
  * K1's bound: the 32 norm sites of the UNet's residual blocks, the input
    (and the residual) read once and the output written once.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.loss import total_loss
from benchmark.reference.model import ClsWiseFormerRef, geometry, param_specs

BF16_FLOPS = 989e12          # H100 SXM dense bf16, NVIDIA data sheet
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3


def _meta_params(model: dict, grad: bool) -> Dict[str, torch.Tensor]:
    return {n: torch.empty(s, device="meta", requires_grad=grad)
            for n, s, _, _ in param_specs(model)}


def conv_costs(rec: dict, elem: int) -> dict:
    """(ops, bytes) of one recorded convolution's forward, input-gradient
    and weight-gradient kernels, ``elem`` bytes an element."""
    x, w, y = math.prod(rec["x"]), math.prod(rec["w"]), math.prod(rec["y"])
    taps = math.prod(rec["w"][2:])
    cin = rec["w"][0] if rec["transposed"] else rec["w"][1]
    cout = rec["w"][1] if rec["transposed"] else rec["w"][0]
    # a transposed conv maps each input voxel through every tap
    positions = (math.prod(rec["x"][:4]) if rec["transposed"]
                 else math.prod(rec["y"][:4]))
    ops = 2 * positions * cin * cout * taps
    bias = cout
    return {"fwd": (ops, (x + w + bias + y) * elem),
            "dgrad": (ops, (y + w + x) * elem),
            "wgrad": (ops, (y + x + w + bias) * elem)}


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def count(model: dict, batch: int, train: bool) -> dict:
    """The counts of one forward at ``batch`` (``train``: with the loss
    and the backward): ``flops``, ``convs`` (the calls), ``conv_bound_s``,
    and for the forward ``k1_bytes`` and ``k1_bound_s``."""
    g = geometry(model)
    rec: list = []
    ref = ClsWiseFormerRef(model, _meta_params(model, train), record=rec)
    d, c = g["img"], g["in_ch"]
    x = torch.empty((batch, d, d, d, c), device="meta")
    with FlopCounterMode(display=False) as fc:
        if train:
            target = torch.zeros((batch, d, d, d), dtype=torch.long,
                                 device="meta")
            total_loss(ref.forward(x), target, target).backward()
        else:
            with torch.no_grad():
                ref.forward(x)
    elem = 2 if model["compute_dtype"] in ("bfloat16", "float16") else 4
    convs = [r for r in rec if "name" in r]
    bound = 0.0
    for i, r in enumerate(convs):
        costs = conv_costs(r, elem)
        kinds = (("fwd", "wgrad") + (("dgrad",) if i else ())) if train \
            else ("fwd",)
        bound += sum(bound_s(*costs[k]) for k in kinds)
    out = dict(flops=float(fc.get_total_flops()), convs=len(convs),
               conv_bound_s=bound)
    norms = [r for r in rec if r.get("norm") == "block"]
    k1 = sum(math.prod(r["x"]) * elem * (3 if r["residual"] else 2)
             for r in norms)
    out.update(k1_sites=len(norms), k1_bytes=k1,
               k1_bound_s=k1 / HBM_BYTES_PER_S)
    return out
