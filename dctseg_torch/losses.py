"""Loss suite with the reference's semantics, channels last (the JAX
package's ``dctseg/losses.py``).

Every function takes softmax probabilities (the decoder and the supervision
heads already apply softmax, as in the reference) and integer targets, and
computes in float32.

  dice_loss / softmax_weighted_loss      soft dice, class-weighted CE
  softmax_dice                           the main criterion
  get_separate_loss                      per-region heads vs binarized labels
  get_edge_separate_loss                 per-region edge heads vs the
                                         8-valued edge code
  softmax_dice2 / sigmoid_dice /
  generalized_dice / dual_focal_loss     the reference's other criteria

Data parallel: under :func:`batch_group` every sum and mean over the batch
runs over the global batch, the rows of every rank of the group, as the
JAX package's loss runs over its sharded global batch: the local sums are
all-reduced (with autograd) and the means divide by the global count.
Every rank then holds the same loss, and its gradient is the group's size
times its rows' share, which an average over the ranks turns into the
global batch's gradient.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dctseg_torch.parallel import spatial

Tensor = torch.Tensor

_GROUP: contextvars.ContextVar = contextvars.ContextVar("dctseg_loss_group",
                                                        default=None)


@contextlib.contextmanager
def batch_group(group):
    """Reduce the losses' batch sums over ``group`` (None: this rank's
    batch alone)."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def _bsum(t: Tensor, dim=None) -> Tensor:
    """``t.sum(dim)`` over the global batch."""
    s = t.sum() if dim is None else t.sum(dim=dim)
    return spatial.reduce_sum(s, _GROUP.get())


def _bmean(t: Tensor) -> Tensor:
    """``t.mean()`` over the global batch (every rank's ``t`` has the same
    shape)."""
    group = _GROUP.get()
    if group is None:
        return t.mean()
    return _bsum(t) / (t.numel() * dist.get_world_size(group))

# Edge-label decode: an 8-valued edge code per voxel; the positive set per
# region is NCR {1, 5, 6, 7}, edema {2, 5, 6, 8}, enhancing {4, 5, 7, 8}:
# code 5 = all three boundaries coincide, 6 = 1&2, 7 = 1&4, 8 = 2&4.
EDGE_POSITIVE_CODES = {"01": (1, 5, 6, 7), "02": (2, 5, 6, 8),
                       "04": (4, 5, 7, 8)}


def one_hot_last(target: Tensor, num_classes: int) -> Tensor:
    """(B, D, H, W) int -> (B, D, H, W, C) float32 one-hot."""
    return F.one_hot(target.long(), num_classes).float()


def dice_loss(probs: Tensor, target_onehot: Tensor, num_cls: int,
              eps: float = 1e-7) -> Tensor:
    """Soft dice over classes: 1 - mean_c 2|p t| / (|p| + |t| + eps).
    probs / target: (B, D, H, W, C)."""
    p, t = probs.float(), target_onehot.float()
    num = _bsum(p * t, (0, 1, 2, 3))
    left = _bsum(p, (0, 1, 2, 3))
    right = _bsum(t, (0, 1, 2, 3))
    dice = (2.0 * num / (left + right + eps)).sum()
    return 1.0 - dice / num_cls


def softmax_weighted_loss(probs: Tensor, target_onehot: Tensor,
                          num_cls: int) -> Tensor:
    """Class-frequency-weighted CE with the probabilities clamped to
    [0.005, 1].  Weight per (sample, class) = 1 - voxels_c / voxels."""
    p, t = probs.float(), target_onehot.float()
    per_class = t.sum(dim=(1, 2, 3))                       # (B, C)
    total = t.sum(dim=(1, 2, 3, 4))[:, None]
    weighted = 1.0 - per_class / total
    logp = torch.log(torch.clamp(p, 0.005, 1.0))
    cross = -(weighted[:, None, None, None, :] * t * logp)
    return _bmean(cross.sum(dim=-1))


def softmax_dice(probs: Tensor, target: Tensor) -> Tensor:
    """Main segmentation loss: soft dice + weighted CE on the 4-class
    one-hot target (labels {0, 1, 2, 3}; BraTS 4 mapped to 3 by the
    loader)."""
    t = one_hot_last(target, 4)
    return dice_loss(probs, t, 4) + softmax_weighted_loss(probs, t, 4)


def _binary_region_loss(probs2: Tensor, positive: Tensor) -> Tensor:
    """Dice + weighted CE on a binary one-hot target."""
    t = one_hot_last(positive, 2)
    return softmax_weighted_loss(probs2, t, 2) + dice_loss(probs2, t, 2)


def get_separate_loss(outputs: Dict[str, Tensor], target: Tensor) -> Tensor:
    """Per-region auxiliary loss: each region head against its binarized
    target (label r vs the rest)."""
    loss = _binary_region_loss(outputs["01"], target == 1)
    loss = loss + _binary_region_loss(outputs["02"], target == 2)
    return loss + _binary_region_loss(outputs["04"], target == 3)


def get_edge_separate_loss(outputs: Dict[str, Tensor], edge: Tensor
                           ) -> Tensor:
    """Per-region edge auxiliary loss: the 8-valued edge code decoded into a
    binary boundary target per region."""
    loss = None
    for key, codes in EDGE_POSITIVE_CODES.items():
        positive = torch.zeros(edge.shape, dtype=torch.bool,
                               device=edge.device)
        for c in codes:
            positive |= edge == c
        part = _binary_region_loss(outputs[key], positive)
        loss = part if loss is None else loss + part
    return loss


def total_loss(outputs, target: Tensor, edge: Tensor,
               criterion=softmax_dice) -> Dict[str, Tensor]:
    """The full training objective: the main loss plus the final and mid
    region and edge auxiliary losses, with every component for logging."""
    seg, sup, edge_sup, mid_sup, mid_edge_sup = outputs
    main = criterion(seg, target)
    if isinstance(main, tuple):
        # the other criteria return (loss, dice1, dice2, dice3)
        main = main[0]
    s_loss = get_separate_loss(sup, target)
    e_loss = get_edge_separate_loss(edge_sup, edge)
    mid_s_loss = get_separate_loss(mid_sup, target)
    mid_e_loss = get_edge_separate_loss(mid_edge_sup, edge)
    total = main + s_loss + e_loss + mid_s_loss + mid_e_loss
    return {"loss": total, "end_loss": main, "s_loss": s_loss,
            "edge_loss": e_loss, "mid_s_loss": mid_s_loss,
            "mid_edge_loss": mid_e_loss}


# ---- the reference's other criteria ----

def _dice_1m(o: Tensor, t: Tensor, eps: float = 1e-5) -> Tensor:
    """1 - 2|o t| / (|o| + |t| + eps)."""
    o, t = o.float(), t.float()
    return 1.0 - 2.0 * _bsum(o * t) / (_bsum(o) + _bsum(t) + eps)


def softmax_dice2(probs: Tensor, target: Tensor):
    """Like the reference, class 3 compares against raw label 4."""
    l0 = _dice_1m(probs[..., 0], target == 0)
    l1 = _dice_1m(probs[..., 1], target == 1)
    l2 = _dice_1m(probs[..., 2], target == 2)
    l3 = _dice_1m(probs[..., 3], target == 4)
    return l0 + l1 + l2 + l3, 1 - l1, 1 - l2, 1 - l3


def sigmoid_dice(probs: Tensor, target: Tensor):
    """Three foreground channels only."""
    l1 = _dice_1m(probs[..., 0], target == 1)
    l2 = _dice_1m(probs[..., 1], target == 2)
    l3 = _dice_1m(probs[..., 2], target == 4)
    return l1 + l2 + l3, 1 - l1, 1 - l2, 1 - l3


def generalized_dice(probs: Tensor, target: Tensor, eps: float = 1e-5,
                     weight_type: str = "square"):
    """Generalized dice on the foreground classes."""
    target = torch.where(target == 4, 3, target)
    c = probs.shape[-1]
    t = one_hot_last(target, c)
    p = probs.float().reshape(-1, c).T[1:]          # (C-1, V)
    t = t.reshape(-1, c).T[1:]
    tsum = _bsum(t, -1)
    if weight_type == "square":
        w = 1.0 / (tsum * tsum + eps)
    elif weight_type == "identity":
        w = 1.0 / (tsum + eps)
    elif weight_type == "sqrt":
        w = 1.0 / (torch.sqrt(tsum) + eps)
    else:
        raise ValueError(f"weight_type {weight_type!r}")
    intersect = _bsum(p * t, -1)
    denom = _bsum(p + t, -1)
    loss = 1.0 - 2.0 * (intersect * w).sum() / ((denom * w).sum() + eps)
    per = 2.0 * intersect / (denom + eps)
    return loss, per[0], per[1], per[2]


def dual_focal_loss(probs: Tensor, target: Tensor):
    l1 = _dice_1m(probs[..., 1], target == 1)
    l2 = _dice_1m(probs[..., 2], target == 2)
    l3 = _dice_1m(probs[..., 3], target == 4)
    target = torch.where(target == 4, 3, target)
    c = probs.shape[-1]
    t = one_hot_last(target, c).reshape(-1, c).T      # (C, V)
    p = probs.float().reshape(-1, c).T
    score = 1.0 - (t - p) ** 2
    loss = _bmean(-torch.log_softmax(score, dim=0))
    return loss, 1 - l1, 1 - l2, 1 - l3


CRITERIA = {
    "softmax_dice": softmax_dice,
    "softmax_dice2": softmax_dice2,
    "sigmoid_dice": sigmoid_dice,
    "Generalized_dice": generalized_dice,
    "Dual_focal_loss": dual_focal_loss,
}
