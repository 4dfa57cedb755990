"""The training objective with deep supervision, in plain PyTorch: the
published ``softmax_dice`` on the 4-class output plus, for each of the
final and the mid supervision heads, a per-region Dice + weighted
cross-entropy against the binarised label (regions 1, 2 and 4) and against
the region's boundary decoded from the 8-valued edge map."""

from __future__ import annotations

import torch
import torch.nn.functional as F

REGION_LABELS = {"01": 1, "02": 2, "04": 3}     # BraTS 4 is loaded as 3
EDGE_CODES = {"01": (1, 5, 6, 7), "02": (2, 5, 6, 8), "04": (4, 5, 7, 8)}


def dice_loss(p, t, num_cls, eps=1e-7):
    num = (p * t).sum(dim=(0, 1, 2, 3))
    den = p.sum(dim=(0, 1, 2, 3)) + t.sum(dim=(0, 1, 2, 3)) + eps
    return 1.0 - (2.0 * num / den).sum() / num_cls


def weighted_ce(p, t):
    """Cross-entropy weighted per (sample, class) by 1 - the class's share
    of the sample's voxels, probabilities clamped to [0.005, 1]."""
    share = t.sum(dim=(1, 2, 3)) / t.sum(dim=(1, 2, 3, 4))[:, None]
    w = (1.0 - share)[:, None, None, None, :]
    return (-(w * t * torch.log(torch.clamp(p, 0.005, 1.0)))).sum(-1).mean()


def binary_loss(p2, positive):
    t = F.one_hot(positive.long(), 2).float()
    return weighted_ce(p2, t) + dice_loss(p2, t, 2)


def total_loss(outputs, target, edge) -> torch.Tensor:
    """outputs: the network's 5-tuple; target (B, D, H, W) labels {0..3};
    edge (B, D, H, W) edge codes."""
    seg, sup, edge_sup, mid_sup, mid_edge_sup = outputs
    t = F.one_hot(target.long(), 4).float()
    main = dice_loss(seg, t, 4) + weighted_ce(seg, t)

    def regions(out):
        return sum(binary_loss(out[r], target == c)
                   for r, c in REGION_LABELS.items())

    def edges(out):
        total = 0
        for r, codes in EDGE_CODES.items():
            pos = torch.zeros(edge.shape, dtype=torch.bool,
                              device=edge.device)
            for c in codes:
                pos |= edge == c
            total = total + binary_loss(out[r], pos)
        return total
    return (main + regions(sup) + edges(edge_sup) + regions(mid_sup)
            + edges(mid_edge_sup))
