"""torch's Adam with L2 weight decay and amsgrad, written out, and the
poly learning rate of the training recipe."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def poly_lr(init_lr: float, end_epoch: int, steps_per_epoch: int,
            power: float, step: int) -> float:
    """round(init * (1 - epoch / end_epoch)^power, 8), in float32."""
    epoch = step // steps_per_epoch
    frac = np.float32(1.0) - np.float32(epoch) / np.float32(end_epoch)
    lr = np.float32(init_lr) * np.power(np.maximum(frac, np.float32(0)),
                                        np.float32(power))
    return float(np.round(lr * np.float32(1e8)) / np.float32(1e8))


class Adam:
    """The update of ``torch.optim.Adam(amsgrad=True, weight_decay=wd)``:
    g = grad + wd p; m, v moving averages; v_max = max(v_max, v);
    p -= lr / (1 - b1^t) * m / (sqrt(v_max) / sqrt(1 - b2^t) + eps)."""

    def __init__(self, weight_decay: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.wd, (self.b1, self.b2), self.eps = weight_decay, betas, eps
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.vmax: Dict[str, torch.Tensor] = {}
        self.first_grad: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = math.sqrt(1.0 - self.b2 ** self.t)
        for name, p in params.items():
            if p.grad is None:
                continue
            g = p.grad + self.wd * p
            if self.t == 1:
                self.first_grad[name] = g.clone()
                self.m[name] = torch.zeros_like(p)
                self.v[name] = torch.zeros_like(p)
                self.vmax[name] = torch.zeros_like(p)
            m, v, vmax = self.m[name], self.v[name], self.vmax[name]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            torch.maximum(vmax, v, out=vmax)
            p.addcdiv_(m, vmax.sqrt() / c2 + self.eps, value=-lr / c1)
            p.grad = None
