"""Optimizer and LR schedule of the reference training recipe (the JAX
package's ``dctseg/train/optim.py``).

The reference trains with ``torch.optim.Adam(lr=2e-4, weight_decay=1e-5,
amsgrad=True)``; the JAX package rebuilds exactly that update (L2 weight
decay added to the gradient before the moments, torch's amsgrad with the
raw second moment maxed), so the port uses ``torch.optim.Adam`` itself.
The learning rate is a poly(0.9) decay of the epoch, rounded to 8 decimals,
set before every step from the step counter; the reference's amp driver
restarts it past ``restart_epoch``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from dctseg_torch.config import TrainConfig


def poly_schedule(init_lr: float, end_epoch: int, steps_per_epoch: int,
                  power: float = 0.9,
                  restart_epoch: Optional[int] = None
                  ) -> Callable[[int], float]:
    """lr(step) = round(init * (1 - epoch / end_epoch)^power, 8), the epoch
    derived from the step counter.  Computed in float32, as the JAX
    schedule is."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if restart_epoch is not None and epoch > restart_epoch:
            epoch -= restart_epoch
        frac = np.float32(1.0) - np.float32(epoch) / np.float32(end_epoch)
        lr = np.float32(init_lr) * np.power(np.maximum(frac, np.float32(0)),
                                            np.float32(power))
        return float(np.round(lr * np.float32(1e8)) / np.float32(1e8))

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: TrainConfig
                   ) -> torch.optim.Adam:
    """Adam with the reference's L2 weight decay and amsgrad; the trainer
    sets the learning rate from :func:`poly_schedule` before each step."""
    return torch.optim.Adam(params, lr=cfg.lr, weight_decay=cfg.weight_decay,
                            amsgrad=cfg.amsgrad)


def make_schedule(cfg: TrainConfig, steps_per_epoch: int
                  ) -> Callable[[int], float]:
    return poly_schedule(cfg.lr, cfg.end_epoch, steps_per_epoch,
                         cfg.poly_power, cfg.amp_lr_restart_epoch)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
