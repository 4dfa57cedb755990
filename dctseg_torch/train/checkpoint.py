"""Checkpoints in the reference's format (the JAX package's
``dctseg/train/checkpoint.py`` keeps the same contents in Orbax).

One file per epoch, ``<dir>/model_epoch_{epoch}.pth``, holding the
reference's ``{'epoch', 'state_dict', 'optim_dict'}`` plus ``'step'`` and
``'partial'`` for a full resume; the reference's tools and
``dctseg.utils.torch_convert.load_torch_checkpoint`` read it as it is.  The
reference saves every ``save_freq`` epochs and the last three; its resume
restores the parameters only, which stays the default (``restore_full`` is
the true resume).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

_NAME = re.compile(r"model_epoch_(\d+)\.pth")


def should_save(epoch: int, save_freq: int, end_epoch: int) -> bool:
    """The reference's save predicate."""
    e = epoch + 1
    return (e % save_freq == 0
            or (end_epoch - 1 > 0 and e % (end_epoch - 1) == 0)
            or (end_epoch - 2 > 0 and e % (end_epoch - 2) == 0)
            or (end_epoch - 3 > 0 and e % (end_epoch - 3) == 0))


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"model_epoch_{epoch}.pth")

    def save(self, epoch: int, state_dict: Dict[str, torch.Tensor],
             optim_dict: dict, step: int, partial: bool = False) -> str:
        """Write the epoch's file (replacing one already there: a resumed
        epoch's save supersedes its preemption save).  ``partial`` marks a
        mid-epoch save, whose full resume re-runs the epoch."""
        os.makedirs(self.directory, exist_ok=True)
        path = self.path(epoch)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"epoch": epoch,
                    "state_dict": {k: v.detach().cpu()
                                   for k, v in state_dict.items()},
                    "optim_dict": optim_dict, "step": int(step),
                    "partial": bool(partial)}, tmp)
        os.replace(tmp, path)
        return path

    def all_epochs(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in
                      map(_NAME.fullmatch, os.listdir(self.directory)) if m)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def _load(self, epoch: int) -> dict:
        return torch.load(self.path(epoch), map_location="cpu",
                          weights_only=True)

    def restore_params(self, epoch: int) -> Dict[str, torch.Tensor]:
        """The epoch's state_dict (DDP ``module.`` prefixes stripped)."""
        return _strip(self._load(epoch)["state_dict"])

    def restore_full(self, epoch: int) -> Tuple[dict, dict, dict]:
        """(state_dict, optim_dict, {'epoch', 'step', 'partial'})."""
        ckpt = self._load(epoch)
        meta = {"epoch": int(ckpt["epoch"]), "step": int(ckpt.get("step", 0)),
                "partial": bool(ckpt.get("partial", False))}
        return _strip(ckpt["state_dict"]), ckpt["optim_dict"], meta


def _strip(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}
