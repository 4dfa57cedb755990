"""Inference engines: batched forward, flip TTA, sliding-window tiling (the
JAX package's ``dctseg/infer/engine.py`` ``Predictor``).

  * The 8 flip variants of flip TTA and the 8 crops of sliding-window tiling
    each go through the model as ONE B=8 forward.
  * The decoder's output is already a softmax; flip TTA softmaxes it again
    before averaging (the reference's double softmax), kept for parity.
  * Reference stitching quirk: the high-depth crops start at slice 27 but
    are stitched from ``[..., 96:123]`` into ``[..., 128:155]`` -- a 5-slice
    misalignment.  ``stitch_mode='reference'`` reproduces it; ``'aligned'``
    uses the correct ``101:128`` window.

Volumes are NDHWC.  Every engine runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from dctseg_torch.device import resolve_device

FLIP_COMBOS: List[tuple] = [
    (), (1,), (2,), (3,), (1, 2), (1, 3), (2, 3), (1, 2, 3),
]  # spatial axes of NDHWC, in the reference's order

# (H, W, D) windows of the 128^3 crops of a (240, 240, >=155) volume
CROPS = [
    (slice(0, 128), slice(0, 128), slice(0, 128)),
    (slice(0, 128), slice(112, 240), slice(0, 128)),
    (slice(112, 240), slice(0, 128), slice(0, 128)),
    (slice(112, 240), slice(112, 240), slice(0, 128)),
    (slice(0, 128), slice(0, 128), slice(27, 155)),
    (slice(0, 128), slice(112, 240), slice(27, 155)),
    (slice(112, 240), slice(0, 128), slice(27, 155)),
    (slice(112, 240), slice(112, 240), slice(27, 155)),
]


class Predictor:
    """Inference over one model.  ``device`` defaults to the GPU (raises if
    there is none; pass ``device='cpu'`` for the CPU).  ``microbatch`` caps
    the per-call forward batch of the 8-variant engines."""

    def __init__(self, model: torch.nn.Module, device=None,
                 microbatch: Optional[int] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.microbatch = microbatch

    def _input(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device)

    def _forward(self, xs: torch.Tensor) -> torch.Tensor:
        mb = self.microbatch
        if mb is None or xs.shape[0] <= mb:
            return self.model(xs)[0]
        return torch.cat([self.model(xs[i:i + mb])[0]
                          for i in range(0, xs.shape[0], mb)], dim=0)

    @torch.inference_mode()
    def seg_probs(self, x) -> torch.Tensor:
        """(B, D, H, W, M) -> (B, D, H, W, C) decoder softmax probs."""
        return self._forward(self._input(x))

    # ---- flip TTA ----

    @staticmethod
    def flip_batch(x: torch.Tensor) -> torch.Tensor:
        """(1, D, H, W, M) -> (8, D, H, W, M) flip variants."""
        return torch.cat([torch.flip(x, c) if c else x for c in FLIP_COMBOS],
                         dim=0)

    @staticmethod
    def unflip_mean(probs: torch.Tensor) -> torch.Tensor:
        """(8, D, H, W, C) flip-variant probs -> (1, D, H, W, C) mean of
        their softmaxes, each unflipped."""
        acc = torch.zeros_like(probs[0:1], dtype=torch.float32)
        for i, c in enumerate(FLIP_COMBOS):
            p = probs[i:i + 1]
            p = torch.flip(p, c) if c else p
            acc = acc + torch.softmax(p.float(), dim=-1)
        return acc / len(FLIP_COMBOS)

    @torch.inference_mode()
    def tta_probs(self, x) -> torch.Tensor:
        """8-way flip TTA with double-softmax averaging; x is (1, ...)."""
        x = self._input(x)
        if x.shape[0] != 1:
            raise ValueError("TTA operates per volume: x must be (1, ...)")
        return self.unflip_mean(self._forward(self.flip_batch(x)))

    # ---- sliding-window tiling ----

    @staticmethod
    def crops(x: torch.Tensor) -> torch.Tensor:
        """(1, 240, 240, >=155, M) -> (8, 128, 128, 128, M) crops."""
        return torch.cat([x[:, h, w, d, :] for h, w, d in CROPS], dim=0)

    @staticmethod
    def stitch_volume(t: torch.Tensor, stitch_ref: bool) -> torch.Tensor:
        """(8, 128^3, C) crop outputs -> (240, 240, 155, C) volume.  Later
        crops overwrite the 16-voxel H/W overlap with their inner region."""
        y = torch.zeros((240, 240, 155, t.shape[-1]), dtype=t.dtype,
                        device=t.device)
        y[:128, :128, :128] = t[0]
        y[:128, 128:240, :128] = t[1, :, 16:128, :]
        y[128:240, :128, :128] = t[2, 16:128, :, :]
        y[128:240, 128:240, :128] = t[3, 16:128, 16:128, :]
        lo, hi = (96, 123) if stitch_ref else (101, 128)
        y[:128, :128, 128:155] = t[4, :, :, lo:hi]
        y[:128, 128:240, 128:155] = t[5, :, 16:128, lo:hi]
        y[128:240, :128, 128:155] = t[6, 16:128, :, lo:hi]
        y[128:240, 128:240, 128:155] = t[7, 16:128, 16:128, lo:hi]
        return y

    @torch.inference_mode()
    def tiled_probs(self, x, stitch_mode: str = "reference") -> torch.Tensor:
        """(1, 240, 240, >=155, M) -> (1, 240, 240, 155, C)."""
        if stitch_mode not in ("reference", "aligned"):
            raise ValueError(f"unknown stitch_mode {stitch_mode!r}")
        x = self._input(x)
        if x.shape[0] != 1:
            raise ValueError("tiling operates per volume: x must be (1, ...)")
        t = self._forward(self.crops(x))
        return self.stitch_volume(t, stitch_mode == "reference")[None]
