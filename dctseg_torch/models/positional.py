"""Positional encodings for routed token sequences (the JAX package's
``dctseg/models/positional.py``).

'fixed' is the reference's quirk: its sinusoid table is indexed by the
batch dimension, so every token receives the position-0 vector
[0, 1, 0, 1, ...] -- a constant bias.  The module keeps the reference's
(max_len, 1, dim) table as the buffer ``pe`` so that reference checkpoints
load with ``strict=True``; its size follows the config's token dim.
'sinusoidal' is the per-token encoding, 'learned' a per-token table.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

REFERENCE_PE_LEN = 1024   # rows of the reference's ExtendFixedPositionalEncoding
LEARNED_PE_LEN = 4096


def sinusoid_table(max_len: int, dim: int) -> np.ndarray:
    pe = np.zeros((max_len, dim), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * (-np.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def reference_pe_buffer(dim: int) -> np.ndarray:
    """The (1024, 1, dim) table of the reference's
    ExtendFixedPositionalEncoding, its ``pe`` buffer."""
    return sinusoid_table(REFERENCE_PE_LEN, dim)[:, None, :]


class PositionalEncoding(nn.Module):
    def __init__(self, pe_type: str, dim: int):
        super().__init__()
        self.pe_type = pe_type
        if pe_type == "learned":
            self.pos_embedding = nn.Parameter(
                torch.zeros(1, LEARNED_PE_LEN, dim))
        else:
            self.register_buffer("pe", torch.from_numpy(
                reference_pe_buffer(dim)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pe_type == "fixed":
            return x + self.pe[0, 0].to(x.dtype)
        if self.pe_type == "sinusoidal":
            return x + self.pe[: x.shape[1], 0].to(x.dtype)
        return x + self.pos_embedding[:, : x.shape[1]].to(x.dtype)
