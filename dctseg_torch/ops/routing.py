"""Top-k token routing: select, and scatter results back (the JAX package's
``dctseg/ops/routing.py``)."""

from __future__ import annotations

from typing import Tuple

import torch


def topk_select(tokens: torch.Tensor, query: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the ``k`` tokens with the highest affinity to ``query``.

    tokens (B, N, P); query (1, 1, P) or (B, 1, P).  Returns (selected
    (B, k, P), indices (B, k)) sorted by descending score.  The scores are
    computed in the promoted dtype of the two (f32 for the f32 class tokens
    against bf16 tokens), as jnp.einsum promotes.
    """
    dt = torch.promote_types(tokens.dtype, query.dtype)
    q = query.to(dt).expand(tokens.shape[0], -1, -1)
    scores = torch.einsum("bop,bnp->bn", q, tokens.to(dt))
    idx = torch.topk(scores, k, dim=1, largest=True, sorted=True).indices
    selected = torch.gather(
        tokens, 1, idx[:, :, None].expand(-1, -1, tokens.shape[-1]))
    return selected, idx


def scatter_update(tokens: torch.Tensor, idx: torch.Tensor,
                   updates: torch.Tensor) -> torch.Tensor:
    """Out-of-place batched scatter: row idx[b, j] of ``tokens[b]`` becomes
    ``updates[b, j]``; other rows keep their value.  tokens (B, N, P),
    idx (B, k) unique per row, updates (B, k, P)."""
    index = idx[:, :, None].expand(-1, -1, tokens.shape[-1])
    return torch.scatter(tokens, 1, index, updates.to(tokens.dtype))
