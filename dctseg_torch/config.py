"""ClsWiseFormer geometry and behaviour flags for the PyTorch port.

The port keeps its own copy of the JAX package's ``ModelConfig`` (same
field names, same derived geometry) so that it imports nothing of
``dctseg``.  The defaults differ where the port runs another
configuration of the same network:

  * ``fused_norms`` and ``use_pallas_attention`` default to True: the port's
    serving path runs the two hand-written CUDA kernels
    (``dctseg_torch/ops/fusednorm.py``, ``dctseg_torch/ops/attention.py``).
  * ``s2d_fullres`` / ``s2d_halfres`` default to False: the direct UNet
    path.  Space-to-depth is an exact weight-space transform of the same
    function and is not ported yet.
  * ``compute_dtype`` defaults to bfloat16 (serving); ``remat`` to False.

A value whose code is not ported yet raises ``NotImplementedError`` naming
its ``ROADMAP.md`` item.
"""

from __future__ import annotations

import dataclasses
from typing import Any


def _derive(img_dim: int, base_channels: int) -> dict:
    """Derive the ClsWiseFormer geometry from the two free size knobs.

    With img_dim=128, base_channels=16: semantic features 128ch @ 16^3,
    patch (2,2,1) -> 1024 tokens of dim 512; edge features 32ch @ 32^3,
    patch (4,2,2) -> 2048 tokens of dim 512.
    """
    if img_dim % 16:
        raise ValueError(f"img_dim must be divisible by 16, got {img_dim}")
    b0 = base_channels
    sem_ch = 8 * b0
    edge_ch = 2 * b0
    bottleneck_ch = 16 * b0
    sem_size = img_dim // 8
    edge_size = img_dim // 4
    sem_patch = (2, 2, 1)
    edge_patch = (4, 2, 2)
    token_dim = sem_ch * sem_patch[0] * sem_patch[1] * sem_patch[2]
    assert token_dim == edge_ch * edge_patch[0] * edge_patch[1] * edge_patch[2]
    n_sem_tokens = (sem_size // sem_patch[0]) * (sem_size // sem_patch[1]) * (
        sem_size // sem_patch[2])
    n_edge_tokens = (edge_size // edge_patch[0]) * (
        edge_size // edge_patch[1]) * (edge_size // edge_patch[2])
    return dict(
        sem_ch=sem_ch, edge_ch=edge_ch, bottleneck_ch=bottleneck_ch,
        sem_size=sem_size, edge_size=edge_size,
        sem_patch=sem_patch, edge_patch=edge_patch, token_dim=token_dim,
        n_sem_tokens=n_sem_tokens, n_edge_tokens=n_edge_tokens,
    )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """ClsWiseFormer geometry + behaviour flags (field names as in the JAX
    package).  Full width: img_dim=128, base_channels=16, num_heads=8,
    top_num=128, pe_type='fixed' -- 16,824,556 parameters."""
    img_dim: int = 128
    in_channels: int = 4
    num_classes: int = 4
    base_channels: int = 16
    num_heads: int = 8
    top_num: int = 128
    dropout_rate: float = 0.1
    attn_dropout_rate: float = 0.1
    init_conv_dropout: float = 0.2
    # 'fixed' adds the constant row-0 sinusoid [0,1,0,1,...] to every token
    # (the reference's batch-indexed PE quirk); 'sinusoidal' per token;
    # 'learned' a per-token learned table.
    pe_type: str = "fixed"
    norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    use_pallas_attention: bool = True   # hand-written attention kernel
    remat: bool = False
    remat_policy: str = "full"
    fused_norms: bool = True            # hand-written InstanceNorm+act kernel
    s2d_fullres: bool = False
    s2d_halfres: bool = False
    conv3_strategy: str = "dense"
    quantize: str = "none"

    @property
    def geometry(self) -> dict:
        return _derive(self.img_dim, self.base_channels)

    def __post_init__(self):
        g = self.geometry
        if self.top_num > min(g["n_sem_tokens"], g["n_edge_tokens"]):
            raise ValueError(
                f"top_num={self.top_num} exceeds token count "
                f"(sem={g['n_sem_tokens']}, edge={g['n_edge_tokens']})")
        if g["token_dim"] % self.num_heads:
            raise ValueError("token_dim must be divisible by num_heads")
        if self.pe_type not in ("fixed", "sinusoidal", "learned"):
            raise ValueError(f"unknown pe_type {self.pe_type!r}")
        if self.compute_dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.s2d_fullres or self.s2d_halfres:
            raise NotImplementedError(
                "s2d execution strategy is not ported yet (ROADMAP A10)")
        if self.quantize != "none":
            raise NotImplementedError(
                "int8 quantization is not ported yet (ROADMAP A9)")
        if self.remat:
            raise NotImplementedError(
                "remat (training) is not ported yet (ROADMAP A6)")


def tiny_model_config(**overrides: Any) -> ModelConfig:
    """A miniature model for unit tests (float32, like the JAX package's
    ``tiny_model_config``)."""
    kw = dict(img_dim=32, base_channels=4, num_heads=8, top_num=8,
              dropout_rate=0.0, attn_dropout_rate=0.0, init_conv_dropout=0.0,
              compute_dtype="float32")
    kw.update(overrides)
    return ModelConfig(**kw)
