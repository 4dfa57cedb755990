"""ClsWiseFormer geometry, behaviour flags, data and training settings for
the PyTorch port.

The port keeps its own copy of the JAX package's ``ModelConfig``,
``DataConfig`` and ``TrainConfig`` (same field names, same derived geometry)
so that it imports nothing of ``dctseg``.  The model defaults differ where
the port serves another configuration of the same network:

  * ``fused_norms`` and ``use_pallas_attention`` default to True: the port's
    serving path runs the two hand-written CUDA kernels
    (``dctseg_torch/ops/fusednorm.py``, ``dctseg_torch/ops/attention.py``).
  * ``s2d_fullres`` / ``s2d_halfres`` default to False: the direct UNet
    path.  Space-to-depth is an exact weight-space transform of the same
    function; the train driver turns it on, as the JAX driver does.
  * ``compute_dtype`` defaults to bfloat16 (serving); ``remat`` to False.

``quantize`` takes the JAX package's spec (``dctseg_torch/ops/quant.py``
``enabled``); a misspelt one fails here with its ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


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
        if self.remat_policy not in ("full", "save_convs"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; "
                             "expected 'full' or 'save_convs'")
        if self.conv3_strategy not in ("dense", "fine", "auto"):
            raise ValueError(
                f"unknown conv3_strategy {self.conv3_strategy!r}")
        from dctseg_torch.ops.quant import enabled
        enabled(self.quantize, "conv3")     # ValueError on a bad spec


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """BraTS data pipeline settings (field names and defaults as in the JAX
    package's ``DataConfig``)."""
    root: str = ""
    train_file: str = "train.txt"
    valid_file: str = "valid.txt"
    input_shape: Tuple[int, int, int] = (240, 240, 155)  # raw NIfTI volume
    pad_depth: int = 160            # pad 155 -> 160 before cropping
    crop_size: Tuple[int, int, int] = (128, 128, 128)
    modalities: Tuple[str, ...] = ("flair", "t1", "t1ce", "t2")
    drop_modal: bool = False        # random modality dropout at load time
    # modality indices forced absent on every sample (deterministic
    # missing-modality evaluation)
    missing_modalities: Tuple[int, ...] = ()
    augment_flip: bool = False      # random axis flips (image+target+edge)
    augment_intensity: float = 0.0  # per-channel scale/shift jitter amount
    num_workers: int = 8            # loader threads of the training loop
    prefetch: int = 2               # batches each loader thread runs ahead
    seed: int = 1000
    synthetic_num_samples: int = 8  # used when root == '' (synthetic data)
    # valid/full synthetic volumes come from seeds disjoint from training's
    synthetic_valid_seed_offset: int = 10000
    synthetic_hardness: str = "simple"  # 'simple' | 'hard'
    # preprocessed-volume cache: NIfTI decoded once into mmap-able .npy plus
    # the z-score statistics
    cache_dir: str = ""
    # dtype of the image tensors the loader hands over: "bfloat16" halves
    # the host-to-device bytes and is bit-identical for bf16-compute models
    # (the model casts its input to bf16 first); "float32" for fp32 runs
    transfer_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop settings (field names and defaults as in the JAX
    package's ``TrainConfig``)."""
    lr: float = 2e-4
    weight_decay: float = 1e-5
    amsgrad: bool = True
    criterion: str = "softmax_dice"
    start_epoch: int = 0
    end_epoch: int = 1000
    save_freq: int = 50
    seed: int = 1000
    batch_size: int = 1
    poly_power: float = 0.9
    # the reference's amp driver restarts the poly schedule past this epoch
    amp_lr_restart_epoch: Optional[int] = None
    resume: str = ""                 # checkpoint directory to resume from
    checkpoint_dir: str = "checkpoints"
    experiment: str = "clswiseformer_tpu"
    # the processes of the group (one per GPU); None takes them all, a
    # number is checked against them (parallel/mesh.py make_mesh)
    num_devices: Optional[int] = None
    # consecutive ranks sharing each sample's D axis (the mesh's space axis;
    # the batch scales with the data axis, world / spatial_shards)
    spatial_shards: int = 1
    log_every: int = 1
    # batches whose host-to-device copy runs ahead on a side stream while
    # the current step runs; 0 copies each batch when its step starts
    device_prefetch: int = 1
    grad_accum: int = 1   # micro-batches per optimizer step
    # on SIGTERM/SIGINT finish the in-flight step, save a full checkpoint
    # (params, optimizer state, step) and return
    preempt_save: bool = True
    # resume restores the optimizer state and epoch too; the default is the
    # reference's params-only resume
    restore_opt: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def tiny_model_config(**overrides: Any) -> ModelConfig:
    """A miniature model for unit tests (float32, like the JAX package's
    ``tiny_model_config``)."""
    kw = dict(img_dim=32, base_channels=4, num_heads=8, top_num=8,
              dropout_rate=0.0, attn_dropout_rate=0.0, init_conv_dropout=0.0,
              compute_dtype="float32")
    kw.update(overrides)
    return ModelConfig(**kw)
