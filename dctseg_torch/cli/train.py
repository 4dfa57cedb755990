"""Training CLI of the port (the JAX package's ``scripts/train.py``):

    python -m dctseg_torch.cli.train [--root DIR] [--amp] [--end-epoch N] ...

With no --root it trains on synthetic volumes, so the whole loop runs
anywhere.  It runs on the GPU unless given ``--device cpu``.  The model
runs the JAX driver's training configuration: space-to-depth at both
resolutions with the dense 3^3 strategy, plain norms, the remat rule below,
bf16 compute over float32 parameters with --amp.  Prints the last logged
metrics as one JSON line at the end.

Several GPUs: one process per GPU, each started with the same flags plus
--coordinator HOST:PORT --num-processes N --process-id I (or under
torchrun, which sets MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and
LOCAL_RANK).  The processes form a (data, space) mesh with
--spatial-shards consecutive ranks sharing each sample's D axis; the
global batch is --batch-size times N / --spatial-shards.  NCCL on the GPU,
gloo with --device cpu.

Examples:
  python -m dctseg_torch.cli.train --end-epoch 2            # synthetic
  python -m dctseg_torch.cli.train --device cpu --img-dim 16 \\
      --base-channels 4 --num-samples 2 --input-shape 24 24 20 --end-epoch 1
  torchrun --nproc-per-node 4 -m dctseg_torch.cli.train --spatial-shards 2
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    # dataset
    p.add_argument("--root", default="", help="BraTS root; empty = synthetic")
    p.add_argument("--train-file", default="train.txt")
    p.add_argument("--drop-modal", action="store_true")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--cache-dir", default="",
                   help="preprocessed-volume cache dir (decode NIfTI once)")
    p.add_argument("--num-samples", type=int, default=None,
                   help="synthetic dataset size (no --root only)")
    p.add_argument("--synthetic-hardness", default="simple",
                   choices=["simple", "hard"])
    p.add_argument("--input-shape", type=int, nargs=3, default=None,
                   metavar=("H", "W", "D"),
                   help="raw volume shape (synthetic smoke runs; real "
                        "BraTS is always 240 240 155)")
    p.add_argument("--augment-flip", action="store_true")
    p.add_argument("--augment-intensity", type=float, default=0.0)
    # training
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--weight-decay", type=float, default=1e-5)
    p.add_argument("--criterion", default="softmax_dice")
    p.add_argument("--seed", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("--end-epoch", type=int, default=1000)
    p.add_argument("--save-freq", type=int, default=50)
    p.add_argument("--resume", default="", help="checkpoint dir to resume")
    p.add_argument("--experiment", default="clswiseformer_tpu")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--log-dir", default="logs")
    # multi-GPU: one process per GPU (the reference's
    # torch.distributed.launch shape)
    p.add_argument("--num-devices", type=int, default=None,
                   help="the number of processes, checked against the "
                        "group (default: all of them)")
    p.add_argument("--coordinator", default="",
                   help="rank 0's HOST:PORT (or an init_method URL) for a "
                        "multi-process run; default: MASTER_ADDR and "
                        "MASTER_PORT from the environment")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--spatial-shards", type=int, default=1,
                   help="shard each sample's D axis over this many "
                        "consecutive processes (a data x space mesh; "
                        "halo-exchanged convs)")
    # model
    p.add_argument("--img-dim", type=int, default=128)
    p.add_argument("--base-channels", type=int, default=16)
    p.add_argument("--pe-type", default="fixed",
                   choices=["fixed", "sinusoidal", "learned"])
    p.add_argument("--amp", action="store_true",
                   help="bf16 compute (the reference's amp driver, with its "
                        "LR restart at epoch 249)")
    p.add_argument("--no-amp-lr-quirk", action="store_true",
                   help="with --amp, keep the plain poly schedule")
    p.add_argument("--no-s2d", action="store_true",
                   help="run the UNet's full- and half-resolution stages "
                        "directly instead of on the space-to-depth view")
    p.add_argument("--pallas-attention", action="store_true",
                   help="the attention kernel where dropout is off")
    p.add_argument("--remat-policy", default=None,
                   choices=["full", "save_convs", "none"],
                   help="residual-block rematerialization: 'full' "
                        "recomputes whole blocks, 'save_convs' keeps the "
                        "conv outputs, 'none' keeps everything.  Default: "
                        "'none' for --amp with batch-size 1 and img-dim <= "
                        "128, 'full' otherwise (the JAX driver's rule)")
    p.add_argument("--device-prefetch", type=int, default=1,
                   help="batches whose host-to-device copy runs ahead on a "
                        "side stream (0 = copy when the step starts)")
    p.add_argument("--eval-at-save", action="store_true",
                   help="validate (single patch, no TTA) on the valid split "
                        "at every checkpoint save")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches per optimizer step (the batch size "
                        "must divide evenly)")
    p.add_argument("--restore-opt", action="store_true",
                   help="--resume restores the optimizer state and epoch "
                        "too (default: the reference's params-only resume)")
    p.add_argument("--no-preempt-save", action="store_true",
                   help="no SIGTERM/SIGINT handler saving a full resumable "
                        "checkpoint before exiting")
    return p.parse_args(argv)


def build_config(a):
    from dctseg_torch.config import (Config, DataConfig, ModelConfig,
                                     TrainConfig)
    remat_policy = a.remat_policy or (
        "none" if (a.amp and a.batch_size == 1 and a.img_dim <= 128)
        else "full")
    model = ModelConfig(
        img_dim=a.img_dim, base_channels=a.base_channels, pe_type=a.pe_type,
        compute_dtype="bfloat16" if a.amp else "float32",
        use_pallas_attention=a.pallas_attention, fused_norms=False,
        s2d_fullres=not a.no_s2d, s2d_halfres=not a.no_s2d,
        conv3_strategy="dense", remat=remat_policy != "none",
        remat_policy="full" if remat_policy == "none" else remat_policy,
        **({} if a.img_dim == 128
           else {"top_num": min(128, (a.img_dim // 16) ** 3)}))
    # the crop is the model's input geometry
    geo = {"crop_size": (a.img_dim,) * 3}
    if a.input_shape is not None:
        shape = tuple(a.input_shape)
        geo.update(input_shape=shape, pad_depth=max(shape[2], a.img_dim))
    data = DataConfig(root=a.root, train_file=a.train_file,
                      drop_modal=a.drop_modal, num_workers=a.num_workers,
                      seed=a.seed, cache_dir=a.cache_dir, **geo,
                      transfer_dtype="bfloat16" if a.amp else "float32",
                      synthetic_hardness=a.synthetic_hardness,
                      augment_flip=a.augment_flip,
                      augment_intensity=a.augment_intensity,
                      **({} if a.num_samples is None
                         else {"synthetic_num_samples": a.num_samples}))
    train = TrainConfig(
        lr=a.lr, weight_decay=a.weight_decay, criterion=a.criterion,
        start_epoch=a.start_epoch, end_epoch=a.end_epoch,
        save_freq=a.save_freq, seed=a.seed, batch_size=a.batch_size,
        amp_lr_restart_epoch=(249 if a.amp and not a.no_amp_lr_quirk
                              else None),
        resume=a.resume, checkpoint_dir=a.checkpoint_dir,
        experiment=a.experiment, num_devices=a.num_devices,
        spatial_shards=a.spatial_shards, device_prefetch=a.device_prefetch,
        grad_accum=a.grad_accum, restore_opt=a.restore_opt,
        preempt_save=not a.no_preempt_save)
    return Config(model=model, data=data, train=train)


def main(argv=None):
    """Train; returns (trainer, the last logged metrics)."""
    a = parse_args(argv)
    from dctseg_torch.device import resolve_device
    from dctseg_torch.parallel import distributed
    from dctseg_torch.train.trainer import Trainer
    from dctseg_torch.utils.logging_utils import setup_logging
    from dctseg_torch.utils.proctitle import set_process_title

    # join the process group before anything touches the device (nothing
    # to join for one process)
    device = (distributed.initialize(a.coordinator or None, a.num_processes,
                                     a.process_id, device=a.device)
              or resolve_device(a.device))
    set_process_title("dctseg:train")  # reference train.py:120 'Training!'
    stamp = time.strftime("%Y%m%d_%H%M%S")
    log = setup_logging(os.path.join(a.log_dir,
                                     f"{a.experiment}_{stamp}.txt"))
    for k, v in sorted(vars(a).items()):
        log.info("%s=%s", k, v)
    cfg = build_config(a)
    trainer = Trainer(cfg, device=device)
    log.info("device: %s  mesh: %s  global batch: %d", device,
             trainer.mesh.shape, trainer.global_batch)

    eval_fn = None
    if a.eval_at_save and distributed.is_primary():
        from dctseg_torch.data.brats import BraTSDataset
        from dctseg_torch.data.pipeline import PrefetchLoader
        from dctseg_torch.infer.engine import Predictor
        from dctseg_torch.infer.validate import validate_softmax
        from dctseg_torch.models.clswiseformer import build_model
        vds = BraTSDataset(
            list_file=(a.root and os.path.join(a.root, "valid.txt")),
            root=a.root, mode="valid", cfg=cfg.data)
        predictor = Predictor(build_model(cfg.model, device=device),
                              device=device)

        def eval_fn(tr, epoch):
            predictor.update_params(tr.model.state_dict())
            out = validate_softmax(
                PrefetchLoader(vds, batch_size=1, shuffle=False,
                               num_workers=2),
                predictor, strategy="single", use_hd95=False)
            log.info("eval@%d: WT %.4f TC %.4f ET %.4f", epoch,
                     out["wt"], out["tc"], out["et"])

    return trainer, trainer.fit(eval_fn)


if __name__ == "__main__":
    from dctseg_torch.parallel import distributed
    last = main()[1]
    if distributed.is_primary():
        print(json.dumps(last), flush=True)
    distributed.shutdown()
