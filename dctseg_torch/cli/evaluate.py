"""Evaluation CLI of the port, covering the reference's test_*.py family:

    python -m dctseg_torch.cli.evaluate [--strategy tiling] [--root DIR] ...

Strategies:
  tta         crop-volume 8-way flip TTA (the primary eval)
  single      single patch, no TTA
  tiling      8-crop sliding window over 240x240x155
  tiling_tta  tiling + flip TTA over tilings
  sweep       flip TTA for every checkpoint of --checkpoint-dir, one row of
              mean dice per checkpoint in <output-dir>/save_pth.csv

--arch swin_unetr evaluates Swin UNETR (MONAI's BraTS 2021 configuration,
``dctseg_torch/models/swin_unetr.py``; ``--feature-size`` narrows it for
smoke runs) in place of ClsWiseFormer, with labels by BRATS21's region
rule, on the tiling or single strategy (flip TTA averages softmaxes and
refuses its region head); its --checkpoint is a MONAI checkpoint.  It
takes none of --quantize, --spatial-shards or --multimodel.

With no --root it evaluates synthetic volumes (dataset-free smoke).  It runs
on the GPU unless given ``--device cpu``.  Its weights: a reference-format
``.pth`` given with ``--checkpoint``; else, unless ``--random-params``, epoch
``--epoch`` (default: the newest) of --checkpoint-dir, as the train driver
saved it (random seeded weights when the directory holds none).  It prints
the mean metrics as one JSON line at the end (per epoch for the sweep).
``--multimodel`` ensembles the newest 4 checkpoints of --checkpoint-dir.

Several GPUs: one process per GPU, each started with the same flags plus
--coordinator HOST:PORT --num-processes N --process-id I (or under
torchrun).  The JAX driver needs none of these, being one process over
many chips; the port runs one process per GPU.  Every process loads every
volume; each forward's crops or flips split over the data axis and each
volume's D axis over --spatial-shards consecutive processes; --quantize
runs there too, each int8 conv's activation scale taken over every
process, as the JAX driver's mesh takes it over the whole tensor.  Only
the primary process scores (K4, K5) and writes the CSV, PNG and NIfTI
output and the JSON line.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="clswiseformer",
                   choices=["clswiseformer", "swin_unetr"])
    p.add_argument("--feature-size", type=int, default=48,
                   help="Swin UNETR's feature size (48 published)")
    p.add_argument("--strategy", default="tta",
                   choices=["tta", "single", "tiling", "tiling_tta",
                            "sweep"])
    p.add_argument("--root", default="")
    p.add_argument("--valid-file", default="valid.txt")
    p.add_argument("--checkpoint", default="",
                   help="reference-format .pth to load (strict); when "
                        "empty, the --checkpoint-dir epoch loads")
    p.add_argument("--checkpoint-dir", default="checkpoints",
                   help="the train driver's checkpoints (model_epoch_*.pth)")
    p.add_argument("--epoch", type=int, default=None,
                   help="checkpoint epoch to load (default: latest)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain kernels")
    p.add_argument("--drop-modal", action="store_true")
    p.add_argument("--missing", default="",
                   help="comma-separated modality names or indices to zero "
                        "out on every volume (missing-modality evaluation), "
                        "e.g. --missing t1ce or --missing 0,2")
    p.add_argument("--cache-dir", default="",
                   help="preprocessed-volume cache dir")
    p.add_argument("--synthetic-hardness", default="simple",
                   choices=["simple", "hard"])
    p.add_argument("--output-dir", default="output")
    p.add_argument("--snapshot", action="store_true", help="PNG slices")
    p.add_argument("--csv", action="store_true", help="per-slice CSV")
    p.add_argument("--save-nifti", action="store_true")
    p.add_argument("--no-hd95", action="store_true")
    p.add_argument("--hd95", default="reference",
                   choices=["reference", "surface"],
                   help="'reference' reproduces the reference's batched-mask "
                        "medpy quirk (its headline HD95 numbers); 'surface' "
                        "is the corrected 3-D surface-distance HD95")
    p.add_argument("--paired", type=int, default=1, metavar="V",
                   help="volumes per forward (any strategy): V volumes' "
                        "crops/flips go through one B=8V forward")
    p.add_argument("--multimodel", action="store_true",
                   help="ensemble over the newest 4 checkpoints")
    p.add_argument("--stitch-mode", default="reference",
                   choices=["reference", "aligned"])
    p.add_argument("--postprocess", action="store_true")
    p.add_argument("--img-dim", type=int, default=128)
    p.add_argument("--base-channels", type=int, default=16)
    p.add_argument("--fp32", action="store_true",
                   help="fp32 compute and wire (default bf16)")
    p.add_argument("--pallas-attention", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="the attention kernel (csrc/attention.cu) in the "
                        "couplers; on by default here, where the JAX "
                        "driver's flag is off by default: "
                        "--no-pallas-attention runs the plain attention")
    p.add_argument("--quantize", default="none",
                   help="int8 post-training quantization spec: 'int8', "
                        "'int8+pw+deconv+down' or 'int8_all' (inference "
                        "only; dctseg_torch/ops/quant.py); with the "
                        "process flags each conv's scale is taken over "
                        "every process")
    p.add_argument("--spatial-shards", type=int, default=1,
                   help="shard each volume's D axis over this many "
                        "consecutive processes; the crops or flips of a "
                        "forward fan out over the rest (data axis)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="the number of processes, checked against the "
                        "group (default: all of them)")
    p.add_argument("--coordinator", default="",
                   help="rank 0's HOST:PORT (or an init_method URL) for a "
                        "multi-process run (one process per GPU; the JAX "
                        "driver, one process over many chips, has no such "
                        "flag); default: MASTER_ADDR and MASTER_PORT")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--random-params", action="store_true",
                   help="skip checkpoint loading (smoke runs)")
    p.add_argument("--num-samples", type=int, default=None,
                   help="synthetic dataset size (no --root only)")
    p.add_argument("--input-shape", type=int, nargs=3, default=None,
                   metavar=("H", "W", "D"),
                   help="raw volume shape (synthetic smoke runs; real "
                        "BraTS is always 240 240 155)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    from dctseg_torch.config import DataConfig, ModelConfig
    from dctseg_torch.convert import load_reference_checkpoint
    from dctseg_torch.data.brats import BraTSDataset
    from dctseg_torch.data.pipeline import PrefetchLoader
    from dctseg_torch.device import resolve_device
    from dctseg_torch.infer.engine import Predictor
    from dctseg_torch.infer.validate import validate_softmax
    from dctseg_torch.models.clswiseformer import build_model
    from dctseg_torch.parallel import distributed
    from dctseg_torch.parallel.mesh import make_mesh
    from dctseg_torch.train.checkpoint import Checkpointer
    from dctseg_torch.utils.export import export_checkpoint_sweep_csv
    from dctseg_torch.utils.logging_utils import setup_logging
    from dctseg_torch.utils.proctitle import set_process_title

    swin = a.arch == "swin_unetr"
    if swin and (a.quantize != "none" or a.spatial_shards > 1
                 or a.multimodel or a.strategy == "sweep"):
        raise ValueError("--arch swin_unetr takes none of --quantize, "
                         "--spatial-shards, --multimodel or --strategy "
                         "sweep")
    if a.strategy == "sweep" and a.random_params:
        raise ValueError("--strategy sweep evaluates the checkpoints of "
                         "--checkpoint-dir; it takes no --random-params")
    device = (distributed.initialize(a.coordinator or None, a.num_processes,
                                     a.process_id, device=a.device)
              or resolve_device(a.device))
    multi_gpu = distributed.world_size() > 1 or a.spatial_shards > 1
    set_process_title("dctseg:test")  # reference test*.py:146 'Testing!'
    log = setup_logging(os.path.join(a.output_dir, "eval.txt"))
    mcfg = ModelConfig(
        img_dim=a.img_dim, base_channels=a.base_channels,
        compute_dtype="float32" if a.fp32 else "bfloat16",
        quantize=a.quantize, use_pallas_attention=a.pallas_attention,
        **({} if a.img_dim == 128
           else {"top_num": min(128, (a.img_dim // 16) ** 3)}))
    if swin:
        from dctseg_torch.models import swin_unetr
        model = swin_unetr.build_model(
            swin_unetr.SwinUNETRConfig(
                feature_size=a.feature_size,
                compute_dtype=mcfg.compute_dtype),
            device=device, generator=torch.Generator().manual_seed(0))
    else:
        model = build_model(mcfg, device=device,
                            generator=torch.Generator().manual_seed(0))
    ckpt = Checkpointer(a.checkpoint_dir)
    if a.random_params:
        log.info("using random params (seed 0)")
    elif a.checkpoint and swin:
        swin_unetr.load_monai_checkpoint(model, a.checkpoint)
        log.info("loaded MONAI checkpoint %s", a.checkpoint)
    elif a.checkpoint:
        load_reference_checkpoint(model, a.checkpoint)
        log.info("loaded checkpoint %s", a.checkpoint)
    elif a.strategy != "sweep":
        epoch = a.epoch if a.epoch is not None else ckpt.latest_epoch()
        if epoch is None:
            log.info("no checkpoint found in %s; using random params",
                     a.checkpoint_dir)
        else:
            model.load_state_dict(ckpt.restore_params(epoch), strict=True)
            log.info("loaded checkpoint epoch %s", epoch)

    names = DataConfig().modalities
    missing = tuple(
        int(tok) if tok.isdigit() else names.index(tok)
        for tok in (t.strip() for t in a.missing.split(",")) if tok)
    geo = {"crop_size": (a.img_dim,) * 3}
    if a.input_shape is not None:
        shape = tuple(a.input_shape)
        if a.strategy in ("tiling", "tiling_tta") and \
                shape != (240, 240, 155):
            raise ValueError("sliding-window tiling windows are fixed to "
                             "the BraTS 240x240x155 geometry")
        geo.update(input_shape=shape, pad_depth=max(shape[2], a.img_dim))
    dcfg = DataConfig(root=a.root, valid_file=a.valid_file,
                      drop_modal=a.drop_modal, missing_modalities=missing,
                      cache_dir=a.cache_dir, **geo,
                      transfer_dtype="float32" if a.fp32 else "bfloat16",
                      synthetic_hardness=a.synthetic_hardness,
                      **({} if a.num_samples is None
                         else {"synthetic_num_samples": a.num_samples}))
    mode = "full" if a.strategy in ("tiling", "tiling_tta") else "valid"
    ds = BraTSDataset(
        list_file=(a.root and os.path.join(a.root, a.valid_file)),
        root=a.root, mode=mode, drop_modal=a.drop_modal, cfg=dcfg)

    def make_loader():
        return PrefetchLoader(ds, batch_size=1, shuffle=False, num_workers=2)

    mesh = None
    if multi_gpu:
        mesh = make_mesh(a.num_devices, spatial=a.spatial_shards)
        log.info("multi-GPU eval mesh: %s", mesh.shape)
    predictor = Predictor(model, device=device, mesh=mesh)
    score = distributed.is_primary()
    log.info("sum===== %d", sum(p.numel() for p in model.parameters()))
    if a.strategy == "sweep":
        csv_path = os.path.join(a.output_dir, "save_pth.csv")
        results = {}
        for epoch in ckpt.all_epochs():
            predictor.update_params(ckpt.restore_params(epoch))
            out = validate_softmax(make_loader(), predictor, "tta",
                                   use_hd95=not a.no_hd95, hd95_mode=a.hd95,
                                   score=score)
            if not score:
                continue
            export_checkpoint_sweep_csv(csv_path, f"epoch_{epoch}",
                                        out["wt"], out["tc"], out["et"])
            results[epoch] = out
            log.info("epoch %s -> WT %.4f TC %.4f ET %.4f", epoch,
                     out["wt"], out["tc"], out["et"])
        return results

    param_sets = None
    if a.multimodel:
        epochs = ckpt.all_epochs()[-4:]
        if not epochs:
            raise FileNotFoundError(f"--multimodel: no checkpoint in "
                                    f"{ckpt.directory}")
        param_sets = [ckpt.restore_params(e) for e in epochs]
        log.info("ensembling %d checkpoints: %s", len(param_sets), epochs)
    return validate_softmax(
        make_loader(), predictor, a.strategy, param_sets=param_sets,
        savepath=os.path.join(a.output_dir, "submission"),
        use_hd95=not a.no_hd95, hd95_mode=a.hd95,
        snapshot=a.snapshot, csv_export=a.csv,
        save_nifti=a.save_nifti, visual=os.path.join(a.output_dir, "visual"),
        stitch_mode=a.stitch_mode, postprocess=a.postprocess,
        paired=a.paired, score=score)


if __name__ == "__main__":
    from dctseg_torch.parallel import distributed
    result = main()
    if distributed.is_primary():
        print(json.dumps(result), flush=True)
    distributed.shutdown()
