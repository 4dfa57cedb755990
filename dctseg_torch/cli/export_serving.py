"""Export a serving bundle (``torch.export`` programs, weights embedded):

    python -m dctseg_torch.cli.export_serving --out DIR [--strategy tiling] ...

The port's ``scripts/export_serving.py``.  The bundle
(``dctseg_torch/infer/serving.py``) holds the model's stages as exported
programs with the hand-written kernels as ``dctseg.*`` operators; a serving
host loads it without the model code or a checkpoint.  It exports on the GPU
unless given ``--device cpu``.  Its weights: unless ``--random-params``,
epoch ``--epoch`` (default: the newest) of --checkpoint-dir, as the train
driver saved it; without one it exits 1.

Examples:
  python -m dctseg_torch.cli.export_serving --checkpoint-dir checkpoints \\
      --strategy tiling --out bundles/tiling_bf16
  python -m dctseg_torch.cli.export_serving --device cpu --random-params \\
      --strategy single --img-dim 32 --base-channels 4 --fp32 \\
      --input-shape 32 32 32 --out bundles/tiny
  python -m dctseg_torch.cli.export_serving --checkpoint-dir checkpoints \\
      --quantize int8 --batch-volumes 2 --out bundles/tiling_int8_v2
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", required=True, help="bundle output directory")
    p.add_argument("--strategy", default="tiling",
                   choices=["single", "tta", "tiling", "tiling_tta"])
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--epoch", type=int, default=None,
                   help="checkpoint epoch to embed (default: latest)")
    p.add_argument("--random-params", action="store_true",
                   help="skip checkpoint loading (smoke runs)")
    p.add_argument("--img-dim", type=int, default=128)
    p.add_argument("--base-channels", type=int, default=16)
    p.add_argument("--fp32", action="store_true",
                   help="fp32 compute (default bf16, the eval default)")
    p.add_argument("--quantize", default="none",
                   help="int8 post-training quantization spec ('int8', "
                        "'int8_all', ...): the bundle runs the int8 kernels")
    p.add_argument("--input-shape", type=int, nargs=3, default=None,
                   metavar=("D", "H", "W"),
                   help="volume spatial shape the bundle accepts "
                        "(default: 240 240 160 for tiling; required for "
                        "single/tta)")
    p.add_argument("--input-dtype", default="float32",
                   choices=["float32", "float16"],
                   help="wire dtype the bundle accepts; float16 halves the "
                        "bytes of a request and is cast to the compute "
                        "dtype at the model's first op")
    p.add_argument("--batch-volumes", type=int, default=1,
                   help="volumes per request (paired bundle): the tiling "
                        "forward runs B=8V per request. tiling/single only")
    p.add_argument("--stitch-mode", default="reference",
                   choices=["reference", "aligned"])
    p.add_argument("--device", default="cuda",
                   help="torch device to export on; 'cpu' runs the plain "
                        "kernels")
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    from dctseg_torch.config import ModelConfig
    from dctseg_torch.device import resolve_device
    from dctseg_torch.infer.engine import Predictor
    from dctseg_torch.infer.serving import export_bundle
    from dctseg_torch.models.clswiseformer import build_model
    from dctseg_torch.train.checkpoint import Checkpointer

    device = resolve_device(a.device)
    mcfg = ModelConfig(
        img_dim=a.img_dim, base_channels=a.base_channels,
        compute_dtype="float32" if a.fp32 else "bfloat16",
        quantize=a.quantize,
        **({} if a.img_dim == 128
           else {"top_num": min(128, (a.img_dim // 16) ** 3)}))
    model = build_model(mcfg, device=device,
                        generator=torch.Generator().manual_seed(0))
    if not a.random_params:
        ckpt = Checkpointer(a.checkpoint_dir)
        epoch = a.epoch if a.epoch is not None else ckpt.latest_epoch()
        if epoch is None:
            print(f"no checkpoint found in {a.checkpoint_dir}; "
                  "pass --random-params to export anyway", file=sys.stderr)
            return 1
        model.load_state_dict(ckpt.restore_params(epoch), strict=True)
        print(f"embedding checkpoint epoch {epoch}")

    manifest = export_bundle(
        Predictor(model, device=device), a.out, strategy=a.strategy,
        input_shape=tuple(a.input_shape) if a.input_shape else None,
        in_channels=mcfg.in_channels,
        input_dtype=getattr(torch, a.input_dtype),
        stitch_mode=a.stitch_mode, batch_volumes=a.batch_volumes)
    size = sum(os.path.getsize(os.path.join(a.out, f))
               for f in os.listdir(a.out))
    print(f"exported {a.strategy} bundle to {a.out} "
          f"({size / 1e6:.1f} MB, device={manifest['device']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
