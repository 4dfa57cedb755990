"""FLOPs and parameters of the port's models, and where a forward's time
goes (the JAX package's ``scripts/profile_model.py``).

    python -m dctseg_torch.cli.profile_model                 # ClsWiseFormer
    python -m dctseg_torch.cli.profile_model --model unet    # PlainUnet
    python -m dctseg_torch.cli.profile_model --trace traces  # + one traced
                                                             # forward

The counts come from a trace on fake tensors (nothing runs; the bytes are
an unfused count, ``dctseg_torch/utils/profiling.py``).  ``--trace DIR``
then runs one real forward on ``--device`` under ``torch.profiler``, writes
its Chrome trace into DIR and prints the ops that took the most device
time (CPU time with ``--device cpu``).  Weights are random, from seed 0;
the input is seeded noise.  ClsWiseFormer runs the port's serving
configuration (bf16, fused norms, the attention kernel, the direct UNet
path); PlainUnet the JAX module's defaults (f32, s2d at both
resolutions).
"""

from __future__ import annotations

import argparse

import torch

TOP_OPS = 15


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="clswiseformer",
                   choices=["clswiseformer", "unet"])
    p.add_argument("--img-dim", type=int, default=128)
    p.add_argument("--base-channels", type=int, default=16)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain kernels")
    p.add_argument("--trace", default="", metavar="DIR",
                   help="run one forward under torch.profiler, write its "
                        "trace into DIR and print the time by op")
    return p.parse_args(argv)


def build(a, device) -> torch.nn.Module:
    from dctseg_torch.config import ModelConfig
    from dctseg_torch.models.clswiseformer import build_model
    from dctseg_torch.models.unet import PlainUnet
    gen = torch.Generator().manual_seed(0)
    d = a.img_dim
    if a.model == "clswiseformer":
        return build_model(ModelConfig(
            img_dim=d, base_channels=a.base_channels,
            **({} if d == 128 else {"top_num": min(128, (d // 16) ** 3)})),
            device=device, generator=gen)
    return PlainUnet(base_channels=a.base_channels,
                     generator=gen).to(device).eval()


def time_by_op(prof, device: torch.device, n: int = TOP_OPS) -> list:
    """(op, calls, ms) of the ``n`` ops with the most self time on
    ``device`` (the card's time, or the host's on the CPU)."""
    key = ("self_device_time_total" if device.type == "cuda"
           else "self_cpu_time_total")
    rows = sorted(prof.key_averages(), key=lambda r: -getattr(r, key))
    return [(r.key, r.count, getattr(r, key) / 1e3) for r in rows[:n]]


def main(argv=None) -> dict:
    a = parse_args(argv)
    from dctseg_torch.device import resolve_device
    from dctseg_torch.utils.profiling import (clever_format, profile_model,
                                              trace)
    device = resolve_device(a.device)
    model = build(a, device)
    d = a.img_dim
    x = torch.zeros((a.batch, d, d, d, 4), device=device)
    stats = profile_model(model, x)
    print("FLOPS:", clever_format(stats["flops"]))
    print("Params:", clever_format(stats["params"]), f"({stats['params']})")
    print("Bytes accessed (unfused, every aten op's operands and results):",
          clever_format(stats["bytes_accessed"]))
    if a.trace:
        x = torch.randn(x.shape, generator=torch.Generator().manual_seed(0)
                        ).to(device)
        with torch.inference_mode():
            model(x)        # warm-up: kernel build, plans, cuDNN choices
            with trace(a.trace) as prof:
                model(x)
        where = "device" if device.type == "cuda" else "CPU"
        print(f"Self {where} time by op (ms), one forward:")
        for op, calls, ms in time_by_op(prof, device):
            print(f"  {ms:10.3f}  {calls:6d}  {op}")
    return stats


if __name__ == "__main__":
    main()
