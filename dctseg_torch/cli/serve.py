"""Serve a bundle over HTTP (``dctseg_torch/infer/server.py``):

    python -m dctseg_torch.cli.serve --bundle DIR [--port 8000] ...

The port's ``scripts/serve.py``: loads one exported bundle
(``python -m dctseg_torch.cli.export_serving``) -- programs and embedded
weights, no model code, no checkpoint -- and answers volume -> segmentation
requests.  It serves on the GPU unless given ``--device cpu``.

Example:
  python -m dctseg_torch.cli.export_serving --checkpoint-dir checkpoints \\
      --strategy tiling --out bundles/tiling_bf16
  python -m dctseg_torch.cli.serve --bundle bundles/tiling_bf16 --port 8000

  # client: POST a (240, 240, 160, 4) float .npy, read back uint8 labels
  curl -s --data-binary @volume.npy \\
      'http://127.0.0.1:8000/v1/predict?output=labels&preprocess=1' \\
      -o labels.npy
"""

from __future__ import annotations

import argparse
import logging
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--bundle", required=True,
                   help="bundle directory (from export_serving)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 binds an ephemeral port")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on; 'cpu' runs the plain "
                        "kernels")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the startup warmup predict")
    p.add_argument("--no-coalesce", action="store_true",
                   help="paired bundles (--batch-volumes V at export) "
                        "coalesce concurrent single-volume requests into "
                        "one padded B=8V forward by default; this forces "
                        "whole-group requests instead")
    p.add_argument("--coalesce-wait-ms", type=float, default=50.0,
                   help="how long the coalescer holds the first request "
                        "of a group open for companions")
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    from dctseg_torch.infer.server import serve_bundle
    from dctseg_torch.utils.proctitle import set_process_title
    server = serve_bundle(a.bundle, a.host, a.port, device=a.device,
                          warmup=not a.no_warmup,
                          coalesce=False if a.no_coalesce else None,
                          coalesce_wait_s=a.coalesce_wait_ms / 1e3)
    set_process_title(f"dctseg-serve:{server.port}")
    print(f"listening on http://{server.host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
