"""Serving bundles: the inference engines as ``torch.export`` programs, the
weights embedded (the JAX package's ``dctseg/infer/serving.py``).

A bundle pins the program rather than the model code: each stage of the
staged engine (``dctseg_torch/infer/engine.py``: crops -> forward -> stitch;
flips -> forward -> unflip_mean) is exported with the parameters inside and
saved to disk.  A serving host needs torch, the port's operator registrations
and the bundle -- not the model code and not a checkpoint.  The hand-written
kernels are ``dctseg.*`` operators (``dctseg_torch/ops/library.py``), so the
forward program holds them as graph nodes and launches them on the card.

The stages are the live ``Predictor``'s own functions, so a bundle runs the
same operators in the same order as the live engine: on one device its
outputs equal the engine's bit for bit.

Layout on disk::

    bundle/
      MANIFEST.json     format, strategy, shapes, dtypes, device, torch version
      forward.pt2       one saved ExportedProgram per stage (by strategy)
      crops.pt2 / stitch.pt2                 [tiling]
      flips.pt2 / unflip_mean.pt2            [tta]
      crops_flip{0..7}.pt2 / stitch.pt2
        / unflip_mean.pt2                    [tiling_tta]
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dctseg_torch.device import resolve_device
from dctseg_torch.infer.engine import FLIP_COMBOS, Predictor

MANIFEST_NAME = "MANIFEST.json"
_FORMAT = 1
STRATEGIES = ("single", "tta", "tiling", "tiling_tta")


class _Stage(torch.nn.Module):
    """One tensor function as a module, the unit ``torch.export`` takes."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class _Forward(torch.nn.Module):
    """The predictor's forward (the model's decoder softmax), the weights
    its parameters; a folded predictor's folded weights (casts, s2d
    transforms, int8 weights and scales) become the program's constants."""

    def __init__(self, predictor: Predictor):
        super().__init__()
        self.model = predictor.model
        self.run = predictor.model_probs

    def forward(self, x):
        return self.run(x)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _output(ep) -> torch.Tensor:
    """The (fake) output of an exported one-output program."""
    node = next(n for n in ep.graph.nodes if n.op == "output")
    return node.args[0][0].meta["val"]


def _strip_no_ops(ep: torch.export.ExportedProgram) -> None:
    """Take out of a shape-specialised program, in place, the nodes that do
    nothing when it runs: ``torch.export``'s dtype and device assertions
    and casts to the dtype a tensor already has.  Each is one Python call
    per run of the graph, host time the live engine does not pay, and
    together they are a large share of the nodes.  ``ServingBundle``
    checks and casts the program's input before it runs."""
    aten = torch.ops.aten
    graph = ep.graph_module.graph
    output = next(n for n in graph.nodes if n.op == "output")
    for node in list(graph.nodes):
        if node.target is aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is aten.to.dtype and len(node.args) == 2
              and not node.kwargs and output not in node.users
              and getattr(node.args[0].meta.get("val"), "dtype", None)
              == node.args[1]):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    ep.graph_module.recompile()


def _crops_batch(x: torch.Tensor) -> torch.Tensor:
    """(V, 240, 240, >=155, M) -> (8V, 128, 128, 128, M), volume-major."""
    return torch.cat([Predictor.crops(x[v:v + 1])
                      for v in range(x.shape[0])])


def export_bundle(predictor: Predictor, out_dir: str, *,
                  strategy: str = "tiling",
                  input_shape: Optional[Tuple[int, ...]] = None,
                  in_channels: int = 4,
                  input_dtype: torch.dtype = torch.float32,
                  stitch_mode: str = "reference",
                  batch_volumes: int = 1) -> Dict:
    """Export ``predictor``'s ``strategy`` engine to ``out_dir``.

    ``input_shape`` is the spatial (D, H, W) the bundle accepts: (240, 240,
    160) by default for ``tiling`` and ``tiling_tta`` (the BraTS
    sliding-window geometry), required for ``single`` and ``tta``.
    ``batch_volumes=V`` exports a paired bundle: every request carries V
    volumes ``(V, D, H, W, M)`` and the tiling forward runs B=8V (programs
    are shape-specialised, so V is fixed at export).  Only ``tiling`` and
    ``single`` take V > 1; the flip-TTA strategies work per volume.
    The programs are traced on the predictor's device, which the manifest
    records; ``ServingBundle.load`` moves them to another device where
    asked.

    Returns the manifest dict (also written to ``MANIFEST.json``).
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unsupported serving strategy {strategy!r}")
    if stitch_mode not in ("reference", "aligned"):
        raise ValueError(f"unknown stitch_mode {stitch_mode!r}")
    batch_volumes = int(batch_volumes)
    if batch_volumes < 1:
        raise ValueError(f"batch_volumes must be >= 1, got {batch_volumes}")
    if batch_volumes > 1 and strategy not in ("tiling", "single"):
        raise ValueError("batch_volumes>1 is supported for 'tiling' and "
                         f"'single' bundles, not {strategy!r} (flip TTA "
                         "operates per volume)")
    if input_shape is None:
        if strategy not in ("tiling", "tiling_tta"):
            raise ValueError("input_shape (D, H, W) is required for "
                             f"strategy {strategy!r}")
        input_shape = (240, 240, 160)
    input_shape = tuple(int(s) for s in input_shape)
    if strategy in ("tiling", "tiling_tta") and (input_shape[:2] != (240, 240)
                                                 or input_shape[2] < 155):
        raise ValueError("tiling windows are fixed to the BraTS "
                         "240x240x(>=155) geometry (predict.py:40-47), got "
                         f"{input_shape}")
    device = predictor.device

    def ex(module, like):
        """Export ``module`` on an input of ``like``'s shape and dtype."""
        x = torch.empty(like.shape, dtype=like.dtype, device=device)
        with torch.no_grad():
            ep = torch.export.export(module, (x,))
        # the traced input is a placeholder: keep it out of the bundle
        ep.example_inputs = None
        _strip_no_ops(ep)
        return ep

    ref = stitch_mode == "reference"
    vol = torch.empty((batch_volumes, *input_shape, in_channels),
                      dtype=input_dtype, device="meta")
    exported: Dict[str, torch.export.ExportedProgram] = {}
    fwd = _Forward(predictor)
    if strategy == "single":
        exported["forward"] = ex(fwd, vol)
        out = _output(exported["forward"])
    elif strategy == "tta":
        exported["flips"] = ex(_Stage(Predictor.flip_batch), vol)
        exported["forward"] = ex(fwd, _output(exported["flips"]))
        exported["unflip_mean"] = ex(_Stage(Predictor.unflip_mean),
                                     _output(exported["forward"]))
        out = _output(exported["unflip_mean"])
    elif strategy == "tiling":
        # V=1: the per-volume crops and stitch; V>1: their volume-major
        # batches (Predictor.tiled_probs_batch), one B=8V forward a request
        if batch_volumes == 1:
            crops = Predictor.crops

            def stitch(t):
                return Predictor.stitch_volume(t, ref)[None]
        else:
            crops = _crops_batch

            def stitch(t):
                return torch.stack([Predictor.stitch_volume(t[i:i + 8], ref)
                                    for i in range(0, t.shape[0], 8)])
        exported["crops"] = ex(_Stage(crops), vol)
        exported["forward"] = ex(fwd, _output(exported["crops"]))
        exported["stitch"] = ex(_Stage(stitch), _output(exported["forward"]))
        out = _output(exported["stitch"])
    else:
        # tiling_tta (Predictor.tiled_tta_probs): eight crop programs, each
        # with its flip of the 155-slice volume folded in, share one B=8
        # forward and one stitch; unflip_mean unflips the eight stitched
        # tilings and averages their softmaxes
        for i, combo in enumerate(FLIP_COMBOS):
            def crops_flip(x, c=combo):
                xf = x[:, :, :, :155]
                return Predictor.crops(torch.flip(xf, c) if c else xf)
            exported[f"crops_flip{i}"] = ex(_Stage(crops_flip), vol)
        exported["forward"] = ex(fwd, _output(exported["crops_flip0"]))
        exported["stitch"] = ex(
            _Stage(lambda t: Predictor.stitch_volume(t, ref)[None]),
            _output(exported["forward"]))
        sv = _output(exported["stitch"])
        exported["unflip_mean"] = ex(
            _Stage(Predictor.unflip_mean),
            torch.empty((len(FLIP_COMBOS), *sv.shape[1:]), dtype=sv.dtype,
                        device="meta"))
        out = _output(exported["unflip_mean"])

    os.makedirs(out_dir, exist_ok=True)
    manifest = {
        "format": _FORMAT,
        "strategy": strategy,
        "stitch_mode": (stitch_mode
                        if strategy in ("tiling", "tiling_tta") else None),
        "input_shape": list(input_shape),
        "in_channels": in_channels,
        "batch_volumes": batch_volumes,
        "input_dtype": _dtype_name(input_dtype),
        "output_shape": [int(s) for s in out.shape],
        "output_dtype": _dtype_name(out.dtype),
        "programs": {name: f"{name}.pt2" for name in exported},
        "device": device.type,
        "torch_version": torch.__version__,
    }
    for name, ep in exported.items():
        torch.export.save(ep, os.path.join(out_dir, f"{name}.pt2"))
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ServingBundle:
    """A loaded serving bundle; the live ``Predictor``'s numerics.

    ``predict(x)`` maps a ``(V, D, H, W, M)`` volume batch (V from the
    manifest, 1 unless paired) to the strategy's probabilities (decoder
    softmax / double-softmax TTA mean / stitched tiling), as
    ``Predictor.seg_probs`` / ``tta_probs`` / ``tiled_probs_batch`` /
    ``tiled_tta_probs`` give them with the exported weights.  Outputs are
    tensors on the bundle's device.
    """

    def __init__(self, manifest: Dict, programs: Dict,
                 device: torch.device):
        self.manifest = manifest
        self.device = device
        self._p = programs

    @classmethod
    def load(cls, bundle_dir: str, device=None) -> "ServingBundle":
        """Load ``bundle_dir`` onto ``device`` (default: the GPU; raises if
        there is none).  A bundle exported on another device is moved."""
        device = resolve_device(device)
        # the dctseg operators must be registered before a program that
        # calls them is deserialized
        from dctseg_torch.ops import (attention, fusednorm,  # noqa: F401
                                      quant, relayout)
        from torch.export.passes import move_to_device_pass
        with open(os.path.join(bundle_dir, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        if manifest.get("format") != _FORMAT:
            raise ValueError(f"unsupported bundle format "
                             f"{manifest.get('format')!r}")
        programs = {}
        for name, fname in manifest["programs"].items():
            ep = torch.export.load(os.path.join(bundle_dir, fname))
            if manifest["device"] != device.type:
                ep = move_to_device_pass(ep, device)
            programs[name] = ep.module()
        return cls(manifest, programs, device)

    @property
    def strategy(self) -> str:
        return self.manifest["strategy"]

    def _input(self, x) -> torch.Tensor:
        want = (self.manifest.get("batch_volumes", 1),
                *self.manifest["input_shape"],
                self.manifest["in_channels"])
        if tuple(x.shape) != want:
            raise ValueError(f"bundle expects input shape {want}, got "
                             f"{tuple(x.shape)} (exported programs are "
                             "shape-specialised; re-export for new shapes)")
        if isinstance(x, np.ndarray):   # in native byte order for torch
            x = torch.from_numpy(x.astype(x.dtype.newbyteorder("="),
                                          copy=False))
        return x.to(self.device, getattr(torch, self.manifest["input_dtype"]))

    @torch.inference_mode()
    def predict(self, x) -> torch.Tensor:
        x = self._input(x)
        p, s = self._p, self.strategy
        if s == "single":
            return p["forward"](x)
        if s == "tta":
            return p["unflip_mean"](p["forward"](p["flips"](x)))
        if s == "tiling_tta":
            ys = [p["stitch"](p["forward"](p[f"crops_flip{i}"](x)))
                  for i in range(len(FLIP_COMBOS))]
            return p["unflip_mean"](torch.cat(ys))
        return p["stitch"](p["forward"](p["crops"](x)))

    @torch.inference_mode()
    def labels(self, x) -> torch.Tensor:
        """Argmax segmentation as uint8 (the submission payload)."""
        return torch.argmax(self.predict(x), dim=-1).to(torch.uint8)
