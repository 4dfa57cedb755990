"""Evaluation loop: the reference's ``validate_softmax`` engines (the JAX
package's ``dctseg/infer/validate.py``).

One parameterized loop covers the four reference variants:
  strategy='tta'        crop-volume 8-way flip TTA
  strategy='single'     single patch, no TTA
  strategy='tiling'     8-crop sliding window over 240x240x155
  strategy='tiling_tta' tiling + flip TTA over tilings

Returns the mean (WT, TC, ET) Dice, mIoU and HD95 and logs them per volume.

Labels come from the probabilities by the model's head (its ``head``
attribute, 'softmax' where it has none): the argmax of ClsWiseFormer's
class softmax, or BRATS21 ``test.py``'s rule on Swin UNETR's region
sigmoids (``models/swin_unetr.py`` ``region_labels``).  Flip TTA averages
softmaxes, so the TTA strategies refuse a region head.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dctseg_torch import metrics
from dctseg_torch.infer.engine import Predictor, ensemble_probs
from dctseg_torch.models.swin_unetr import region_labels
from dctseg_torch.utils import export
from dctseg_torch.utils.logging_utils import LOGGER

logger = logging.getLogger(LOGGER)


def postprocess_device(o: torch.Tensor) -> torch.Tensor:
    """Device twin of the host ET-suppression heuristic (the reference's
    commented ``np.sum(o) < 500 -> o*0``): the identical integer edit, so
    device metrics stay usable under ``postprocess``."""
    et = o == 3
    return torch.where(et & (et.sum() < 500), torch.ones_like(o), o)


HEADS = ("softmax", "regions")


def head_of(model) -> str:
    """The model's output head: 'softmax' (class probabilities, the
    default) or 'regions' (TC, WT, ET sigmoids)."""
    head = getattr(model, "head", "softmax")
    if head not in HEADS:
        raise ValueError(f"unknown head {head!r}; expected one of {HEADS}")
    return head


def labels_of(probs: torch.Tensor, head: str = "softmax") -> torch.Tensor:
    """uint8 labels {0, 1, 2, 3} of (..., C) probabilities: the argmax for
    a softmax head, BRATS21's region rule for a region head."""
    if head == "regions":
        return region_labels(probs)
    return torch.argmax(probs, dim=-1).to(torch.uint8)


def validate_softmax(
        loader,
        predictor: Predictor,
        strategy: str = "tta",
        savepath: str = "",
        use_hd95: bool = True,
        snapshot: bool = False,
        csv_export: bool = False,
        save_nifti: bool = False,
        visual: str = "",
        param_sets: Optional[Sequence] = None,
        stitch_mode: str = "reference",
        postprocess: bool = False,
        device_metrics: bool = True,
        hd95_mode: str = "reference",
        paired: int = 1,
        score: bool = True,
) -> Dict[str, float]:
    """``hd95_mode``: 'reference' reproduces the reference's batched-mask
    medpy quirk (its headline numbers); 'surface' is the corrected 3-D
    surface-distance HD95 (see :func:`dctseg_torch.metrics.cal_hausdorff`).

    ``paired``: volumes per forward.  ``paired=V`` groups V volumes into one
    forward (B=8V for the tiling and TTA engines), with a smaller remainder
    group at the end.  ``param_sets``: state_dicts to ensemble over.
    ``device_metrics``: Dice/mIoU/HD95 on the predictor's device
    (:class:`~dctseg_torch.metrics.DeviceMetrics`), or on the host.

    ``score=False`` runs the forwards only and returns {}: the other ranks
    of a multi-GPU predictor, whose primary scores and writes the
    outputs."""
    if hd95_mode not in ("reference", "surface"):
        raise ValueError(f"hd95_mode must be 'reference' or 'surface', "
                         f"got {hd95_mode!r}")
    paired = max(1, int(paired))
    head = head_of(predictor.model)
    if head == "regions" and strategy in ("tta", "tiling_tta"):
        raise ValueError(f"strategy {strategy!r} averages flipped softmaxes; "
                         "a region head (Swin UNETR) takes 'tiling' or "
                         "'single'")
    batched_call_shape = hd95_mode == "reference"
    wt, tc, et = [], [], []
    h_wt, h_tc, h_et = [], [], []
    m_wt, m_tc, m_et = [], [], []
    runtimes = []
    summary_rows = []
    n_total = len(loader)
    dmetrics = (metrics.DeviceMetrics(batched_call_shape=batched_call_shape,
                                      use_hd95=use_hd95,
                                      device=predictor.device)
                if device_metrics and score else None)

    def run(x):
        if strategy == "tta":
            return predictor.tta_probs_batch(x)
        if strategy == "single":
            return predictor.seg_probs(x)
        if strategy == "tiling":
            return predictor.tiled_probs_batch(x, stitch_mode)
        if strategy == "tiling_tta":
            return predictor.tiled_tta_probs(x, stitch_mode)
        raise ValueError(f"unknown strategy {strategy!r}")

    def predict(batches) -> torch.Tensor:
        """One forward over a group of volumes; returns the uint8 labels
        (V, ...) on the device, not yet waited for.  The labels are made on
        the device, so the host fetches labels, not probabilities."""
        x = (torch.cat([b.x for b in batches]) if len(batches) > 1
             else batches[0].x)
        if param_sets:
            probs = ensemble_probs(lambda: run(x), predictor, param_sets)
        else:
            probs = run(x)
        return labels_of(probs, head)

    def stream():
        """Group-of-``paired`` pipeline: group i+1 is queued on the device
        before the host fetches and scores group i (CUDA launches are
        asynchronous).  Ensembling swaps weights between forwards, so it
        stays sequential.  Each item carries its group's dispatch time and
        size, so per-volume runtimes stay a faithful mean."""
        pipelined = not param_sets

        def dispatch(group):
            t0 = time.time()
            out = predict(group)
            if not pipelined:
                out = out.cpu()
            return [(b, out[j:j + 1], t0, len(group))
                    for j, b in enumerate(group)]

        pending, group = [], []
        for batch in loader:
            group.append(batch)
            if len(group) == paired:
                items = dispatch(group)
                group = []
                yield from pending
                pending = items
        if group:  # remainder group smaller than ``paired``
            items = dispatch(group)
            yield from pending
            pending = items
        yield from pending

    for i, (batch, out_dev, t0, vshare) in enumerate(stream()):
        if not score:
            continue
        name = batch.names[0]
        output = out_dev[0].cpu().numpy().astype(np.int32)
        # t0 is taken at dispatch and the result fetched one group later, so
        # each per-volume runtime folds in the overlapped host work and an
        # equal share of its group: exact as a mean over the run
        runtimes.append((time.time() - t0) / vshare)

        target = batch.target[0]
        if strategy in ("tiling", "tiling_tta"):
            target = target[..., :155]
        if postprocess and (output == 3).sum() < 500:
            output = np.where(output == 3, 1, output)

        if dmetrics is not None:
            md = dmetrics(postprocess_device(out_dev[0]) if postprocess
                          else out_dev[0], target)
            soft, miou, haus = md["dice"], md["miou"], md["hd95"]
        else:
            soft = metrics.softmax_output_dice(output, target)
            miou = metrics.softmax_output_miou(output, target)
            haus = (metrics.cal_hausdorff(output, target,
                                          batched_call_shape)
                    if use_hd95 else [0.0, 0.0, 0.0])
        wt.append(soft[0]); tc.append(soft[1]); et.append(soft[2])
        m_wt.append(miou[0]); m_tc.append(miou[1]); m_et.append(miou[2])
        h_wt.append(haus[0]); h_tc.append(haus[1]); h_et.append(haus[2])

        counts = [int((output == c).sum()) for c in range(4)]
        logger.info("name:%s, Subject %d/%d, DICE= WT:%.4f,TC:%.4f,ET:%.4f",
                    name, i + 1, n_total, *soft)
        logger.info("name:%s, MIOU= WT:%.4f,TC:%.4f,ET:%.4f", name, *miou)
        logger.info("name:%s, HAUSDORFF= WT:%.4f,TC:%.4f,ET:%.4f",
                    name, *haus)
        logger.info("pred counts 0..3: %s  (%.2fs/volume, pipelined "
                    "dispatch-to-fetch)", counts, runtimes[-1])

        if csv_export and visual:
            export.export_per_slice_csv(visual, name, output, target)
            summary_rows.append({
                "name": name, "wt": soft[0], "tc": soft[1], "et": soft[2],
                "sum": soft[0] * soft[1] * soft[2],
                "pre_1": counts[1], "pre_2": counts[2], "pre_4": counts[3],
                "gt_1": int((target == 1).sum()),
                "gt_2": int((target == 2).sum()),
                "gt_4": int((target == 3).sum())})
        if snapshot and visual:
            export.export_png_slices(visual, name, output, target)
        if save_nifti and savepath:
            # carry the source affine, and re-embed crop-strategy
            # predictions into the source geometry, so every strategy
            # writes a submission-shaped volume
            seg = output
            src, org = batch.source_shapes[0], batch.crop_origins[0]
            if (src is not None and org is not None
                    and tuple(src) != seg.shape):
                full = np.zeros(tuple(src), seg.dtype)
                ends = [min(o + c, s) for o, c, s
                        in zip(org, seg.shape, src)]
                full[tuple(slice(o, e) for o, e in zip(org, ends))] = \
                    seg[tuple(slice(0, e - o) for o, e in zip(org, ends))]
                seg = full
            export.export_nifti_segmentation(
                os.path.join(savepath, f"{name}.nii.gz"), seg,
                affine=batch.affines[0])

    if not score:
        return {}
    if summary_rows:
        export.export_volume_summary_csv(
            os.path.join(visual, "sum.csv"), summary_rows)
    out = {
        "wt": float(np.mean(wt)), "tc": float(np.mean(tc)),
        "et": float(np.mean(et)),
        "hd95_wt": float(np.mean(h_wt)), "hd95_tc": float(np.mean(h_tc)),
        "hd95_et": float(np.mean(h_et)),
        "miou_wt": float(np.mean(m_wt)), "miou_tc": float(np.mean(m_tc)),
        "miou_et": float(np.mean(m_et)),
        "sec_per_volume": float(np.mean(runtimes)) if runtimes else 0.0,
    }
    logger.info("WT Dice: %.4f | TC Dice: %.4f | ET Dice: %.4f",
                out["wt"], out["tc"], out["et"])
    logger.info("HD95 WT: %.4f | TC: %.4f | ET: %.4f",
                out["hd95_wt"], out["hd95_tc"], out["hd95_et"])
    logger.info("MIOU WT: %.4f | TC: %.4f | ET: %.4f",
                out["miou_wt"], out["miou_tc"], out["miou_et"])
    return out
