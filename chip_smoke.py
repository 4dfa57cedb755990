"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--only swin]

``--only swin`` runs phases 1, 2 and the Swin UNETR phase alone.

Phases (any failure raises and the script exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from dctseg_torch/csrc/ (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it: fusednorm (on the route its launch plan
     picks at each width, one launch at the small widths and two at the
     large ones and the s2d views, with two calls bitwise equal, and the
     plan's launches per forward pinned), attention (forward in f32,
     bf16 and f16, contiguous and as strided views of one (B, N, 3, H, D)
     tensor, N2 = N and N2 != N, asserting which of its two kernels ran:
     tensor cores for bf16 and f16, SIMT for f32; and its backward against
     the einsum formulation's gradient), the s2d relayout (torch.equal at
     both UNet call sites, B=1 and B=8, and where vectors narrow, with
     the vector width of the plan the wrapper launched asserted, one
     launch a call, and its gradient), the min-plus
     EDT pass (torch.equal, on the EDTs of synthetic label volumes at
     240x240x155 and 128^3, odd extents and an all-False mask, then single
     passes in both layouts on integer costs at D = 1, 155, 240, 256) and
     the order-statistic kernel in its count mode and its search mode
     (exact, on the pooled distances of those volumes, against
     count_leq_plain and the binary search), the int8 activation quantizer
     K7 on its three routes (torch.equal, f32 and bf16, with exact
     half-way ties planted; the amax route's slot, the absmax alone, then
     from_amax on it), K1's
     fused route and K7's grid route replayed in a CUDA graph on 3 inputs
     (each replay torch.equal to an eager call) and
     the int8 conv K6 (torch.equal against its float64 oracle, f32 and bf16
     out, at every call of one int8 and one int8_all forward on each path,
     recorded, each on its tma route, and on ragged shapes on its mma_sync
     route; the calls per forward pinned in INT8_CONVS), and K1's
     external-statistics variant (two D slabs' sums against the plain sums,
     the slabs normed with their total within K1's bounds of the whole
     tensor's plain norm, a slab's own sums torch.equal to the split
     route; then with absmax slots, each slab's slots torch.equal to the
     max |out| of its output, and a slab's own sums torch.equal, output
     and slots, to the absmax variant's split route);
  4. the main paths at full width (img_dim=128, base_channels=16, random
     seeded weights), each with the launch counters set to 0 just before
     and read just after:
       - serving: fp32 seg_probs on the 8 crops of a volume through the
         kernels vs through the plain path and vs the s2d path, bf16
         tta_probs on one 128^3 volume, the engine's staged copy of host
         volumes to the card (torch.equal to x.to, each input's route
         counted, the caller's volume overwritten at once, tiled_probs of
         a host volume equal staged and fused; the copy's host and device
         ms in turns with the pageable copy), then bf16
         Predictor.tiled_probs on 3
         seeded 240x240x160x4 volumes, on the direct path and on the s2d
         path (its 13 attention calls per volume on the tensor-core
         kernel), then one B=8 bf16 forward under torch.profiler for the
         fusednorm kernel's device time in context (its launches checked
         against the plan's, and no norm input copied around it); then
         int8 tiled_probs (quantize='int8') on both paths in turns with
         the float engine on the same weights and volumes: K6 and K7
         launches per forward as pinned, finite probabilities summing to
         one, the drift within INT8_DRIFT (JAX's bounds on the direct
         path), one int8_all forward's launches, and
         Predictor(fold_params=True) equal to the unfolded engine bit for
         bit;
       - fused dispatch: Predictor(fuse_dispatch=True) (crops and the B=8
         forward as one captured CUDA graph) on the direct and s2d paths,
         float and int8: each of the 3 volumes replayed (the first again
         after the others) and held torch.equal to the staged engine's
         eager tiled_probs, the replays launching nothing from Python, one
         profiled replay running the same port kernels as one profiled
         eager call (K1's fused route and, under int8, K7's grid route
         among them) and the eager call as many as its launch counters
         say; both engines timed in turns over 2 rounds of the volumes
         (median, spread, idle share, peak memory); fused flip TTA equal
         to staged, and replays after update_params equal to the eager
         forward under the new weights; fold_params with fuse_dispatch on
         direct int8 likewise;
       - A8: one float B=8 forward on each path under torch.profiler: the
         top ops and kernels by device time against the busy time, where
         the aten::copy_ calls come from (by op, and by line of the port
         from one more forward under a dispatch mode), layout-transform
         kernels and conv-bias adds; then profile_model at full width on
         fake tensors on the card (parameters and flops pinned);
       - evaluation: DeviceMetrics on the card against the host scipy
         metrics (exact) on 2 synthetic 128^3 label pairs in both HD95
         modes, then the evaluate CLI (dctseg_torch.cli.evaluate:
         BraTSDataset, PrefetchLoader, validate_softmax with
         strategy='tiling' and hd95 'reference', DeviceMetrics; the 13
         attention calls per volume on the tensor-core kernel) over 2
         synthetic 240x240x155 volumes in bf16, then again with
         --quantize int8 (K6 and K7 launches asserted);
       - training: the train CLI (dctseg_torch.cli.train: bf16, B=1, s2d
         at both resolutions, synthetic data) for 6 steps at full width,
         with remat off (checked: finite loss, changed parameters, the
         relayout kernel's launches, a checkpoint that loads strictly),
         then with remat 'full' and on the direct path, for step time and
         peak memory, then once more on each of the s2d and direct paths
         with the last steps under torch.profiler, for the card's busy time
         per step and the ops that take it;
       - multi-GPU (phase 4e): parallel_train, the train driver joined to a
         process group of one over NCCL (DDP all-reducing every step)
         against the same seed's run without a group, per-step losses
         equal; spatial_forward, tiled_probs of one volume over (data=1,
         space=2), two ranks of the one card over gloo (NCCL takes no two
         ranks on one device), against the unsharded engine in bf16 and
         fp32 (K1's external-statistics launches, each rank's peak memory,
         ms a volume, every collective timed apart); spatial_int8, int8
         tiled_probs of one volume over (data=1, space=2) and (data=2,
         space=1) on the same two ranks (every rank's K1, K6 and K7
         launches as the mesh's plan, K7 on its amax route where the
         unsharded forward takes its grid route, no plain version run,
         every K7 call's stats equal over the ranks, the drift from the
         unsharded int8 engine within INT8_DRIFT, the scale's MAX
         all-reduces timed apart); spatial_train, the s2d
         B=1 step over the same mesh in f32 and bf16, its gradients per
         parameter group against one rank's unsharded step on the same
         routings; then the explicit conv VJP (A10) against autograd at
         the s2d full-resolution conv;
       - serving bundles (phase 4d): a bf16 ``tiling`` bundle exported on
         the card (torch.export, the kernels as dctseg operators) and
         loaded fresh, held to Predictor.tiled_probs on a seeded
         240x240x160x4 volume (probabilities equal bit for bit), with
         each one's device busy time and idle share in one profiled call,
         then served by BundleServer
         on port 0: 3 labels and 1 probs requests over HTTP, each equal to
         the bundle's answer and each launching one forward's kernels;
         an s2d ``single`` bundle at 128^3 exported on the CPU and moved
         to the card at load (2 relayout launches a forward, labels equal
         to seg_probs'); a paired V=2 ``tiling`` bundle that coalesces 2
         concurrent requests into one group, labels equal to the V=1
         bundle's; an int8 ``tiling`` bundle exported on the card, equal
         bit for bit to the live int8 tiled_probs, and one HTTP request
         answered from it;
  5. time the engines, each kernel, its plain version and a PyTorch library
     call that computes the same function (CUDA events; for fusednorm, the
     relayout and the search also the card's own time with the calls
     queued behind a sleep, the relayout's in turns, repeated and on
     buffers that L2 no longer holds; for attention and the EDT under
     torch.profiler), and the host
     scipy HD95 of one volume (host clock); the host time per call that
     the operator registration adds to K1, K2 and K3; the serving
     bundle's export, load and request times; K6 at the s2d full-res
     dense conv and at en3 at B=8 (its route, equal to its plain version,
     beside cuDNN's bf16 conv and torch._int_mm on the im2col) and over
     one int8 forward's calls on each path, K7 likewise, each against its
     bound; K1's external-statistics variant over a space=2 rank's slab
     forward; K7's amax route and K1's external-statistics pair with
     absmax slots at the calls of one rank's int8 slab forward, against
     their bounds;
  5b. Swin UNETR: K8 (shifted-window attention) against its plain version
     at the four stages' B=8 shapes, shifted and unshifted, bf16, and f16
     and D = 32, 64 on small cases (one ulp of the f32 result); K1's
     pre-activation residual route against its plain version on both
     routes; their card times beside their bounds, plain versions and
     library calls (F.scaled_dot_product_attention with a float mask);
     K9 (the encoder's LayerNorms) on each route against its f32 plain
     version at the four stages' B=8 shapes (one ulp), its card time per
     volume beside its byte bound, the plain sequence and F.layer_norm;
     one B=8 forward at the published widths against the benchmark's f32
     reference, its launches (K9's 25 pinned), time (and with the plain
     attention, and with K9's plain versions), device time by kernel
     family, peak memory, and tiled_probs of a volume;
  6. print the kernels' JSON line, then the result line.
The last line of stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import io
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from dctseg_torch import metrics
from dctseg_torch.cli import evaluate, train
from dctseg_torch.config import DataConfig, ModelConfig
from dctseg_torch.data import synthetic
from dctseg_torch.data.brats import BraTSDataset
from dctseg_torch.infer.engine import Predictor
from dctseg_torch.infer.server import BundleServer
from dctseg_torch.infer.serving import ServingBundle, export_bundle
from dctseg_torch.models import attention as attn_model
from dctseg_torch.models import clswiseformer as cwf
from dctseg_torch.models import unet
from dctseg_torch.ops import _build
from dctseg_torch.ops import attention as attn
from dctseg_torch.ops import (edt, fusednorm, layernorm, minplus, orderstats,
                              quant, relayout)
from dctseg_torch.train.trainer import Trainer
from dctseg_torch.utils import profiling

SEED = 0
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core peak
# f32 instructions per second outside the tensor cores: 16,896 FP32 lanes
# x 1.98 GHz (67 TFLOP/s counts an fma as two)
F32_INSTR = 16896 * 1.98e9
FULL = (240, 240, 155)           # a BraTS volume
VALID_SEED = DataConfig().synthetic_valid_seed_offset
EVAL_VOLUMES = 2
EDT_LAUNCHES = 3                 # per volume: both EDTs as one (6, ...) call
ENVELOPE_INSTR = 32              # instructions per element and EDT pass
SEARCH_LAUNCHES = 7              # per volume: fanout 8 at BraTS vmax
# UNet widths of the direct path at img_dim=128 (spatial edge, channels)
NORM_WIDTHS = [(128, 16), (64, 32), (32, 64), (16, 128)]
# calls per B=8 forward at each width: encoder 2 blocks x 2 relu norms,
# decoder 2 blocks x (lrelu norm, lrelu norm + residual)
NORM_CALLS = {"nores": 6, "res": 2}
# the levels (spatial edge) that run on the s2d view on the s2d path
S2D_LEVELS = (128, 64)
# fusednorm launches per B=8 forward on the H100, on either path: the plan
# runs 32^3x64 and 16^3x128 fused (1 launch) in bf16, 16^3x128 only in f32,
# the rest split (2 launches)
NORM_LAUNCHES = {torch.bfloat16: 48, torch.float32: 56}
ATTN_SHAPE = (8, 8, 129, 64)     # B, heads, top_num + 1, head dim
ATTN_CALLS = 13                  # 3 couplers x 4 + the fusion coupler
VOLUME = (1, 240, 240, 160, 4)
N_VOLUMES = 3
# the relayout kernel's two UNet call sites at full width, (shape, in, out),
# as the training step (B=1, bf16 wire) and the serving engine (B=8, f32
# volumes) give them
RELAYOUT_CALLS = {
    "train": {"input_b1": ((1, 128, 128, 128, 4), torch.bfloat16,
                           torch.bfloat16),
              "half_res_b1": ((1, 64, 64, 64, 32), torch.bfloat16,
                              torch.bfloat16)},
    "serve": {"input_b8": ((8, 128, 128, 128, 4), torch.float32,
                           torch.bfloat16),
              "half_res_b8": ((8, 64, 64, 64, 32), torch.bfloat16,
                              torch.bfloat16)}}
RELAYOUT_PER_FORWARD = 2         # both sites, s2d at both resolutions
RELAYOUT_REPEATS = 7             # K3's timed comparison, in turns
BUNDLE_ROUNDS = 3                # phase 4d's timed volumes, engine in turns
# K3's timed calls walk buffers of this many bytes, four times the H100's
# 50 MB L2, so that each reads its input from HBM and writes a cold output
RELAYOUT_ROTATE_BYTES = 200 << 20
TRAIN_SAMPLES = 2
TRAIN_EPOCHS = 3                 # 6 steps of B=1
TRAIN_SHAPE = ("144", "144", "128")
PROFILED_STEPS = 2               # the last steps of a profiled training run
PATHS = {"direct": {}, "s2d": dict(s2d_fullres=True, s2d_halfres=True)}
# quantized convs per forward at full width (K6 calls; K7 calls) by the
# JAX package's rule, direct and s2d (dense conv3),
# under quantize 'int8' and 'int8_all'; held to JAX's count at full width by
# tests/test_torch_quant.py
INT8_CONVS = {("direct", "int8"): 25, ("direct", "int8_all"): 29,
              ("s2d", "int8"): 42, ("s2d", "int8_all"): 52}
# K7 calls per forward by route, one launch each: "from_amax" where a
# fused norm wrote the conv's input and reported its absmax (both convs of
# EnBlock, conv2 of EnBlock2/DeBlock and the next block's conv1 after a
# residual norm), "grid" for the rest, where the three conv_mid_fea_* and
# the three conv_semantic_* share one call each (4 fewer K7 calls than
# K6's); held to the model at full width by tests/test_torch_k7.py
K7_CALLS = {("direct", "int8"): {"from_amax": 14, "grid": 7},
            ("direct", "int8_all"): {"from_amax": 14, "grid": 11},
            ("s2d", "int8"): {"from_amax": 28, "grid": 10},
            ("s2d", "int8_all"): {"from_amax": 28, "grid": 20}}
INT8_TOPS = 1979e12              # H100 SXM dense int8 tensor-core peak
# int8 against float on the same weights: mean |dp| and argmax agreement.
# Direct path: JAX's bounds (tests/test_quant.py:92-94).  The s2d path
# quantizes 42 convs, the full-resolution ones among them, and there JAX's
# own int8 model keeps 96.7-97.2 % of its float model's argmaxes at the
# tiny test weights (tests/test_torch_quant.py holds the port's s2d modules
# to JAX's bit for bit); at full width the kernels' forward kept 97.0 % on
# an H100, and so does the plain versions' forward on one crop, in bf16 and
# in f32 (run_int8_witness), so JAX's 0.98 is not a property of that path
# with random weights, and the check asks 0.96
INT8_DRIFT = {"direct": dict(mean=0.01, agree=0.98),
              "s2d": dict(mean=0.01, agree=0.96)}
# K6's float64 oracle runs at B=1 on inputs of this many voxels and more
INT8_ORACLE_VOXELS = 64 ** 3


def log(**kw):
    print(json.dumps(kw), flush=True)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def norm_launches(dtype, s2d: bool = False, batch: int = 8) -> int:
    """fusednorm launches of one forward, from the kernel's launch plan at
    each call's shape: NORM_CALLS per UNet level, the s2d levels on the
    (edge/2)^3 x 8C view on the s2d path."""
    total = 0
    for edge, c in NORM_WIDTHS:
        shape = ((batch, edge // 2, edge // 2, edge // 2, 8 * c)
                 if s2d and edge in S2D_LEVELS
                 else (batch, edge, edge, edge, c))
        vec = 16 // (torch.finfo(dtype).bits // 8)
        for kind, calls in NORM_CALLS.items():
            total += calls * fusednorm.plan_for(
                shape, dtype, vec, kind == "res", 0).launches
    return total


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int, warmup: int = 2) -> float:
    """The card's time per call of ``fn`` without the host's: the calls
    are queued behind a sleep kernel long enough for the host to enqueue
    them all (0.15 ms of card time a call), then timed back to back with
    CUDA events.  For the kernels launched through the port's own library,
    whose device events torch.profiler does not always report in full."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(300_000 * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, match: str = "", warmup: int = 2) -> float:
    """The card's own time per call of ``fn``: the summed durations of the
    device events (kernels, copies, fills) whose name contains ``match``,
    under torch.profiler, over ``iters`` calls.  Unlike time_ms it leaves
    out the host's time between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and match in e.name)
    if total == 0:
        raise AssertionError(f"the profiler saw no device event '{match}'")
    return total / iters / 1e3


def gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


# ---------------------------------------------------------------- phase 3

def check_norm_plan():
    """The launch plan's fusednorm launches per B=8 forward, on the direct
    and the s2d path, against the counts pinned in NORM_LAUNCHES: a plan
    that changes a route at a main-path width shows here.  Logs each
    variant's plan (plain, absmax: each from its own kernels' occupancy)
    at every main-path bf16 shape."""
    for edge, c in NORM_WIDTHS:
        views = [(8, edge, edge, edge, c)]
        if edge in S2D_LEVELS:
            views.append((8, edge // 2, edge // 2, edge // 2, 8 * c))
        for shape in views:
            for res in (False, True):
                plans = {name: fusednorm.plan_for(shape, torch.bfloat16, 8,
                                                  res, 0, amax)
                         for name, amax in (("plain", False),
                                            ("amax", True))}
                log(check="fusednorm_plan_at", shape=list(shape),
                    residual=res, **{f"{name}_{field}": getattr(plan, field)
                                     for name, plan in plans.items()
                                     for field in ("route", "blocks",
                                                   "rows_per_block",
                                                   "staged")})
    for dt, want in NORM_LAUNCHES.items():
        for s2d in (False, True):
            got = norm_launches(dt, s2d)
            log(check="fusednorm_plan", dtype=str(dt), s2d=s2d,
                launches_per_forward=got, pinned=want, ok=got == want)
            if got != want:
                raise AssertionError(
                    f"fusednorm plan: {got} launches per {dt} forward "
                    f"(s2d={s2d}), pinned {want}")


def norm_within_bounds(got, want, x, fine, act, r):
    """Whether fusednorm's output ``got`` lies within the bounds stated in
    check_fusednorm of the plain version's ``want`` on input ``x`` (fine
    channels ``fine``, residual ``r`` or None): (ok, |got - want|, the
    bound as text, for bf16 the elements only the absolute term admits)."""
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return bool(err.max() <= 1e-4), err, "atol 1e-4", None
    ulps = bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
    tol = "1e-4 + 1 bf16 ulp of the output"
    if r is not None:
        pre = fusednorm.fused_instance_norm_act_plain(x, fine, act=act)
        ulps = ulps + bf16_ulp(pre.float())
        tol += " + 1 of the activation"
    return (bool((err <= 1e-4 + ulps).all()), err, tol,
            int((err > ulps).sum()))


def check_fusednorm(dev, widths, batch=8):
    """Kernel vs plain version at the main path's B=8 shapes (the kernel's
    partition of each sample depends on the batch), on the route its plan
    picks (fused at the small widths, split at the large ones and the s2d
    views; both must occur), with a second call bitwise equal to the first
    (every f32 sum in a fixed order).

    f32: within 1e-4.  The kernel's f32 statistics differ from the plain
    version's in the last bits, so y = x*a + b differs by some delta.
    bf16: within 1e-4 (that delta, as the f32 check bounds it) + one bf16
    ulp of the output, + one ulp of the pre-residual activation where there
    is a residual.  Rounding to nearest is monotone and the activations are
    1-Lipschitz, so the two casts of act(y) differ by at most delta + one
    ulp; the bf16 residual add rounds once more at the output's magnitude.
    Near zero an ulp is smaller than delta, hence the absolute term.
    Returns the largest bf16 error at the main path's widths."""
    g = gen(dev, SEED)
    cases = []
    for edge, c in widths:
        shape = (batch, edge, edge, edge, c)
        cases += [(shape, c, "relu", False), (shape, c, "lrelu", True)]
    # the s2d views (8 offsets per fine channel) of the two s2d levels, and
    # two layouts the 16-byte vector path does not take
    cases += [((batch, 64, 64, 64, 128), 16, "relu", False),
              ((batch, 32, 32, 32, 256), 32, "lrelu", True),
              ((batch, 16, 16, 16, 128), 16, "lrelu", True),
              ((batch, 8, 8, 8, 24), 3, "none", True),
              ((batch, 8, 8, 8, 12), 12, "relu", False)]
    worst_bf16, routes = 0.0, set()
    for shape, fine, act, with_res in cases:
        x32 = torch.randn(shape, device=dev, generator=g) * 3 + 1
        r32 = torch.randn(shape, device=dev, generator=g)
        for dt in (torch.float32, torch.bfloat16):
            x, r = x32.to(dt), (r32.to(dt) if with_res else None)
            want = fusednorm.fused_instance_norm_act_plain(x, fine, act=act,
                                                           residual=r)
            vec = fusednorm.vector_width(x)
            route = fusednorm.plan_for(shape, dt, vec, with_res, 0).route
            routes.add(route)
            before = fusednorm.fused_instance_norm_act.launches
            got = fusednorm.fused_instance_norm_act(x, fine, act=act,
                                                    residual=r)
            launched = fusednorm.fused_instance_norm_act.launches - before
            again = fusednorm.fused_instance_norm_act(x, fine, act=act,
                                                      residual=r)
            bitwise = torch.equal(got, again)
            ok, err, tol, over_ulps = norm_within_bounds(got, want, x, fine,
                                                         act, r)
            if (dt == torch.bfloat16 and shape[-1] == fine
                    and shape[1:] != (8, 8, 8, 12)):
                worst_bf16 = max(worst_bf16, err.max().item())
            ok = ok and bitwise and launched == (1 if route == "fused"
                                                 else 2)
            log(check="fusednorm", shape=list(shape), fine=fine, act=act,
                residual=with_res, dtype=str(dt), route=route,
                launches=launched, max_abs_err=err.max().item(),
                differing=(err > 0).float().mean().item(),
                over_ulps=over_ulps, bitwise_repeat=bitwise, tol=tol, ok=ok)
            if not ok:
                raise AssertionError(
                    f"fusednorm kernel disagrees: {shape} {fine} {act} "
                    f"{with_res} {dt} {route}")
            del got, again, err
    if routes != {"fused", "split"}:
        raise AssertionError(f"fusednorm checked on routes {routes} only")
    torch.cuda.synchronize()
    return worst_bf16


def attention_inputs(dev, g, shp, dt, strided):
    """q, k, v of shape (B, H, N, D) / (B, H, N2, D) for ``shp`` = (B, H,
    N, D) or (B, H, N, N2, D): contiguous, or views of one (B, N, 3, H, D)
    tensor as the model's QKV projection gives them."""
    b, h, n, n2, d = shp if len(shp) == 5 else (*shp[:3], shp[2], shp[3])
    if strided:
        qkv = torch.randn((b, max(n, n2), 3, h, d), device=dev,
                          generator=g).to(dt)
        return (qkv[:, :n, 0].transpose(1, 2),
                qkv[:, :n2, 1].transpose(1, 2),
                qkv[:, :n2, 2].transpose(1, 2))
    return (torch.randn((b, h, n, d), device=dev, generator=g).to(dt),
            *(torch.randn((b, h, n2, d), device=dev, generator=g).to(dt)
              for _ in range(2)))


ATTN_SMALL = ((2, 4, 33, 16), (1, 2, 50, 128), (2, 4, 33, 50, 16))


def check_attention(dev, shape=ATTN_SHAPE, others=ATTN_SMALL):
    """Kernel vs plain version: f32 within 1e-5 (TF32 off), bf16 and f16
    within 1e-2, on contiguous inputs and on strided views of one (B, N, 3,
    H, D) tensor (the model's layout), at the main path's shape and
    ``others`` (two small ones and one with N2 != N).  bf16 and f16 must
    go to the tensor-core kernel, f32 to the SIMT kernel.  Returns the
    bf16 error at the main path's shape."""
    g = gen(dev, SEED + 1)
    worst_bf16 = 0.0
    for shp in (shape, *others):
        scale = shp[-1] ** -0.5
        for dt, atol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2),
                         (torch.float16, 1e-2)):
            for strided in (False, True):
                q, k, v = attention_inputs(dev, g, shp, dt, strided)
                before = dict(attn.fused_attention.kernel_launches)
                got = attn.fused_attention(q, k, v, scale)
                kernel = [name for name, c in
                          attn.fused_attention.kernel_launches.items()
                          if c != before[name]]
                want = attn.fused_attention_plain(q, k, v, scale)
                err = (got.float() - want.float()).abs().max().item()
                expected = ["simt"] if dt == torch.float32 else ["mma"]
                ok = err <= atol and kernel == expected
                if shp == shape and dt == torch.bfloat16:
                    worst_bf16 = max(worst_bf16, err)
                log(check="attention", shape=list(shp), dtype=str(dt),
                    strided=strided, kernel=kernel,
                    expected_kernel=expected, max_abs_err=err,
                    tol=f"atol {atol}", ok=ok)
                if not ok:
                    raise AssertionError(f"attention kernel disagrees: {shp} "
                                         f"{dt} strided={strided} {kernel}")
    torch.cuda.synchronize()
    return worst_bf16


def check_attention_backward(dev, shape=ATTN_SHAPE):
    """K2's backward: the gradient through the kernel (whose backward
    recomputes through the einsum formulation) vs the einsum formulation's
    own autograd gradient, f32 within 1e-5 (TF32 off) and bf16 within
    1e-2."""
    g = gen(dev, SEED + 8)
    scale = shape[-1] ** -0.5
    for dt, atol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        q, k, v, go = (torch.randn(shape, device=dev, generator=g).to(dt)
                       for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = attn.fused_attention.launches
        attn.fused_attention(*leaves, scale).backward(go)
        launched = attn.fused_attention.launches - before
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        attn.einsum_attention(*ref, scale).backward(go)
        err = max((a.grad.float() - b.grad.float()).abs().max().item()
                  for a, b in zip(leaves, ref))
        ok = launched == 1 and err <= atol and all(
            bool(torch.isfinite(t.grad).all()) for t in leaves)
        log(check="attention_backward", shape=list(shape), dtype=str(dt),
            max_abs_err=err, tol=f"atol {atol}", ok=ok)
        if not ok:
            raise AssertionError(f"attention backward disagrees: {dt}")
    torch.cuda.synchronize()


def launched_plan(x, out):
    """The launch plan K3's wrapper ran for ``x`` into ``out``: the one it
    cached under that call's key."""
    return relayout._calls[relayout.call_key(x, out)].plan


def check_relayout(dev):
    """K3 vs its plain version, torch.equal, one launch per call, with the
    vector width of the plan the wrapper launched asserted: 16 bytes of
    output at both UNet call sites as the training step (B=1 bf16) and
    the serving engine (B=8, f32 -> bf16 and bf16) give them, and at the
    fp32 model's f32 input; narrower where 2C breaks the 16-byte vector
    (C = 3, 5, 6) or the input starts one element into its buffer.  Then
    the gradient (the kernel's backward vs autograd through the plain
    version)."""
    g = gen(dev, SEED + 9)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(name, *call, 8) for calls in RELAYOUT_CALLS.values()
             for name, call in calls.items()]
    cases += [("input_f32_b1", (1, 128, 128, 128, 4), f32, f32, 4),
              ("rows_20", (1, 2, 40, 8, 16), bf16, bf16, 8),
              ("c3", (2, 6, 8, 10, 3), f32, bf16, 2),
              ("c5", (2, 6, 8, 10, 5), bf16, f32, 2),
              ("c6_f16", (1, 4, 4, 4, 6), torch.float16, bf16, 4),
              ("offset_1", (1, 64, 64, 64, 32), bf16, bf16, 1)]
    for name, shape, idt, odt, vec in cases:
        if name == "offset_1":
            buf = torch.randn(math.prod(shape) + 1, device=dev,
                              generator=g).to(idt)
            x = buf[1:].view(shape)
        else:
            x = torch.randn(shape, device=dev, generator=g).to(idt)
        before = relayout.space_to_depth.launches
        got = relayout.space_to_depth(x, odt)
        launched = relayout.space_to_depth.launches - before
        want = relayout.space_to_depth_plain(x, odt)
        plan = launched_plan(x, got)
        torch.cuda.synchronize()
        ok = (launched == 1 and got.dtype == odt and plan.vec == vec
              and torch.equal(got, want))
        log(check="relayout", case=name, shape=list(shape), dtype_in=str(idt),
            dtype_out=str(odt), plan=plan._asdict(), tol="torch.equal",
            ok=ok)
        if not ok:
            raise AssertionError(f"relayout kernel disagrees: {name} "
                                 f"(vec {plan.vec}, expected {vec}, "
                                 f"{launched} launches)")
        del x, got, want
    x = torch.randn((1, 16, 16, 16, 4), device=dev, generator=g,
                    requires_grad=True)
    ct = torch.randn((1, 8, 8, 8, 32), device=dev, generator=g)
    (relayout.space_to_depth(x, bf16).float() * ct).sum().backward()
    got, x.grad = x.grad, None
    (relayout.space_to_depth_plain(x, bf16).float() * ct).sum().backward()
    ok = torch.equal(got, x.grad)
    log(check="relayout_gradient", tol="torch.equal", ok=ok)
    if not ok:
        raise AssertionError("relayout gradient disagrees")
    return 0.0


@contextlib.contextmanager
def plain_route(module, name, plain_fn):
    """Run ``module.name`` as its plain version inside the block (the
    callers look the kernel wrapper up in the module at call time)."""
    orig = getattr(module, name)
    setattr(module, name, plain_fn)
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def plain_minplus():
    """squared_edt through the plain versions of both pass layouts."""
    with plain_route(minplus, "minplus_pass", minplus.minplus_pass_plain), \
            plain_route(minplus, "minplus_pass_minor",
                        minplus.minplus_pass_minor_plain):
        yield


def synthetic_labels(seed, shape=FULL) -> np.ndarray:
    """The label volume of synthetic sample ``seed`` after the 4 -> 3 remap
    (the dataset's generator call, so its cache serves both)."""
    label = synthetic.make_volume_channels(seed, shape, 4,
                                           hardness="simple")[1]
    return np.where(label == 4, 3, label).astype(np.uint8)


def check_minplus(dev, out_lbl, tgt_lbl):
    """K4: squared_edt through the kernel vs through the plain passes,
    torch.equal.  Cases: the two EDTs of a volume pair as the metric stacks
    them (6, 240, 240, 155), the surfaces of a 128^3 crop, odd extents
    (D = 1, B not a multiple of the 32-column tile, D = 256) and an
    all-False mask, where INF must survive all three passes.  Then single
    passes in both layouts, (A, D, B) and minor-axis (R, D), on integer
    costs at D = 1, 155, 240 and 256."""
    o = metrics.composite_masks(out_lbl)
    t = metrics.composite_masks(tgt_lbl)
    crop = (slice(None), slice(56, 184), slice(56, 184), slice(13, 141))
    g = gen(dev, SEED + 6)
    cases = [("pair", torch.cat([t, o])),
             ("surface_128", edt.surface(t[crop].contiguous())),
             ("d1", torch.rand((2, 1, 7, 5), device=dev, generator=g) < 0.3),
             ("ragged", torch.rand((2, 13, 17, 33), device=dev,
                                   generator=g) < 0.1),
             ("d256", torch.rand((1, 256, 3, 40), device=dev,
                                 generator=g) < 0.05),
             ("all_false", torch.zeros((1, 20, 30, 40), dtype=torch.bool,
                                       device=dev))]
    worst = 0.0
    for name, mask in cases:
        got = edt.squared_edt(mask)
        with plain_minplus():
            want = edt.squared_edt(mask)
        err = (got - want).abs().max().item()
        ok = torch.equal(got, want)
        if name == "all_false":
            ok = ok and bool((got == edt.INF).all())
        worst = max(worst, err)
        log(check="minplus", case=name, shape=list(mask.shape),
            max_abs_err=err, tol="torch.equal", ok=ok)
        if not ok:
            raise AssertionError(f"min-plus kernel disagrees: {name}")
    # single passes on integer costs in [0, 2^24 - 3 * 255^2), as later
    # passes see them: random, heavy ties, sparse zeros in the sentinel and
    # squares (many parabolas meeting at one point), in both layouts
    hi = (1 << 24) - 3 * 255 ** 2
    kinds = {
        "random": lambda s: torch.randint(0, hi, s, device=dev, generator=g),
        "ties": lambda s: torch.randint(0, 3, s, device=dev, generator=g)
        * 977,
        "sparse": lambda s: torch.where(
            torch.rand(s, device=dev, generator=g) < 0.03, 0, int(edt.INF)),
        "squares": lambda s: torch.randint(0, 40, s, device=dev,
                                           generator=g) ** 2}
    for d in (1, 155, 240, 256):
        for kind, make in kinds.items():
            x = make((3, d, 1000)).float()
            xm = make((997, d)).float()
            got = minplus.minplus_pass(x)
            got_m = minplus.minplus_pass_minor(xm)
            want = minplus.minplus_pass_plain(x)
            want_m = minplus.minplus_pass_minor_plain(xm)
            err = max((got - want).abs().max().item(),
                      (got_m - want_m).abs().max().item())
            ok = torch.equal(got, want) and torch.equal(got_m, want_m)
            worst = max(worst, err)
            log(check="minplus_pass", case=kind, d=d, shape=list(x.shape),
                minor_shape=list(xm.shape), max_abs_err=err,
                tol="torch.equal", ok=ok)
            if not ok:
                raise AssertionError(f"min-plus pass disagrees: {kind} {d}")
    return worst


def check_orderstats(dev, pools):
    """K5: the kernel's count mode (count_leq, one launch) vs
    count_leq_plain, and its search mode (masked_order_stats, one launch a
    pass) vs the binary search, exact, on the pooled distances of real
    EDTs (ranks from percentile_ranks) and on small value ranges, one with
    a row length that is not a multiple of 4 (the scalar-load path)."""
    g = np.random.default_rng(SEED + 7)
    cases = list(pools)
    for hi, m in ((5, 3001), (2500, 1 << 20), (195075, 2999)):
        vals = np.where(g.random((3, m)) < 0.4,
                        g.integers(0, hi, (3, m)).astype(np.float64),
                        edt.INF).astype(np.float32)
        n = torch.from_numpy((vals < metrics.VMAX).sum(1))
        cases.append((f"range_{hi}_m{m}", torch.from_numpy(vals).to(dev), n))
    worst = 0.0
    for name, pooled, n in cases:
        ks = metrics.percentile_ranks(n.to(dev))
        cuts = torch.from_numpy(np.concatenate(
            [g.integers(0, 300, (3, 12)), np.full((3, 1), -1.0),
             np.full((3, 1), edt.INF)], 1).astype(np.float32)).to(dev)
        before = (orderstats.count_leq.launches,
                  orderstats.masked_order_stats.launches)
        cnt_ok = torch.equal(orderstats.count_leq(pooled, cuts),
                             orderstats.count_leq_plain(pooled, cuts))
        got = orderstats.masked_order_stats(pooled, ks, metrics.VMAX)
        launched = (orderstats.count_leq.launches - before[0],
                    orderstats.masked_order_stats.launches - before[1])
        want = edt.binary_search_order_stats(pooled, ks, metrics.VMAX)
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        ok = cnt_ok and torch.equal(got, want) and launched == (
            1, SEARCH_LAUNCHES)
        log(check="orderstats", case=name, shape=list(pooled.shape),
            n=n.tolist(), ranks=ks.tolist(), kth=got.tolist(),
            count_equal=cnt_ok, launches=launched, max_abs_err=err,
            tol="exact", ok=ok)
        if not ok:
            raise AssertionError(f"order-statistic kernel disagrees: {name}")
    # a batched (2, 3, M) search runs as one (6, M) search on the kernel
    vals = torch.from_numpy(np.where(
        g.random((2, 3, 4096)) < 0.4,
        g.integers(0, 2500, (2, 3, 4096)).astype(np.float64),
        edt.INF).astype(np.float32)).to(dev)
    ks = torch.from_numpy(g.integers(0, 1000, (2, 3, 2)).astype(np.int32)
                          ).to(dev)
    before = (orderstats.masked_order_stats.launches,
              orderstats.count_leq.launches)
    got = edt.masked_order_stats(vals, ks, metrics.VMAX)
    launched = orderstats.masked_order_stats.launches - before[0]
    ok = (launched, orderstats.count_leq.launches - before[1]) == (
        SEARCH_LAUNCHES, 0) and torch.equal(
        got, edt.binary_search_order_stats(vals, ks, metrics.VMAX))
    log(check="orderstats", case="batched_2x3", shape=list(vals.shape),
        launches=launched, tol="exact", ok=ok)
    if not ok:
        raise AssertionError("batched order-statistic search disagrees or "
                             "did not run on the kernel")
    return worst


# ---------------------------------------------------------------- phase 4

def record_topk(store):
    orig = cwf.topk_select

    def recording(tokens, query, k):
        selected, idx = orig(tokens, query, k)
        store.append(idx.clone())
        return selected, idx
    cwf.topk_select = recording
    return orig


def check_fp32_paths(dev, cfg_kw, weights):
    """seg_probs on the 8 crops of one volume (the main path's B=8 batch),
    fp32 with TF32 off: through the kernels vs through the plain path
    (fused_norms and the attention kernel off), and on the s2d path
    (kernels on) vs the direct path; probs within 1e-3 and the same top-k
    token sets in every routing.  The s2d forward launches the relayout
    kernel twice; both paths launch the norm kernel as its launch plan
    says (norm_launches)."""
    vol = torch.randn(VOLUME, device=dev, generator=gen(dev, SEED + 2))
    x = Predictor.crops(vol)
    del vol
    results = {}
    kernels = dict(fused_norms=True, use_pallas_attention=True)
    for name, flags in (("kernels", kernels),
                        ("plain", dict(fused_norms=False,
                                       use_pallas_attention=False)),
                        ("s2d", dict(kernels, s2d_fullres=True,
                                     s2d_halfres=True))):
        cfg = ModelConfig(compute_dtype="float32", **cfg_kw, **flags)
        model = cwf.build_model(cfg, device=dev)
        model.load_state_dict(weights, strict=True)
        idx = []
        orig = record_topk(idx)
        relayout.space_to_depth.launches = 0
        fusednorm.fused_instance_norm_act.launches = 0
        try:
            probs = Predictor(model, device=dev).seg_probs(x)
        finally:
            cwf.topk_select = orig
        results[name] = (probs, idx, relayout.space_to_depth.launches,
                         fusednorm.fused_instance_norm_act.launches)
        del model
    for a, b in (("kernels", "plain"), ("s2d", "kernels")):
        (pa, ia, k3a, k1a), (pb, ib, _, _) = results[a], results[b]
        err = (pa - pb).abs().max().item()
        differing = [i for i, (u, v) in enumerate(zip(ia, ib))
                     if not torch.equal(u.sort(dim=1).values,
                                        v.sort(dim=1).values)]
        same_sets = not differing and len(ia) == len(ib) == 13
        same_order = all(torch.equal(u, v) for u, v in zip(ia, ib))
        launches = {"relayout": k3a, "fusednorm": k1a}
        expected = {"relayout": RELAYOUT_PER_FORWARD if a == "s2d" else 0,
                    "fusednorm": norm_launches(torch.float32, a == "s2d")}
        ok = (err <= 1e-3 and same_sets and launches == expected
              and bool(torch.isfinite(pa).all()))
        log(check=f"fp32_seg_probs_{a}_vs_{b}", batch=x.shape[0],
            max_abs_err=err, tol="atol 1e-3", same_topk_sets=same_sets,
            differing_routings=differing, same_topk_order=same_order,
            launches=launches, expected_launches=expected, ok=ok)
        if not ok:
            raise AssertionError(f"fp32 {a} path disagrees with {b} path")


def check_tta(predictor, x):
    """bf16 flip TTA on one 128^3 volume: shape, finite, sums to one."""
    out = predictor.tta_probs(x)
    torch.cuda.synchronize()
    dev_sum = (out.sum(-1) - 1).abs().max().item()
    ok = (tuple(out.shape) == (1, 128, 128, 128, 4)
          and bool(torch.isfinite(out).all()) and dev_sum <= 1e-3)
    log(check="bf16_tta_probs", shape=list(out.shape), sum_err=dev_sum,
        ok=ok)
    if not ok:
        raise AssertionError("tta_probs output is malformed")


def run_main_path(predictor, volumes):
    """bf16 tiled_probs on each volume; returns per-volume ms (CUDA events)
    and checks shape, finiteness and sum-to-one."""
    times = []
    for vol in volumes:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = predictor.tiled_probs(vol)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        if tuple(out.shape) != (1, 240, 240, 155, 4):
            raise AssertionError(f"tiled_probs shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("tiled_probs output is not finite")
        dev_sum = (out.sum(-1) - 1).abs().max().item()
        if dev_sum > 1e-3:
            raise AssertionError(f"probs sum off by {dev_sum}")
        del out
    return times


STAGE_TIMED = 10    # check_staged_input's timed calls of each copy


def check_staged_input(dev, model):
    """The engine's copy of a host volume to the card (``Predictor._input``)
    held bit for bit to ``x.to(dev)``: the serving volume and the unpadded
    one (not a multiple of the chunk) staged, a byte tensor under one chunk
    staged, a non-contiguous view on the host route, a pinned volume on the
    pinned route, each counted on its route; the caller's volume
    overwritten as soon as the copy returns, the card's copy unchanged; two
    volumes staged back to back, each whole (the caching host allocator
    may hand the first one's pinned block to the second);
    ``tiled_probs`` of a host volume equal to ``tiled_probs`` of its copy on
    the card, staged and fused.  Then the staged copy and ``x.to(dev)`` in
    turns: host ms of the call, device ms to the last byte (CUDA events),
    the rate."""
    g = torch.Generator().manual_seed(SEED + 17)
    vols = [torch.randn(VOLUME, generator=g) for _ in range(2)]
    cases = {"serving": (vols[0], "staged"),
             "unpadded": (vols[1][:, :, :, :155].contiguous(), "staged"),
             "bytes": (torch.randint(0, 256, (7, 1001), generator=g,
                                     dtype=torch.uint8), "staged"),
             "non_contiguous": (vols[0][:, :, :, :155], "host"),
             "pinned": (vols[1].pin_memory(), "pinned")}
    predictor = Predictor(model, device=dev)
    rows = {}
    for name, (x, route) in cases.items():
        before = dict(predictor.input_routes)
        got = predictor._input(x)
        torch.cuda.synchronize()
        moved = {k: n - before[k] for k, n in predictor.input_routes.items()
                 if n != before[k]}
        rows[name] = (torch.equal(got, x.to(dev))
                      and moved == {route: 1})
    src = vols[0].clone()
    want = src.to(dev)
    got = predictor._input(src)
    src.fill_(float("nan"))
    torch.cuda.synchronize()
    rows["overwritten_at_once"] = torch.equal(got, want)
    first, second = predictor._input(vols[0]), predictor._input(vols[1])
    torch.cuda.synchronize()
    rows["back_to_back"] = (torch.equal(first.cpu(), vols[0])
                            and torch.equal(second.cpu(), vols[1]))
    del first, second, got, want
    eager = predictor.tiled_probs(vols[0].to(dev))
    for fuse in (False, True):
        engine = Predictor(model, device=dev, fuse_dispatch=fuse)
        on_card = engine.tiled_probs(vols[0].to(dev))
        staged = engine.tiled_probs(vols[0])
        rows[f"tiled_probs_{'fused' if fuse else 'staged'}"] = (
            torch.equal(staged, on_card) and torch.equal(staged, eager)
            and engine.input_routes["staged"] == 1)
        del engine, on_card, staged
    del eager
    timed = {"staged": lambda x: predictor._input(x),
             "pageable": lambda x: x.to(dev)}
    host, device = ({k: [] for k in timed} for _ in range(2))
    for i in range(STAGE_TIMED):
        for k in (timed if i % 2 else list(timed)[::-1]):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            timed[k](vols[i % 2])
            host[k].append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            device[k].append(start.elapsed_time(end))
    nbytes = vols[0].numel() * vols[0].element_size()
    ok = all(rows.values())
    log(check="staged_input", ok=ok, cases=rows,
        routes=predictor.input_routes, bytes=nbytes,
        host_ms={k: statistics.median(v) for k, v in host.items()},
        device_ms={k: statistics.median(v) for k, v in device.items()},
        gb_per_s={k: nbytes / statistics.median(v) / 1e6
                  for k, v in device.items()})
    if not ok:
        raise AssertionError(f"staged input differs: {rows}")


def check_device_metrics(dev, pairs):
    """DeviceMetrics on the card vs the host scipy metrics, exact equality,
    in both HD95 modes; pairs of (prediction, target) numpy label
    volumes."""
    for i, (pred, tgt) in enumerate(pairs):
        for bcs in (True, False):
            got = metrics.DeviceMetrics(batched_call_shape=bcs,
                                        device=dev)(pred, tgt)
            want = {"dice": metrics.softmax_output_dice(pred, tgt),
                    "miou": metrics.softmax_output_miou(pred, tgt),
                    "hd95": metrics.cal_hausdorff(pred, tgt, bcs)}
            ok = got == want
            log(check="device_metrics_vs_host", pair=i, shape=list(tgt.shape),
                hd95_mode="reference" if bcs else "surface", got=got,
                host=want, tol="exact", ok=ok)
            if not ok:
                raise AssertionError("DeviceMetrics disagrees with the host")


# every launch counter (ops/_build.py COUNTED), by its function's name
KERNEL_COUNTERS = {fn.__name__: fn for fn in _build.counted_ops()}
# K1's external-statistics variant (with absmax slots under int8): it runs
# only on a space axis
EXT_COUNTERS = ("fused_norm_stats", "fused_norm_apply",
                "fused_norm_stats_amax", "fused_norm_apply_amax")
INT8_COUNTERS = ("fused_instance_norm_act_amax", "int8_conv3d",
                 "quantize_absmax", "quantize_from_amax", "quantize_amax")
# K8 and K9: they run only in Swin UNETR
SWIN_COUNTERS = ("fused_window_attention", "layer_norm_to_windows",
                 "windows_residual_layer_norm", "layer_norm")
# K7's counter of each route: one operator a route (amax runs only over a
# mesh, its slots MAX-reduced over the ranks before from_amax)
K7_COUNTERS = {"grid": "quantize_absmax", "from_amax": "quantize_from_amax",
               "amax": "quantize_amax"}


def reset_launches():
    """Every launch counter, and its counts by kernel or route, to 0."""
    _build.add_launches(_build.launch_counts(), -1)


def read_launches():
    """Each kernel's launches since reset_launches(), and, of attention's,
    those that went to the tensor-core kernel."""
    launches = {k: fn.launches for k, fn in KERNEL_COUNTERS.items()}
    launches["attention_mma"] = attn.fused_attention.kernel_launches["mma"]
    return launches


def run_eval_path(quantize="none", calls=None):
    """The evaluate CLI over EVAL_VOLUMES synthetic 240x240x155 volumes:
    strategy 'tiling', HD95 'reference', bf16, full width, random weights
    from seed 0, quantized as ``quantize`` says.  Returns its result dict
    and the launch counts."""
    reset_launches()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        res = evaluate.main(["--strategy", "tiling", "--hd95", "reference",
                             "--random-params", "--num-samples",
                             str(EVAL_VOLUMES), "--output-dir", out_dir,
                             "--quantize", quantize])
        wall = time.perf_counter() - t0
    launches = read_launches()
    # the search runs in the orderstats kernel's search mode, one launch a
    # pass; its count mode (count_leq) not at all
    expected = {"fused_instance_norm_act": (norm_launches(torch.bfloat16)
                                            * EVAL_VOLUMES),
                "fused_attention": 13 * EVAL_VOLUMES,
                "attention_mma": 13 * EVAL_VOLUMES,
                "space_to_depth": 0,
                "minplus_pass": EDT_LAUNCHES * EVAL_VOLUMES,
                "masked_order_stats": SEARCH_LAUNCHES * EVAL_VOLUMES,
                "count_leq": 0,
                **dict.fromkeys(INT8_COUNTERS + EXT_COUNTERS
                                + SWIN_COUNTERS, 0)}
    if quantize != "none":
        forward = int8_expected(calls, "direct", quantize)
        for k in ("fused_instance_norm_act",) + INT8_COUNTERS:
            expected[k] = forward[k] * EVAL_VOLUMES
    finite = all(math.isfinite(v) for v in res.values())
    in_unit = all(0.0 <= res[k] <= 1.0 for k in
                  ("wt", "tc", "et", "miou_wt", "miou_tc", "miou_et"))
    ok = launches == expected and finite and in_unit
    log(phase="eval_path", entry="dctseg_torch.cli.evaluate",
        strategy="tiling", hd95="reference", dtype="bfloat16",
        quantize=quantize, volumes=EVAL_VOLUMES, result=res, wall_s=wall,
        launches=launches, expected_launches=expected, ok=ok)
    if not ok:
        raise AssertionError(f"eval path failed: launches {launches} "
                             f"(expected {expected}), result {res}")
    return res, launches


def device_busy_ms(prof) -> float:
    """The card's busy time in a profile: the union of the intervals of its
    kernels, copies and fills, in ms (overlapping streams count once)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def top_kernels(prof, n=6):
    """The device events (kernels, copies, fills) that take the most time
    in a profile, by name, ms."""
    total = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total[e.name[:80]] += (e.time_range.end - e.time_range.start) / 1e3
    return dict(total.most_common(n))


def top_device_ops(prof, n=8):
    """The aten ops whose own kernels take the most device time, ms."""
    rows = sorted((r for r in prof.key_averages()
                   if r.key.startswith("aten::")),
                  key=lambda r: -r.self_device_time_total)[:n]
    return {r.key: r.self_device_time_total / 1e3 for r in rows}


def run_train_path(dev, extra, check, profile=False):
    """The train CLI at full width: bf16, B=1, synthetic data, TRAIN_SAMPLES
    volumes of TRAIN_SHAPE for TRAIN_EPOCHS epochs, with ``extra`` flags.
    Each step is timed on the host clock up to a synchronise.  With
    ``check``: the loss is finite, the parameters moved from their seeded
    start, the relayout kernel ran twice per step (and the inference-only
    kernels not at all), and the final checkpoint loads strictly into a
    fresh model and equals the trained parameters.  With ``profile``: the
    last PROFILED_STEPS steps run under torch.profiler (their host times
    are left out of the steady step time), for the card's busy ms per step
    and the ops that take it."""
    times, busy, ops = [], [], {}
    orig = Trainer.train_step
    n_steps = TRAIN_SAMPLES * TRAIN_EPOCHS

    def timed(self, *a):
        prof = None
        if profile and len(times) >= n_steps - PROFILED_STEPS:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
        t0 = time.perf_counter()
        with prof or contextlib.nullcontext():
            out = orig(self, *a)
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if prof is not None:
            busy.append(device_busy_ms(prof))
            for k, v in top_device_ops(prof).items():
                ops[k] = ops.get(k, 0.0) + v / PROFILED_STEPS
        return out
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    Trainer.train_step = timed
    try:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            tr, last = train.main([
                "--amp", "--num-samples", str(TRAIN_SAMPLES),
                "--input-shape", *TRAIN_SHAPE,
                "--end-epoch", str(TRAIN_EPOCHS), "--save-freq", "1000",
                "--num-workers", "2", "--checkpoint-dir", f"{d}/ckpt",
                "--log-dir", f"{d}/logs", *extra])
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            launches = read_launches()
            steps = tr.step
            ok = bool(math.isfinite(last["loss"]))
            if check:
                start = cwf.ClsWiseFormer(
                    tr.cfg.model, torch.Generator().manual_seed(
                        tr.cfg.train.seed)).state_dict()
                trained = {k: v.cpu() for k, v in
                           tr.model.state_dict().items()}
                moved = sum(not torch.equal(start[k], trained[k])
                            for k in start)
                fresh = cwf.build_model(tr.cfg.model, device=dev)
                fresh.load_state_dict(tr.ckpt.restore_params(TRAIN_EPOCHS),
                                      strict=True)
                reloaded = all(torch.equal(v.cpu(), trained[k]) for k, v in
                               fresh.state_dict().items())
                expected = {k: 0 for k in launches}
                expected["space_to_depth"] = RELAYOUT_PER_FORWARD * steps
                finite = all(bool(torch.isfinite(v).all())
                             for v in trained.values())
                ok = (ok and moved > 0 and finite and reloaded
                      and launches == expected
                      and steps == TRAIN_SAMPLES * TRAIN_EPOCHS)
                del fresh
    finally:
        Trainer.train_step = orig
    steady = sorted(times[2:n_steps - PROFILED_STEPS if profile else None])
    row = dict(flags=extra, dtype="bfloat16", batch=1, steps=steps,
               step_ms=times, steady_step_ms=steady[len(steady) // 2],
               peak_memory_bytes=peak, wall_s=wall, loss=last["loss"],
               launches=launches, ok=ok)
    if check:
        row.update(tensors_moved=moved, checkpoint_reloaded=reloaded,
                   expected_launches=expected)
    if profile:
        row.update(profiled_device_busy_ms=busy, top_device_ops_ms=ops)
    log(phase="train_path", entry="dctseg_torch.cli.train", **row)
    if not ok:
        raise AssertionError(f"train path failed: {row}")
    del tr
    return row


# --------------------------------------------------------------- phase 4d

def post_volume(base, vol, output):
    """POST one volume as ``.npy``; returns the answer, the server's
    X-Latency-Ms and the client's wall ms (encode, send, wait, decode)."""
    t0 = time.perf_counter()
    buf = io.BytesIO()
    np.save(buf, vol)
    req = urllib.request.Request(f"{base}/v1/predict?output={output}",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        latency = float(r.headers["X-Latency-Ms"])
        out = np.load(io.BytesIO(r.read()))
    return out, latency, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def serving(bundle, **kw):
    """A BundleServer on an ephemeral port, serving from a thread; yields
    its base URL and stops it (and the thread) on the way out."""
    server = BundleServer(bundle, port=0, **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server, f"http://127.0.0.1:{server.port}"
    finally:
        server.shutdown()
        thread.join(timeout=60)


def bundle_mb(path) -> float:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path)) / 1e6


def expect_launches(what, got, expected):
    sub = {k: got[k] for k in expected}
    if sub != expected:
        raise AssertionError(f"{what}: launches {sub}, expected {expected}")
    return sub


def run_serving_bundles(dev, cfg_kw, weights):
    """Phase 4d, the serving bundles at full width, bf16, the direct path
    with the kernels on: export a ``tiling`` bundle on the card and load it
    fresh; its probabilities against Predictor.tiled_probs on a seeded
    240x240x160x4 volume (probabilities equal bit for bit), and each one's
    device busy time in one profiled call; then a BundleServer on it answers
    3 labels and 1 probs request, each equal to the bundle's own answer,
    with each request's kernel launches those of one forward.  Then a
    ``single`` s2d bundle at 128^3, exported on the CPU and moved to the
    card at load, launches the relayout twice a forward; then a paired V=2
    ``tiling`` bundle coalesces 2 concurrent single-volume requests into
    one group whose labels equal the V=1 bundle's."""
    rng = np.random.default_rng(SEED + 6)
    vols = [rng.standard_normal(VOLUME, dtype=np.float32)
            for _ in range(N_VOLUMES)]
    model = cwf.build_model(ModelConfig(**cfg_kw), device=dev)
    model.load_state_dict(weights, strict=True)
    predictor = Predictor(model, device=dev)
    forward = {"fused_instance_norm_act": norm_launches(torch.bfloat16),
               "fused_attention": ATTN_CALLS, "attention_mma": ATTN_CALLS,
               "space_to_depth": 0}
    row = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tiling")
        t0 = time.perf_counter()
        export_bundle(predictor, path, strategy="tiling")
        row["export_s"] = time.perf_counter() - t0
        row["bundle_mb"] = bundle_mb(path)
        t0 = time.perf_counter()
        bundle = ServingBundle.load(path)
        row["load_s"] = time.perf_counter() - t0
        row["forward_graph_nodes"] = len(bundle._p["forward"].graph.nodes)

        # the bundle against the live engine, and each one's time a volume
        # (host clock to a synchronise, volumes on the card)
        dvols = [torch.from_numpy(v).to(dev) for v in vols]
        reset_launches()
        probs = bundle.predict(dvols[0])
        torch.cuda.synchronize()
        row["predict_launches"] = expect_launches(
            "bundle.predict", read_launches(), forward)
        live = predictor.tiled_probs(dvols[0])
        row["max_abs_dprob"] = (probs - live).abs().max().item()
        row["labels_equal_tiled_probs"] = torch.equal(probs.argmax(-1),
                                                      live.argmax(-1))
        # the same operators in the same order: the same bits
        row["probs_equal_tiled_probs"] = torch.equal(probs, live)
        if not (row["labels_equal_tiled_probs"]
                and row["probs_equal_tiled_probs"]
                and bool(torch.isfinite(probs).all())):
            raise AssertionError(f"bundle vs tiled_probs: {row}")
        del probs, live
        # in turns, BUNDLE_ROUNDS over the volumes
        for _ in range(BUNDLE_ROUNDS):
            for v in dvols:
                for name, fn in (("tiled_probs_ms", predictor.tiled_probs),
                                 ("bundle_predict_ms", bundle.predict)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(v)
                    torch.cuda.synchronize()
                    row.setdefault(name, []).append(
                        (time.perf_counter() - t0) * 1e3)
        # the card's busy time in one call of each under torch.profiler,
        # against each one's median time a volume: the idle share
        for name, fn in (("tiled_probs", predictor.tiled_probs),
                         ("bundle_predict", bundle.predict)):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn(dvols[0])
                torch.cuda.synchronize()
            busy = device_busy_ms(prof)
            row[f"{name}_device_busy_ms"] = busy
            row[f"{name}_idle_share"] = 1 - busy / statistics.median(
                row[f"{name}_ms"])
        del dvols

        # the HTTP server on the bundle
        requests, v1_labels = [], {}
        with serving(bundle) as (_, base):
            for i, output in enumerate(("labels", "labels", "labels",
                                        "probs")):
                vol = vols[i % N_VOLUMES]
                reset_launches()
                got, latency, wall = post_volume(base, vol, output)
                launches = expect_launches(f"request {i}", read_launches(),
                                           forward)
                want = (bundle.labels(vol) if output == "labels"
                        else bundle.predict(vol)).cpu().numpy()
                if output == "labels":
                    v1_labels[i] = got
                err = float(np.abs(got.astype(np.float32)
                                   - want.astype(np.float32)).max())
                requests.append(dict(output=output, latency_ms=latency,
                                     client_ms=wall, max_abs_err=err,
                                     launches=launches))
                if got.shape != want.shape or err > 1e-6 or (
                        output == "labels" and err):
                    raise AssertionError(f"request {i}: {requests[-1]}")
        row["requests"] = requests
        del bundle

        # a single s2d bundle at 128^3, exported on the CPU, moved to the
        # card at load: two relayout launches a forward
        s2d_cfg = ModelConfig(**cfg_kw, s2d_fullres=True, s2d_halfres=True)
        cpu_model = cwf.build_model(s2d_cfg, device="cpu")
        cpu_model.load_state_dict(weights, strict=True)
        path = os.path.join(tmp, "single_s2d")
        t0 = time.perf_counter()
        export_bundle(Predictor(cpu_model, device="cpu"), path,
                      strategy="single", input_shape=(128, 128, 128))
        row["s2d_export_cpu_s"] = time.perf_counter() - t0
        del cpu_model
        t0 = time.perf_counter()
        s2d_bundle = ServingBundle.load(path)
        row["s2d_load_s"] = time.perf_counter() - t0
        x = torch.from_numpy(vols[0][:, :128, :128, :128]).to(dev)
        reset_launches()
        probs = s2d_bundle.predict(x)
        torch.cuda.synchronize()
        row["s2d_launches"] = expect_launches(
            "s2d single bundle", read_launches(),
            {"fused_instance_norm_act": norm_launches(torch.bfloat16, True,
                                                      batch=1),
             "attention_mma": ATTN_CALLS,
             "space_to_depth": RELAYOUT_PER_FORWARD})
        s2d_model = cwf.build_model(s2d_cfg, device=dev)
        s2d_model.load_state_dict(weights, strict=True)
        live = Predictor(s2d_model, device=dev).seg_probs(x)
        row["s2d_max_abs_dprob"] = (probs - live).abs().max().item()
        row["s2d_labels_equal_seg_probs"] = torch.equal(probs.argmax(-1),
                                                        live.argmax(-1))
        if not row["s2d_labels_equal_seg_probs"]:
            raise AssertionError(f"s2d bundle vs seg_probs: {row}")
        del s2d_bundle, s2d_model, probs, live, x

        # a paired V=2 tiling bundle: 2 concurrent single-volume requests
        # run as one B=16 forward
        path = os.path.join(tmp, "paired")
        t0 = time.perf_counter()
        export_bundle(predictor, path, strategy="tiling", batch_volumes=2)
        row["paired_export_s"] = time.perf_counter() - t0
        paired = ServingBundle.load(path)
        with serving(paired, coalesce_wait_s=5.0) as (server, base):
            answers = [None, None]

            def post(i):
                answers[i] = post_volume(base, vols[i], "labels")
            reset_launches()
            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            launches = read_launches()
            group = server._coalescer.last_group_size
        if any(a is None for a in answers):
            raise AssertionError("a paired request got no answer")
        # the paired engine on the same two volumes (one B=16 forward), and
        # its own difference from the B=8 engine: in bf16 the batch changes
        # K1's launch plan and cuDNN's algorithms, so sums run in another
        # order, and random weights leave many near-tied classes
        both = torch.from_numpy(np.concatenate(vols[:2])).to(dev)
        batch = predictor.tiled_probs_batch(both)
        batch_labels = batch.argmax(-1).to(torch.uint8).cpu().numpy()
        single = [predictor.tiled_probs(both[i:i + 1]) for i in range(2)]
        paired_forward = {"fused_instance_norm_act": norm_launches(
                              torch.bfloat16, batch=16),
                          "fused_attention": ATTN_CALLS,
                          "attention_mma": ATTN_CALLS}
        row["paired"] = dict(
            last_group_size=group,
            launches={k: launches[k] for k in paired_forward},
            expected_launches=paired_forward,
            latency_ms=[a[1] for a in answers],
            client_ms=[a[2] for a in answers],
            labels_equal_paired_engine=[
                bool(np.array_equal(answers[i][0], batch_labels[i:i + 1]))
                for i in range(2)],
            voxels_differing_v1_bundle=[
                int((answers[i][0] != v1_labels[i]).sum()) for i in range(2)],
            engine_b16_vs_b8_voxels=[
                int((batch[i].argmax(-1) != single[i][0].argmax(-1)).sum())
                for i in range(2)],
            engine_b16_vs_b8_max_abs_dprob=max(
                (batch[i] - single[i][0]).abs().max().item()
                for i in range(2)))
        del both, batch, single
        if group != 2 or row["paired"]["launches"] != paired_forward or \
                not all(row["paired"]["labels_equal_paired_engine"]):
            raise AssertionError(f"paired bundle: {row['paired']}")
        del paired
    row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    log(phase="serving_bundles", dtype="bfloat16", **row)
    return row


# ------------------------------------------------- int8 (K6, K7): phases 3-5

class Int8Calls(NamedTuple):
    """The int8 calls of one B=8 bf16 forward per (path, spec), in call
    order: K6's (xq shape, wq shape, stride, padding), K7's (x shape,
    route), and the fusednorm calls that report their absmax (shape, fine
    channels, residual)."""
    k6: dict
    k7: dict
    norms: dict


def amax_norm_launches(calls, path, spec):
    """fusednorm launches of one forward's absmax-variant calls, by the
    launch plan at each call's shape."""
    return sum(fusednorm.plan_for(shape, torch.bfloat16, 8, res, 0,
                                  True).launches
               for shape, _, res in calls.norms[path, spec])


def int8_expected(calls, path, spec):
    """Every counter's launches for one B=8 bf16 forward of one path and
    quantize spec: K1's calls split between its plain and absmax variants
    (``calls``: record_int8_calls'), K7 one launch a call on its two
    routes."""
    s2d = path == "s2d"
    amax = amax_norm_launches(calls, path, spec)
    return {"fused_instance_norm_act": (norm_launches(torch.bfloat16, s2d)
                                        - amax),
            "fused_instance_norm_act_amax": amax,
            "fused_attention": ATTN_CALLS, "attention_mma": ATTN_CALLS,
            "space_to_depth": RELAYOUT_PER_FORWARD if s2d else 0,
            "int8_conv3d": INT8_CONVS[path, spec],
            "quantize_absmax": K7_CALLS[path, spec]["grid"],
            "quantize_from_amax": K7_CALLS[path, spec]["from_amax"],
            "quantize_amax": 0}


def int8_model(dev, cfg_kw, weights, path, spec):
    model = cwf.build_model(ModelConfig(**cfg_kw, **PATHS[path],
                                        quantize=spec), device=dev)
    model.load_state_dict(weights, strict=True)
    return model


def record_int8_calls(dev, cfg_kw, weights) -> Int8Calls:
    """The int8 calls of one B=8 bf16 forward, on each path under each
    spec: K6's, their count checked against INT8_CONVS (the JAX rule's),
    K7's, their routes checked against K7_CALLS, and the fusednorm calls
    that report their absmax (one for each from_amax call)."""
    x = torch.randn((8, 128, 128, 128, 4), device=dev,
                    generator=gen(dev, SEED + 12))
    orig, orig_k7 = quant.conv3d_int8_prepared, quant.quantize_input
    calls = Int8Calls({}, {}, {})
    orig_norm = unet.fused_instance_norm_act_amax
    for key in INT8_CONVS:
        sigs, k7, norms = [], [], []

        def recording(x, wq, sw, stride=1, padding=1, bias=None, amax=None,
                      quantized=None):
            sigs.append((tuple(x.shape), tuple(wq.shape),
                         quant._triple(stride), quant._pairs(padding)))
            return orig(x, wq, sw, stride, padding, bias, amax, quantized)

        def k7_recording(x, amax=None):
            k7.append((tuple(x.shape),
                       "grid" if amax is None else "from_amax"))
            return orig_k7(x, amax)

        def norm_recording(x, fine, *args, residual=None, **kw):
            norms.append((tuple(x.shape), fine, residual is not None))
            return orig_norm(x, fine, *args, residual=residual, **kw)
        predictor = Predictor(int8_model(dev, cfg_kw, weights, *key),
                              device=dev)
        quant.conv3d_int8_prepared = recording
        quant.quantize_input = k7_recording
        unet.fused_instance_norm_act_amax = norm_recording
        try:
            predictor.seg_probs(x)
        finally:
            quant.conv3d_int8_prepared = orig
            quant.quantize_input = orig_k7
            unet.fused_instance_norm_act_amax = orig_norm
        calls.k6[key], calls.k7[key], calls.norms[key] = sigs, k7, norms
        routes = dict(collections.Counter(r for _, r in k7))
        ok = (len(sigs) == INT8_CONVS[key] and routes == K7_CALLS[key]
              and len(norms) == K7_CALLS[key]["from_amax"])
        log(check="int8_calls_per_forward", path=key[0], spec=key[1],
            calls=len(sigs), pinned=INT8_CONVS[key],
            distinct=len(set(sigs)), k7_routes=routes,
            pinned_k7_routes=K7_CALLS[key], amax_norms=len(norms),
            amax_norm_launches=amax_norm_launches(calls, *key), ok=ok)
        if not ok:
            raise AssertionError(f"{key}: {len(sigs)} int8 convs a forward, "
                                 f"K7 routes {routes}, {len(norms)} absmax "
                                 f"norms; pinned {INT8_CONVS[key]}, "
                                 f"{K7_CALLS[key]}")
        del predictor
    return calls


def int8_operands(dev, g, x_shape, w_shape):
    """Random int8 activations and weights of the given shapes, f32 stats
    and per-channel scales of the magnitudes the model gives."""
    xq = torch.randint(-127, 128, x_shape, dtype=torch.int8, device=dev,
                       generator=g)
    wq = torch.randint(-127, 128, w_shape, dtype=torch.int8, device=dev,
                       generator=g)
    sw = torch.rand(w_shape[0], device=dev, generator=g) * 1e-3 + 1e-4
    stats = torch.tensor([1.27, 0.01], device=dev)
    return xq, wq, sw, stats


def check_int8_conv(dev, calls):
    """K6 against its plain version (float64 accumulation), torch.equal, in
    f32 and bf16 out with a bias in that dtype and in f32 without: at every
    distinct (shape, k, stride, padding) the int8 and int8_all forwards
    call, on both paths (inputs of 64^3 voxels and more at B=1: the f64
    oracle is slow), each on the tma route, and on ragged shapes (vector
    widths 8 and 4, M and Co edges, asymmetric padding, unequal strides),
    each on the mma_sync route.  Returns the largest difference (0)."""
    g = gen(dev, SEED + 11)
    distinct = sorted({sig for sigs in calls.k6.values() for sig in sigs})
    have = {(s[0][-1], s[1][1], s[2], s[3]) for s in distinct}
    for need in ((96, 3, (1, 1, 1), ((1, 1),) * 3),       # conv_mid_fea_*
                 (256, 2, (1, 1, 1), ((1, 0),) * 3),      # s2d down2
                 (64, 3, (2, 2, 2), ((1, 1),) * 3)):      # down3
        if need not in have:
            raise AssertionError(f"no forward called K6 at {need}")
    cases = [(sig, "tma") for sig in distinct] + [
        (((2, 9, 7, 5, 72), (40, 3, 3, 3, 72), (1, 1, 1), ((1, 1),) * 3),
         "mma_sync"),
        (((3, 5, 6, 7, 36), (24, 3, 3, 3, 36), (2, 1, 2),
          ((1, 0), (1, 1), (0, 1))), "mma_sync")]
    worst = max(check_k6(dev, g, sig, route, K6_VARIANTS)
                for sig, route in cases)
    torch.cuda.synchronize()
    return worst


# K6's output dtype and bias in check_int8_conv
K6_VARIANTS = ((torch.float32, True), (torch.bfloat16, True),
               (torch.float32, False))


def check_k6(dev, g, sig, route, variants, what="int8_conv3d"):
    """K6 at one (x shape, w shape, stride, padding) against its plain
    version, torch.equal, for each (output dtype, bias) of ``variants``,
    launched once on ``route`` (B cut to 1 where a sample has
    INT8_ORACLE_VOXELS or more).  Returns the largest difference (0)."""
    x_shape, w_shape, stride, pads = sig
    if math.prod(x_shape[1:4]) >= INT8_ORACLE_VOXELS:
        x_shape = (1, *x_shape[1:])
    xq, wq, sw, stats = int8_operands(dev, g, x_shape, w_shape)
    worst = 0.0
    for dt, with_bias in variants:
        bias = (torch.randn(w_shape[0], device=dev, generator=g).to(dt)
                if with_bias else None)
        before = dict(quant.int8_conv3d.routes)
        got = quant.int8_conv3d(xq, stats, wq, sw, bias, stride, pads, dt)
        launched = {k: n - before[k]
                    for k, n in quant.int8_conv3d.routes.items()
                    if n != before[k]}
        want = quant.int8_conv3d_plain(xq, stats, wq, sw, bias, stride,
                                       pads, dt)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.equal(got, want) and launched == {route: 1}
        worst = max(worst, err)
        log(check=what, x=list(x_shape), w=list(w_shape),
            stride=list(stride), padding=[list(p) for p in pads],
            dtype=str(dt), bias=with_bias, route=route,
            launched=launched, max_abs_err=err, tol="torch.equal", ok=ok)
        if not ok:
            raise AssertionError(f"K6 disagrees or took another route "
                                 f"than {route} at {x_shape} {w_shape} "
                                 f"{stride} {pads} {dt}: {launched}")
        del got, want
    return worst


def k6_ptxas():
    """What ptxas said of K6's tma kernels (registers, shared memory,
    spills), from the build log: one entry per instantiation."""
    log_lines = _build.last_build_log.split("== int8conv.cu")[-1]
    log_lines = log_lines.split("\n== ")[0].splitlines()
    rows, name = [], None
    for ln in log_lines:
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            # the template arguments of the mangled name: T, BN, MSUB
            name = ("tma_conv_kernel<" + name.split("tma_conv_kernelI")[1]
                    .split("EEEv")[0] + ">" if "tma_conv_kernelI" in name
                    else None)
        elif name and ("registers" in ln or "spill" in ln):
            rows.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return rows


def check_quantize(dev):
    """K7 against its plain version (xq and both stats torch.equal), f32
    and bf16, at the main path's activation shapes (B=8 at 32^3 x 64, the
    s2d view at 64^3 x 128 B=8 bf16 only), on each route, one launch a
    call on its own counter: grid, from_amax with the per-sample absmax as
    the fused norm reports it, and amax (the absmax alone, torch.equal to
    quantize_amax_plain, then from_amax on it equal to the plain
    quantizer): randn activations, then the same with
    exact half-way ties planted: amax 127 s and a third of the values
    (k + 0.5) s for s = 2^-3, so that sx = s and x / sx = k + 0.5 exactly,
    which round half to even.  Returns the largest difference (0)."""
    g = gen(dev, SEED + 13)
    worst = 0.0
    for shape, dtypes in (((8, 32, 32, 32, 64), (torch.float32,
                                                 torch.bfloat16)),
                          ((8, 64, 64, 64, 128), (torch.bfloat16,))):
        for dt in dtypes:
            for ties in (False, True):
                x = torch.randn(shape, device=dev, generator=g) * 3
                if ties:
                    s = 2.0 ** -3
                    k = torch.randint(-126, 126, shape, device=dev,
                                      generator=g).float()
                    pick = torch.rand(shape, device=dev, generator=g) < 1 / 3
                    x = torch.where(pick, (k + 0.5) * s,
                                    x.clamp(-126 * s, 126 * s))
                    x.view(-1)[0] = 127 * s
                x = x.to(dt)
                slots = x.reshape(shape[0], -1).float().abs().amax(dim=1)
                pq, pstats = quant.quantize_absmax_plain(x)
                for route, call in (
                        ("grid", lambda: quant.quantize_absmax(x)),
                        ("from_amax", lambda: quant.quantize_from_amax(
                            x, slots)),
                        ("amax", lambda: (None, quant.quantize_amax(x)))):
                    before = {k: KERNEL_COUNTERS[k].launches
                              for k in K7_COUNTERS.values()}
                    xq, stats = call()
                    launched = {r: KERNEL_COUNTERS[k].launches - before[k]
                                for r, k in K7_COUNTERS.items()
                                if KERNEL_COUNTERS[k].launches != before[k]}
                    if route == "amax":
                        slot_equal = torch.equal(
                            stats, quant.quantize_amax_plain(x))
                        xq, stats = quant.quantize_from_amax(x, stats)
                        ok = slot_equal and (not ties
                                             or stats[0].item() == 127 / 8)
                    else:
                        ok = not ties or stats[1].item() == 2.0 ** -3
                    ok = (ok and torch.equal(xq, pq)
                          and torch.equal(stats, pstats)
                          and launched == {route: 1})
                    err = (xq.int() - pq.int()).abs().max().item()
                    worst = max(worst, float(err))
                    log(check="quantize", route=route, shape=list(shape),
                        dtype=str(dt), ties=ties, stats=stats.tolist(),
                        launched=launched, max_abs_err=err,
                        tol="torch.equal", ok=ok)
                    if not ok:
                        raise AssertionError(f"K7 ({route}) disagrees at "
                                             f"{shape} {dt} ties={ties}: "
                                             f"{launched}")
                    del xq
                del x, pq
    return worst


def check_fusednorm_amax(dev, widths, batch=8):
    """K1's absmax variant at the main path's B=8 shapes (relu, and lrelu
    with a residual, at each width and on the s2d views, f32 and bf16; the
    plan's fused and split routes both occur): its output within
    check_fusednorm's bounds of the plain PyTorch version's (f32 within
    1e-4; bf16 within 1e-4 + one bf16 ulp of the output, + one of the
    activation with a residual), in every case, and torch.equal to the
    plain variant's on the same input; its absmax torch.equal to the max
    |out| of that output per sample (K1 is not bit-exact to its plain
    version in bf16, so the absmax is held to K1's own output); its
    launches the plan's on its own counter; a second call bitwise equal.
    Returns the largest difference of its output from the plain PyTorch
    version's at the main path's bf16 widths and s2d views."""
    g = gen(dev, SEED + 16)
    cases = [((batch, e, e, e, c), c) for e, c in widths]
    cases += [((batch, 64, 64, 64, 128), 16), ((batch, 32, 32, 32, 256), 32)]
    worst, routes = 0.0, set()
    for shape, fine in cases:
        x32 = torch.randn(shape, device=dev, generator=g) * 3 + 1
        r32 = torch.randn(shape, device=dev, generator=g)
        for dt in (torch.float32, torch.bfloat16):
            for act, r in (("relu", None), ("lrelu", r32.to(dt))):
                x = x32.to(dt)
                plan = fusednorm.plan_for(shape, dt, fusednorm.vector_width(x),
                                          r is not None, 0, True)
                routes.add(plan.route)
                before = fusednorm.fused_instance_norm_act_amax.launches
                out, amax = fusednorm.fused_instance_norm_act_amax(
                    x, fine, act=act, residual=r)
                launched = (fusednorm.fused_instance_norm_act_amax.launches
                            - before)
                again = fusednorm.fused_instance_norm_act_amax(
                    x, fine, act=act, residual=r)
                want = out.reshape(batch, -1).float().abs().amax(dim=1)
                plain = fusednorm.fused_instance_norm_act(x, fine, act=act,
                                                          residual=r)
                amax_err = (amax - want).abs().max().item()
                ref, _ = fusednorm.fused_instance_norm_act_amax_plain(
                    x, fine, act=act, residual=r)
                within, err, tol, over_ulps = norm_within_bounds(
                    out, ref, x, fine, act, r)
                if dt == torch.bfloat16:
                    worst = max(worst, err.max().item())
                ok = (within and torch.equal(out, plain)
                      and torch.equal(amax, want)
                      and torch.equal(again[0], out)
                      and torch.equal(again[1], amax)
                      and launched == plan.launches)
                log(check="fusednorm_amax", shape=list(shape), fine=fine,
                    act=act, residual=r is not None, dtype=str(dt),
                    route=plan.route, launches=launched,
                    max_abs_err=err.max().item(), tol=tol,
                    over_ulps=over_ulps, within_bounds=within,
                    out_equal_plain_variant=torch.equal(out, plain),
                    amax_err=amax_err, amax_tol="torch.equal", ok=ok)
                if not ok:
                    raise AssertionError(f"fusednorm absmax variant at "
                                         f"{shape} {fine} {act} {dt}")
                del out, again, plain, ref
    if routes != {"fused", "split"}:
        raise AssertionError(f"absmax variant checked on {routes} only")
    torch.cuda.synchronize()
    return worst


def check_int8_k7(predictor, x, what):
    """One B=8 int8 forward on ``x`` with each K7 call's xq and stats held
    to quantize_absmax_plain's on the same input (torch.equal, on both
    routes), then the forward itself torch.equal to the same forward with
    K7 replaced by the plain quantizer (K6 the kernel in both).  Returns
    the row."""
    orig = quant.quantize_input
    calls, unequal = collections.Counter(), []

    def checked(x, amax=None):
        route = "grid" if amax is None else "from_amax"
        got = orig(x, amax)
        want = quant.quantize_absmax_plain(x.contiguous())
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            unequal.append(dict(
                call=sum(calls.values()), shape=list(x.shape), route=route,
                stats=got[1].tolist(), plain_stats=want[1].tolist(),
                xq_differing=int((got[0] != want[0]).sum())))
        calls[route] += 1
        return got

    def plain(x, amax=None):
        return quant.quantize_absmax_plain(x.contiguous())
    live = predictor.seg_probs(x)
    outs = {}
    for name, fn in (("checked", checked), ("plain_k7", plain)):
        quant.quantize_input = fn
        try:
            outs[name] = predictor.seg_probs(x)
        finally:
            quant.quantize_input = orig
    row = dict(k7_calls=dict(calls), k7_unequal=unequal,
               forward_equal_plain_k7=torch.equal(live, outs["plain_k7"]),
               max_abs_dprob=(live - outs["plain_k7"]).abs().max().item())
    log(check="int8_forward_k7_vs_plain", forward=what, tol="torch.equal",
        ok=not unequal and row["forward_equal_plain_k7"], **row)
    if unequal or not row["forward_equal_plain_k7"]:
        raise AssertionError(f"K7 in the {what} forward: {row}")
    return row


def profile_int8_forward(engines, vol, path):
    """One B=8 bf16 forward of the float and the int8 engine of a path,
    each under torch.profiler after a warm one: the device time of K1
    (both variants: norm_kernel), of K7 by route (from_amax_kernel,
    grid_kernel) and of the whole forward.  Fails unless the profiler saw
    each kernel's launches."""
    x = Predictor.crops(vol)
    row, s2d = {}, path == "s2d"
    for spec in ("none", "int8"):
        engines[spec].seg_probs(x)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            engines[spec].seg_probs(x)
            torch.cuda.synchronize()
        found = collections.defaultdict(list)
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for name in ("norm_kernel", "from_amax_kernel", "grid_kernel"):
                if name in e.name:
                    found[name].append(e.time_range.end - e.time_range.start)
        want = {"norm_kernel": norm_launches(torch.bfloat16, s2d),
                "from_amax_kernel": 0, "grid_kernel": 0}
        if spec == "int8":
            want.update(from_amax_kernel=K7_CALLS[path, "int8"]["from_amax"],
                        grid_kernel=K7_CALLS[path, "int8"]["grid"])
        got = {k: len(found[k]) for k in want}
        row[spec] = dict({f"{k}_device_ms": sum(v) / 1e3
                          for k, v in found.items()}, kernels=got,
                         forward_device_busy_ms=device_busy_ms(prof))
        if got != want:
            raise AssertionError(f"profiled {spec} forward ({path}): "
                                 f"kernels {got}, expected {want}")
    row["k1_amax_cost_ms"] = (row["int8"]["norm_kernel_device_ms"]
                              - row["none"]["norm_kernel_device_ms"])
    row["k7_device_ms"] = sum(row["int8"].get(f"{k}_device_ms", 0.0)
                              for k in ("from_amax_kernel", "grid_kernel"))
    log(timing="int8_forward_profile", path=path, unit="ms per B=8 bf16 "
        "forward (device time)", **row)
    return row


def run_int8_main_path(dev, cfg_kw, weights, volumes, calls):
    """bf16 tiled_probs with quantize='int8' on the direct path and the
    s2d path (dense conv3), against the float engine on the same weights,
    the two in turns over the volumes: each int8 call's launches those of
    one forward (K6 and K7 as pinned, K1-K3 as the float path's);
    finite probabilities that sum to one; the drift against the float
    engine within INT8_DRIFT (mean |dp| < 0.01; argmax agreement > 0.98
    direct, > 0.96 s2d).  Then one int8_all B=8 forward's launches, each
    K7 call of the int8 and int8_all forwards and both forwards against
    the plain quantizer (check_int8_k7), one profiled forward of each
    engine, and Predictor(fold_params=True) equal to the unfolded engine
    bit for bit.  Returns {path: row}."""
    rows = {}
    for path in PATHS:
        engines = {spec: Predictor(int8_model(dev, cfg_kw, weights, path,
                                              spec), device=dev)
                   for spec in ("none", "int8")}
        expected = int8_expected(calls, path, "int8")
        row = collections.defaultdict(list)
        for i, vol in enumerate(volumes):
            outs = {}
            for spec in (("none", "int8") if i % 2 == 0
                         else ("int8", "none")):
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[spec] = engines[spec].tiled_probs(vol)
                torch.cuda.synchronize()
                row[f"{spec}_ms"].append((time.perf_counter() - t0) * 1e3)
                if spec == "int8":
                    expect_launches(f"int8 tiled_probs ({path})",
                                    read_launches(), expected)
            q, f = outs["int8"], outs["none"]
            row["sum_err"].append((q.sum(-1) - 1).abs().max().item())
            row["mean_abs_dprob"].append((q - f).abs().mean().item())
            row["argmax_agreement"].append(
                (q.argmax(-1) == f.argmax(-1)).float().mean().item())
            if not bool(torch.isfinite(q).all()) or \
                    tuple(q.shape) != (1, 240, 240, 155, 4):
                raise AssertionError(f"int8 tiled_probs ({path}) malformed")
            del outs, q, f
        row = dict(row, launches_per_forward=expected)
        # int8_all: one B=8 forward
        x = Predictor.crops(volumes[0])
        every = Predictor(int8_model(dev, cfg_kw, weights, path,
                                     "int8_all"), device=dev)
        reset_launches()
        every.seg_probs(x)
        torch.cuda.synchronize()
        row["int8_all_launches"] = expect_launches(
            f"int8_all forward ({path})", read_launches(),
            int8_expected(calls, path, "int8_all"))
        row["k7_vs_plain"] = {
            "int8": check_int8_k7(engines["int8"], x, f"{path} int8"),
            "int8_all": check_int8_k7(every, x, f"{path} int8_all")}
        row["profile"] = profile_int8_forward(engines, volumes[0], path)
        del every, x
        # fold_params: the same ops on cached weights, the same bits
        folded = Predictor(engines["int8"].model, device=dev,
                           fold_params=True)
        row["fold_params_equal"] = torch.equal(
            folded.tiled_probs(volumes[0]), engines["int8"].tiled_probs(
                volumes[0]))
        del folded, engines
        bound = INT8_DRIFT[path]
        ok = (row["fold_params_equal"]
              and max(row["sum_err"]) <= 1e-3
              and max(row["mean_abs_dprob"]) < bound["mean"]
              and min(row["argmax_agreement"]) > bound["agree"])
        log(phase="int8_main_path", engine="tiled_probs", path=path,
            quantize="int8", dtype="bfloat16", volumes=len(volumes),
            drift_bounds=bound, ok=ok, **row)
        if not ok:
            raise AssertionError(f"int8 main path ({path}) failed: {row}")
        rows[path] = row
    return rows


def run_int8_witness(dev, cfg_kw, weights, volume):
    """The int8 drift at full width away from K6 and K7: one 128^3 crop of
    ``volume`` at B=1 through each path's int8 forward with the plain
    versions in the kernels' place (``quantize_absmax_plain`` and
    ``int8_conv3d_plain``, a float64 conv of the int8 values), against the
    float forward on the same weights, in bf16 and in f32; held to
    INT8_DRIFT as the kernels' forward is.  Returns {path: row}."""
    t0 = time.perf_counter()
    crop = Predictor.crops(volume)[:1]
    orig, orig_k7 = quant.conv3d_int8_prepared, quant.quantize_input

    def plain_k7(x, amax=None):
        return quant.quantize_absmax_plain(x.contiguous())

    def plain(x, wq, sw, stride=1, padding=1, bias=None, amax=None,
              quantized=None):
        xq, stats = quantized or plain_k7(x)
        b = None if bias is None else bias.to(x.dtype)
        return quant.int8_conv3d_plain(xq, stats, wq, sw, b, stride,
                                       padding, x.dtype)
    rows = {}
    for path in PATHS:
        row = {}
        for dtype in ("bfloat16", "float32"):
            kw = dict(cfg_kw, compute_dtype=dtype)
            probs = {}
            for spec in ("none", "int8"):
                predictor = Predictor(int8_model(dev, kw, weights, path,
                                                 spec), device=dev)
                reset_launches()
                quant.conv3d_int8_prepared = plain
                quant.quantize_input = plain_k7
                try:
                    probs[spec] = predictor.seg_probs(crop)
                finally:
                    quant.conv3d_int8_prepared = orig
                    quant.quantize_input = orig_k7
                launches = read_launches()
                if launches["int8_conv3d"] or launches["quantize_absmax"] \
                        or launches["quantize_from_amax"]:
                    raise AssertionError(f"int8 witness ({path}) launched "
                                         f"K6/K7: {launches}")
                del predictor
            q, f = probs["int8"], probs["none"]
            if not bool(torch.isfinite(q).all()):
                raise AssertionError(f"int8 witness ({path}) not finite")
            row[dtype] = dict(
                mean_abs_dprob=(q - f).abs().mean().item(),
                argmax_agreement=(q.argmax(-1) == f.argmax(-1)
                                  ).float().mean().item())
            del probs, q, f
        bound = INT8_DRIFT[path]
        ok = all(r["mean_abs_dprob"] < bound["mean"]
                 and r["argmax_agreement"] > bound["agree"]
                 for r in row.values())
        log(phase="int8_witness", path=path, crop="1x128^3",
            route="plain", drift_bounds=bound, ok=ok,
            seconds=time.perf_counter() - t0, **row)
        if not ok:
            raise AssertionError(f"int8 witness ({path}) failed: {row}")
        rows[path] = row
    return rows


def run_int8_bundle(dev, cfg_kw, weights, calls):
    """Phase 4d for int8: a bf16 int8 ``tiling`` bundle on the direct path,
    exported on the card and loaded fresh, equal bit for bit to the live
    int8 tiled_probs on a seeded volume, each launching one forward's
    kernels; then one HTTP labels request, answered from it with the
    bundle's own labels."""
    rng = np.random.default_rng(SEED + 14)
    vol = rng.standard_normal(VOLUME, dtype=np.float32)
    predictor = Predictor(int8_model(dev, cfg_kw, weights, "direct",
                                     "int8"), device=dev)
    forward = int8_expected(calls, "direct", "int8")
    row = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tiling_int8")
        t0 = time.perf_counter()
        export_bundle(predictor, path, strategy="tiling")
        row["export_s"] = time.perf_counter() - t0
        row["bundle_mb"] = bundle_mb(path)
        t0 = time.perf_counter()
        bundle = ServingBundle.load(path)
        row["load_s"] = time.perf_counter() - t0
        dvol = torch.from_numpy(vol).to(dev)
        reset_launches()
        probs = bundle.predict(dvol)
        torch.cuda.synchronize()
        row["predict_launches"] = expect_launches(
            "int8 bundle.predict", read_launches(), forward)
        reset_launches()
        live = predictor.tiled_probs(dvol)
        torch.cuda.synchronize()
        row["tiled_probs_launches"] = expect_launches(
            "int8 tiled_probs", read_launches(), forward)
        row["probs_equal_tiled_probs"] = torch.equal(probs, live)
        row["max_abs_dprob"] = (probs - live).abs().max().item()
        if not row["probs_equal_tiled_probs"]:
            raise AssertionError(f"int8 bundle vs tiled_probs: {row}")
        del probs, live, dvol
        with serving(bundle) as (_, base):
            reset_launches()
            got, latency, wall = post_volume(base, vol, "labels")
            launches = expect_launches("int8 request", read_launches(),
                                       forward)
        want = bundle.labels(vol).cpu().numpy()
        row["request"] = dict(latency_ms=latency, client_ms=wall,
                              labels_equal_bundle=bool(
                                  np.array_equal(got, want)),
                              launches=launches)
        if not row["request"]["labels_equal_bundle"]:
            raise AssertionError(f"int8 request: {row['request']}")
        del bundle
    log(phase="serving_bundle_int8", strategy="tiling", quantize="int8",
        dtype="bfloat16", **row)
    return row


def k6_costs(x_shape, w_shape, stride, pads):
    """(ops, bytes) of one bf16-out K6 call: 2 M Co K operations; the int8
    input and weight read once, the 2-byte output written once."""
    out = quant.out_shape(x_shape, w_shape, stride, pads)
    m, co, kdim = math.prod(out[:4]), w_shape[0], math.prod(w_shape[1:])
    return (2 * m * co * kdim,
            math.prod(x_shape) + math.prod(w_shape) + m * co * 2)


def bound_of(ops, nbytes):
    by_ops = ops / INT8_TOPS > nbytes / HBM_BYTES_PER_S
    return (max(ops / INT8_TOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
            "operations" if by_ops else "bytes")


def time_k6(dev, g, x_shape, w_shape, stride, pads, iters=10, plain=True,
            int_mm=False):
    """One K6 call in bf16 at a shape: its route, its call time (CUDA
    events, back to back) and the card's time (queued_ms), the plain
    version's time and its output, which the kernel's must equal
    (torch.equal), the bf16 cuDNN conv of the same shape (library_ms) and,
    where asked and the im2col fits, torch._int_mm on the im2col matrix;
    the bound and the rate."""
    xq, wq, sw, stats = int8_operands(dev, g, x_shape, w_shape)
    args = (xq, stats, wq, sw, None, stride, pads, torch.bfloat16)
    row = dict(x=list(x_shape), w=list(w_shape), stride=list(stride),
               padding=[list(p) for p in pads])
    routes = dict(quant.int8_conv3d.routes)
    row["ms"] = time_ms(lambda: quant.int8_conv3d(*args), iters)
    row["route"] = [k for k, n in quant.int8_conv3d.routes.items()
                    if n != routes[k]]
    row["device_ms"] = queued_ms(lambda: quant.int8_conv3d(*args), iters)
    if plain:
        want = quant.int8_conv3d_plain(*args)
        row["plain_ms"] = time_ms(lambda: quant.int8_conv3d_plain(*args), 1,
                                  warmup=0)
        row["equal_plain"] = torch.equal(quant.int8_conv3d(*args), want)
        del want
        if not row["equal_plain"]:
            raise AssertionError(f"K6 disagrees with its plain version at "
                                 f"{x_shape} {w_shape} {stride} {pads}")
    (dl, dh), (hl, hh), (wl, wh) = pads
    xb = F.pad(torch.randn(x_shape, device=dev, generator=g).bfloat16()
               .permute(0, 4, 1, 2, 3), (wl, wh, hl, hh, dl, dh)).contiguous(
        memory_format=torch.channels_last_3d)
    wb = torch.randn((w_shape[0], w_shape[4], *w_shape[1:4]), device=dev,
                     generator=g).bfloat16().contiguous(
        memory_format=torch.channels_last_3d)
    row["library_ms"] = time_ms(lambda: F.conv3d(xb, wb, None, stride), iters)
    del xb, wb
    if int_mm:
        out = quant.out_shape(x_shape, w_shape, stride, pads)
        k = w_shape[1]
        m, kdim = math.prod(out[:4]), k ** 3 * x_shape[-1]
        if m * kdim < 16e9:
            xp = F.pad(xq.permute(0, 4, 1, 2, 3), (wl, wh, hl, hh, dl, dh))
            cols = (xp.unfold(2, k, stride[0]).unfold(3, k, stride[1])
                    .unfold(4, k, stride[2]))        # n c d h w kd kh kw
            a = cols.permute(0, 2, 3, 4, 5, 6, 7, 1).reshape(m, kdim)
            b = wq.reshape(w_shape[0], kdim).t()
            row["int_mm_ms"] = time_ms(lambda: torch._int_mm(a, b), iters)
            row["im2col_bytes"] = m * kdim
            del xp, cols, a, b
    ops, nbytes = k6_costs(x_shape, w_shape, stride, pads)
    row["bound_ms"], row["bound_by"] = bound_of(ops, nbytes)
    row["tops"] = ops / row["device_ms"] / 1e9
    row["device_over_library"] = row["device_ms"] / row["library_ms"]
    del xq, wq
    return row


def time_k7(dev, g, shape, iters=10):
    """K7 on a bf16 activation, on each route (grid, from_amax with the
    per-sample absmax a fused norm reports, and amax, the absmax alone):
    call time (CUDA events, back to back) and the card's time (queued_ms);
    the plain version's time; the bound (x read once, xq written once;
    amax: x read once) and the two-pass floor (x read twice, by the absmax
    and by the quantize)."""
    x = torch.randn(shape, device=dev, generator=g).bfloat16()
    slots = x.reshape(shape[0], -1).float().abs().amax(dim=1)
    calls = {"grid": lambda: quant.quantize_absmax(x),
             "from_amax": lambda: quant.quantize_from_amax(x, slots),
             "amax": lambda: quant.quantize_amax(x)}
    row = dict(shape=list(shape))
    for route in K7_COUNTERS:
        row[f"{route}_ms"] = time_ms(calls[route], iters)
        row[f"{route}_device_ms"] = queued_ms(calls[route], iters)
    row["plain_ms"] = time_ms(lambda: quant.quantize_absmax_plain(x), iters)
    xb, qb = x.numel() * x.element_size(), x.numel()
    row["bound_ms"] = (xb + qb) / HBM_BYTES_PER_S * 1e3
    row["two_pass_floor_ms"] = (2 * xb + qb) / HBM_BYTES_PER_S * 1e3
    row["amax_bound_ms"] = xb / HBM_BYTES_PER_S * 1e3
    del x, slots
    return row


def time_mesh_int8(dev, row, iters=10):
    """Phase 5 for int8 over a mesh, at the calls one rank's forward on
    (data=1, space=2) made (``row``: run_spatial_int8's): K7's amax route
    at each amax call (call and card time, the plain version, one library
    call of the same function, torch.linalg.vector_norm(x, inf), and the
    bound: x read once); K1's external-statistics pair with absmax slots at
    each call that reported slots, bf16 (call and card time of the
    statistics and the apply launch, the plain versions, and the bound: x
    and the residual read once, the output written once, 4 bytes a slot).
    Sums per forward."""
    g = gen(dev, SEED + 24)
    amax, ext = collections.defaultdict(float), collections.defaultdict(float)
    for shape, route in row["k7_calls"]:
        if route != "amax":
            continue
        x = torch.randn(shape, device=dev, generator=g).bfloat16()
        amax["calls"] += 1
        amax["ms"] += time_ms(lambda: quant.quantize_amax(x), iters)
        amax["device_ms"] += queued_ms(lambda: quant.quantize_amax(x), iters)
        amax["plain_ms"] += time_ms(lambda: quant.quantize_amax_plain(x),
                                    max(2, iters // 4))
        amax["library_ms"] += time_ms(
            lambda: torch.linalg.vector_norm(x, float("inf")), iters)
        amax["bound_ms"] += x.numel() * x.element_size() / HBM_BYTES_PER_S \
            * 1e3
        amax["bytes"] += x.numel() * x.element_size()
        del x
    for shape, fine, res in row["amax_norm_calls"]:
        x = torch.randn(shape, device=dev, generator=g).bfloat16()
        r = (torch.randn(shape, device=dev, generator=g).bfloat16() if res
             else None)
        act = "lrelu" if res else "relu"
        count = fusednorm.norm_count(x, fine) * SPACE_RANKS
        sums = fusednorm.fused_norm_stats(x, fine) * SPACE_RANKS

        def call():
            _, slots = fusednorm.fused_norm_stats_amax(x, fine)
            return fusednorm.fused_norm_apply_amax(x, sums, slots, count,
                                                   fine, act=act, residual=r)

        def plain():
            fusednorm.fused_norm_stats_plain(x, fine)
            return fusednorm.fused_norm_apply_amax_plain(
                x, sums, count, fine, act=act, residual=r)
        ext["calls"] += 1
        ext["ms"] += time_ms(call, iters)
        ext["device_ms"] += queued_ms(call, iters)
        ext["plain_ms"] += time_ms(plain, max(2, iters // 4))
        nbytes = (x.numel() * x.element_size() * (3 if res else 2)
                  + 4 * shape[0])
        ext["bound_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
        ext["bytes"] += nbytes
        del x, r
    rows = {"quantize_amax": dict(amax), "fusednorm_ext_amax": dict(ext)}
    log(timing="int8_mesh_kernels", mesh="data1_space2", dtype="bfloat16",
        unit="per B=8 int8 forward of one rank (sums over its calls)",
        **rows)
    return rows


def time_k1_amax(dev, g, shape, fine, res, iters=5):
    """K1's absmax variant at one call of a forward (bf16, relu without a
    residual, lrelu with one): call and card time, the card time of the
    plain variant on the same input (the difference is what the absmax
    costs), the plain PyTorch version's time, and the bound (x and the
    residual read once, the output written once)."""
    x = torch.randn(shape, device=dev, generator=g).bfloat16()
    r = torch.randn(shape, device=dev, generator=g).bfloat16() if res \
        else None
    act = "lrelu" if res else "relu"
    row = dict(shape=list(shape), residual=res, fine=fine)

    def amax():
        return fusednorm.fused_instance_norm_act_amax(x, fine, act=act,
                                                      residual=r)

    def plain_variant():
        return fusednorm.fused_instance_norm_act(x, fine, act=act,
                                                 residual=r)
    row["ms"] = time_ms(amax, iters)
    row["device_ms"] = queued_ms(amax, iters)
    row["plain_variant_device_ms"] = queued_ms(plain_variant, iters)
    row["amax_cost_ms"] = row["device_ms"] - row["plain_variant_device_ms"]
    row["plain_ms"] = time_ms(
        lambda: fusednorm.fused_instance_norm_act_amax_plain(
            x, fine, act=act, residual=r), 2, warmup=1)
    row["bound_ms"] = (x.numel() * x.element_size() * (3 if res else 2)
                       / HBM_BYTES_PER_S * 1e3)
    del x, r
    return row


def time_int8(dev, calls):
    """Phase 5 for int8: K6 at the s2d full-resolution dense conv (B=8,
    64^3 x 128 -> 128, K = 3456) and at en3 (B=8, 32^3 x 64 -> 64), with
    torch._int_mm on the im2col beside it; K7 at both inputs on each
    route; then the sums over one B=8 forward's calls on each path under
    int8 (K6: call and card time, cuDNN's bf16 conv, the bound; K7: call
    and card time of each call on its route, and of every call on each
    route, the bound and the two-pass floor; K1's absmax variant at each
    call that reports one, and what the absmax adds to its card time; the
    plain versions on the direct path)."""
    g = gen(dev, SEED + 15)
    named = {"s2d_fullres_dense": ((8, 64, 64, 64, 128), (128, 3, 3, 3, 128)),
             "en3": ((8, 32, 32, 32, 64), (64, 3, 3, 3, 64))}
    rows = {}
    for name, (xs, ws) in named.items():
        rows[name] = time_k6(dev, g, xs, ws, (1, 1, 1), ((1, 1),) * 3,
                             int_mm=True)
        rows[name]["k7"] = time_k7(dev, g, xs)
        log(timing="int8_conv3d", site=name, dtype="bfloat16", **rows[name])
    k7_rows, k1_rows = {}, {}
    for path in PATHS:
        sigs = collections.Counter(calls.k6[path, "int8"])
        per = collections.defaultdict(float)
        for (xs, ws, stride, pads), n in sigs.items():
            r = time_k6(dev, g, xs, ws, stride, pads, iters=5,
                        plain=path == "direct")
            for key in ("ms", "device_ms", "library_ms", "bound_ms") + (
                    ("plain_ms",) if path == "direct" else ()):
                per[key] += n * r[key]
            ops, nbytes = k6_costs(xs, ws, stride, pads)
            per["ops"] += n * ops
            per["bytes"] += n * nbytes
        per = dict(per, calls=sum(sigs.values()), distinct=len(sigs))
        per["bound_by"] = ("operations" if per["ops"] / INT8_TOPS
                           > per["bytes"] / HBM_BYTES_PER_S else "bytes")
        # K7: each call on the route the forward took, and every call on
        # each route (what the forward would take on that route alone)
        k7 = collections.defaultdict(float)
        for (xs, route), n in collections.Counter(
                calls.k7[path, "int8"]).items():
            if xs not in k7_rows:
                k7_rows[xs] = time_k7(dev, g, xs, iters=5)
            t = k7_rows[xs]
            for key in ("ms", "device_ms"):
                k7[key] += n * t[f"{route}_{key}"]
                k7[f"{route}_{key}"] += n * t[f"{route}_{key}"]
            for other in K7_COUNTERS:
                k7[f"all_{other}_device_ms"] += n * t[f"{other}_device_ms"]
            for key in ("plain_ms", "bound_ms", "two_pass_floor_ms"):
                k7[key] += n * t[key]
                k7[f"{route}_{key}"] += n * t[key]
            k7[f"{route}_calls"] += n
        # K1's absmax variant at the norms that report one
        for norm in calls.norms[path, "int8"]:
            if norm not in k1_rows:
                k1_rows[norm] = time_k1_amax(dev, g, *norm)
            t = k1_rows[norm]
            for key in ("ms", "device_ms", "amax_cost_ms", "plain_ms",
                        "bound_ms"):
                k7[f"k1_amax_{key}"] += t[key]
        k7["device_ms_with_k1_amax_cost"] = (k7["device_ms"]
                                             + k7["k1_amax_amax_cost_ms"])
        # what a fused norm writing int8 itself would save where it has no
        # residual and feeds only the int8 conv: its 2-byte write and K7's
        # 2-byte read of each element (K7's int8 write becomes the norm's)
        k7["k1_int8_saves_bytes"] = sum(4 * math.prod(shape) for shape, _, res
                                        in calls.norms[path, "int8"]
                                        if not res)
        k7["k1_int8_saves_ms"] = (k7["k1_int8_saves_bytes"] / HBM_BYTES_PER_S
                                  * 1e3)
        per["k7"] = dict(k7)
        log(timing="int8_per_forward", path=path, quantize="int8",
            unit="per B=8 bf16 forward", **per)
        rows[f"forward_{path}"] = per
    for xs, t in k7_rows.items():
        log(timing="k7_call", **t)
    for t in k1_rows.values():
        log(timing="k1_amax_call", **t)
    return rows


# ---------------------------------------------------------------- phase 5

def relayout_library(x, out):
    """The relayout as one PyTorch call: a copy (with the cast) of x's
    permuted 2x2x2 blocks into ``out`` (N, D/2, H/2, W/2, 8C)."""
    n, d, h, w, c = x.shape
    out.view(n, d // 2, h // 2, w // 2, 2, 2, 2, c).copy_(
        x.view(n, d // 2, 2, h // 2, 2, w // 2, 2, c).permute(
            0, 1, 3, 5, 2, 4, 6, 7))
    return out


def rotation(x, odt, grad=False):
    """Copies of ``x`` (requiring a gradient if ``grad``), each with an
    output buffer, enough that the pairs fill RELAYOUT_ROTATE_BYTES:
    calls that walk them in turn find neither input nor output in L2."""
    pair = x.numel() * (x.element_size() + torch.finfo(odt).bits // 8)
    n, d, h, w, c = x.shape
    return [(x.clone().requires_grad_(grad),
             torch.empty((n, d // 2, h // 2, w // 2, 8 * c), dtype=odt,
                         device=x.device))
            for _ in range(max(2, -(-RELAYOUT_ROTATE_BYTES // pair)))]


def rotating(fn, pairs):
    """A call of ``fn(x, out)`` on the next of ``pairs``.  Its result is
    kept until the ring comes round, so an output that the call allocates
    is not the block that the last call freed (still in L2)."""
    turn = itertools.cycle(pairs)
    kept = collections.deque(maxlen=len(pairs))
    return lambda: kept.append(fn(*next(turn)))


def time_relayout(dev, iters=20, repeats=RELAYOUT_REPEATS):
    """K3 at each call of RELAYOUT_CALLS: the kernel, its plain version
    and one PyTorch call for the same function (a permuted copy_ into the
    output, checked equal to the kernel's result), call time back to back
    (CUDA events) in turns, ``repeats`` times, and the card's time of the
    kernel and the copy_ (queued_ms) each time; the bytes bound at HBM's
    rate (input read once, output written once).  Every timed call reads
    and writes buffers that L2 no longer holds (``rotation``).  The
    training step calls its half-res site on an input that needs a
    gradient, through the autograd Function: timed too (``grad_ms``).
    Returns {use: row}: medians and min-max over the repeats of the sums
    over the use's two sites, and each site's launch plan."""
    g = gen(dev, SEED + 10)
    keys = ("ms", "plain_ms", "library_ms", "device_ms", "library_device_ms",
            "grad_ms")
    rows = {}
    for use, calls in RELAYOUT_CALLS.items():
        step = {k: [0.0] * repeats for k in keys}
        plans, bound = {}, 0.0
        for name, (shape, idt, odt) in calls.items():
            x = torch.randn(shape, device=dev, generator=g).to(idt)
            out = relayout.space_to_depth(x, odt)
            plan = launched_plan(x, out)
            if not torch.equal(relayout_library(x, torch.empty_like(out)),
                               out):
                raise AssertionError("the relayout library call disagrees")
            pairs = rotation(x, odt)
            fns = {"ms": rotating(
                       lambda a, o: relayout.space_to_depth(a, odt), pairs),
                   "plain_ms": rotating(
                       lambda a, o: relayout.space_to_depth_plain(a, odt),
                       pairs),
                   "library_ms": rotating(relayout_library, pairs),
                   "grad_ms": rotating(
                       lambda a, o: relayout.space_to_depth(a, odt),
                       rotation(x, odt, grad=True))}
            site = {k: [] for k in keys}
            for rep in range(repeats):
                for k, fn in (list(fns.items()) if rep % 2
                              else list(fns.items())[::-1]):
                    site[k].append(time_ms(fn, iters))
                site["device_ms"].append(queued_ms(fns["ms"], iters))
                site["library_device_ms"].append(
                    queued_ms(fns["library_ms"], iters))
            row = {k: statistics.median(v) for k, v in site.items()}
            row.update(bound_ms=x.numel() * (x.element_size()
                                             + torch.finfo(odt).bits // 8)
                       / HBM_BYTES_PER_S * 1e3,
                       plan=plan._asdict(), rotation=len(pairs),
                       spread={k: [min(v), max(v)] for k, v in site.items()})
            log(timing="relayout", use=use, site=name, shape=list(shape),
                dtype_in=str(idt), dtype_out=str(odt), repeats=repeats,
                **row)
            for k, v in site.items():
                for i, t in enumerate(v):
                    step[k][i] += t
            plans[name] = plan._asdict()
            bound += row["bound_ms"]
            del x, out, pairs, fns
        rows[use] = dict(
            {k: statistics.median(v) for k, v in step.items()},
            bound_ms=bound, plan=plans, repeats=repeats,
            spread={k: [min(v), max(v)] for k, v in step.items()})
        log(timing="relayout_sum", use=use, **rows[use])
    return rows


def time_fusednorm(dev, widths, batch=8, iters=10):
    """Per-width ms of the kernel (call time back to back, CUDA events, and
    the card's own time, queued_ms), its plain version and the
    library's InstanceNorm + act (+ add), bf16, at the main path's B=8
    shapes, on the route the plan picks at each."""
    g = gen(dev, SEED + 3)
    rows = []
    for edge, c in widths:
        shape = (batch, edge, edge, edge, c)
        x = torch.randn(shape, device=dev, generator=g).bfloat16()
        r = torch.randn(shape, device=dev, generator=g).bfloat16()
        xc, rc = x.permute(0, 4, 1, 2, 3), r.permute(0, 4, 1, 2, 3)
        row = dict(shape=list(shape), dtype="bf16")
        for kind, res in (("nores", None), ("res", r)):
            act = "relu" if res is None else "lrelu"
            plan = fusednorm.plan_for(shape, x.dtype, 8, res is not None, 0)
            row[f"{kind}_route"] = plan.route
            row[f"{kind}_launches"] = plan.launches

            def call():
                return fusednorm.fused_instance_norm_act(x, c, act=act,
                                                         residual=res)
            row[f"{kind}_ms"] = time_ms(call, iters)
            row[f"{kind}_device_ms"] = queued_ms(call, iters)
            row[f"{kind}_plain_ms"] = time_ms(
                lambda: fusednorm.fused_instance_norm_act_plain(
                    x, c, act=act, residual=res), max(2, iters // 4))
            row[f"{kind}_library_ms"] = time_ms(
                (lambda: F.relu(F.instance_norm(xc))) if res is None else
                (lambda: F.leaky_relu(F.instance_norm(xc)) + rc),
                max(2, iters // 4))
            # bound: x (and the residual) read once, the output written
            # once; floor: the two-pass algorithm reads x twice
            tensor_ms = x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            row[f"{kind}_bound_ms"] = tensor_ms * (2 if res is None else 3)
            row[f"{kind}_floor_ms"] = tensor_ms * (3 if res is None else 4)
        log(timing="fusednorm", **row)
        rows.append(row)
        del x, r, xc, rc
    return rows


def profile_forward(predictor, vol):
    """One B=8 bf16 forward (seg_probs on the 8 crops of a volume) under
    torch.profiler, after a warm one: the fusednorm kernel's summed device
    time and launches in context (against the launches its plan gives),
    the forward's device busy time, the copy kernels (aten::copy_) of the
    whole forward, and how many norm calls got a non-contiguous input or
    residual, which the UNet's .contiguous() would copy around the
    kernel.  Fails unless the profiler saw the plan's launches and no norm
    input was copied."""
    x = Predictor.crops(vol)
    predictor.seg_probs(x)
    torch.cuda.synchronize()
    orig, strided = unet._norm_act, []

    def watched(t, eps, act, fused, s2d_view=False, residual=None,
                amax=False):
        strided.append(not t.is_contiguous() or (
            residual is not None and not residual.is_contiguous()))
        return orig(t, eps, act, fused, s2d_view, residual, amax)
    unet._norm_act = watched
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            predictor.seg_probs(x)
            torch.cuda.synchronize()
    finally:
        unet._norm_act = orig
    norm = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "norm_kernel" in e.name]
    copies = [r for r in prof.key_averages() if r.key == "aten::copy_"]
    row = dict(batch=x.shape[0], dtype="bfloat16",
               fusednorm_device_ms=sum(norm) / 1e3,
               fusednorm_kernels=len(norm),
               expected_fusednorm_kernels=norm_launches(torch.bfloat16),
               norm_calls=len(strided),
               norm_calls_copying_input=sum(strided),
               forward_device_busy_ms=device_busy_ms(prof),
               copy_calls=sum(r.count for r in copies),
               copy_device_ms=sum(r.self_device_time_total
                                  for r in copies) / 1e3)
    log(timing="fusednorm_in_forward", **row)
    if (row["fusednorm_kernels"] != row["expected_fusednorm_kernels"]
            or row["norm_calls_copying_input"]):
        raise AssertionError(
            f"fusednorm in the profiled forward: {row['fusednorm_kernels']} "
            f"kernels (plan {row['expected_fusednorm_kernels']}), "
            f"{row['norm_calls_copying_input']} inputs copied")
    return row


def time_attention(dev, shape=ATTN_SHAPE, iters=50):
    """bf16 at the main path's shape: the call time back to back (CUDA
    events, so the host's time per call counts once the card is faster),
    also on the model's strided views, and the card's own time under the
    profiler, for the kernel and for scaled_dot_product_attention."""
    g = gen(dev, SEED + 4)
    q, k, v = (torch.randn(shape, device=dev, generator=g).bfloat16()
               for _ in range(3))
    qs, ks, vs = attention_inputs(dev, g, shape, torch.bfloat16, True)
    scale = shape[-1] ** -0.5
    row = dict(shape=list(shape), dtype="bf16")
    row["ms"] = time_ms(lambda: attn.fused_attention(q, k, v, scale), iters)
    row["strided_ms"] = time_ms(
        lambda: attn.fused_attention(qs, ks, vs, scale), iters)
    row["device_ms"] = device_ms(
        lambda: attn.fused_attention(q, k, v, scale), iters,
        "attention_mma_kernel")
    row["plain_ms"] = time_ms(
        lambda: attn.fused_attention_plain(q, k, v, scale), iters)
    row["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), iters)
    row["library_device_ms"] = device_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), iters)
    b, h, n, d = shape
    flops = 4 * b * h * n * n * d
    nbytes = 4 * q.numel() * q.element_size()
    row["bytes_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    row["flops_bound_ms"] = flops / BF16_FLOPS * 1e3
    log(timing="attention", **row)
    return row


DISPATCH_REPEATS = 5


def time_dispatch(dev, iters=200, repeats=DISPATCH_REPEATS):
    """The host time per call that the operator registration adds to K1,
    K2 and K3: each called back to back (CUDA events; at these shapes the
    host sets the time of a call) through its wrapper, which calls the
    dctseg operator, under torch.inference_mode() as the engines call it
    and with grad mode on, and through its launch function directly;
    medians of ``repeats`` turns.  Shapes: K1 at 16^3x128 (B=8, its
    smallest call), K2 at the model's strided views, K3 at the B=1
    half-res site."""
    g = gen(dev, SEED + 7)
    x = torch.randn((8, 16, 16, 16, 128), device=dev, generator=g).bfloat16()
    q, k, v = attention_inputs(dev, g, ATTN_SHAPE, torch.bfloat16, True)
    scale = ATTN_SHAPE[-1] ** -0.5
    xr = torch.randn((1, 64, 64, 64, 32), device=dev, generator=g).bfloat16()
    cases = {
        "fusednorm": (
            lambda: fusednorm.fused_instance_norm_act(x, 128, act="relu"),
            lambda: fusednorm._launch(
                fusednorm.VARIANTS["fused_instance_norm_act"], x, None, 128,
                1e-5, "relu", 0.01)),
        "attention": (lambda: attn.fused_attention(q, k, v, scale),
                      lambda: attn._launch(q, k, v, scale)),
        "relayout": (lambda: relayout.space_to_depth(xr, torch.bfloat16),
                     lambda: relayout._launch(xr, torch.bfloat16))}
    rows = {}
    for name, (op, direct) in cases.items():
        got = collections.defaultdict(list)
        for _ in range(repeats):
            got["direct_us"].append(time_ms(direct, iters) * 1e3)
            with torch.inference_mode():
                got["op_inference_us"].append(time_ms(op, iters) * 1e3)
            got["op_grad_mode_us"].append(time_ms(op, iters) * 1e3)
        row = {k: statistics.median(v) for k, v in got.items()}
        row["spread"] = {k: [min(v), max(v)] for k, v in got.items()}
        row["dispatch_us"] = row["op_inference_us"] - row["direct_us"]
        row["grad_mode_dispatch_us"] = (row["op_grad_mode_us"]
                                        - row["direct_us"])
        log(timing="op_dispatch", kernel=name, **row)
        rows[name] = row
    return rows


def time_metrics(dev, pred, tgt):
    """Per 240x240x155 volume pair (HD95 'reference'): the two EDTs (K4),
    the whole order-statistic search (K5), each through the kernel and
    through its plain version, torch.kthvalue for the search's 6 (class,
    rank) pairs, DeviceMetrics end to end (CUDA events), and the host scipy
    cal_hausdorff (host clock)."""
    out_lbl = torch.from_numpy(pred).to(dev)
    tgt_lbl = torch.from_numpy(tgt).to(dev)
    o = metrics.composite_masks(out_lbl)
    t = metrics.composite_masks(tgt_lbl)
    mask = torch.cat([t, o])
    row = {"edt_ms": time_ms(lambda: edt.squared_edt(mask), 10),
           "edt_kernel_device_ms": device_ms(lambda: edt.squared_edt(mask),
                                             10, "envelope_kernel"),
           "edt_device_ms": device_ms(lambda: edt.squared_edt(mask), 10)}
    with plain_minplus():
        row["edt_plain_ms"] = time_ms(lambda: edt.squared_edt(mask), 1, 1)
    # Each pass reads and writes the volume once.  The least work is the
    # kernel's lower-envelope transform (Felzenszwalb & Huttenlocher), exact
    # on these integers in O(D) per column: at most two parabola crossings
    # per element and the fill, counted as ENVELOPE_INSTR instructions per
    # element and pass.
    row["edt_ops_bound_ms"] = (EDT_LAUNCHES * ENVELOPE_INSTR * mask.numel()
                               / F32_INSTR * 1e3)
    # bytes: the f32 costs read once and the distances written once; the
    # three passes' floor reads and writes the volume once a pass
    row["edt_bytes_bound_ms"] = (2 * 4 * mask.numel()
                                 / HBM_BYTES_PER_S * 1e3)
    row["edt_pass_floor_ms"] = EDT_LAUNCHES * row["edt_bytes_bound_ms"]

    pooled, n = metrics.pooled_distances(o, t)
    ks = metrics.percentile_ranks(n)
    vmax = metrics.VMAX
    row["search_ms"] = time_ms(
        lambda: orderstats.masked_order_stats(pooled, ks, vmax), 10)
    row["search_device_ms"] = queued_ms(
        lambda: orderstats.masked_order_stats(pooled, ks, vmax), 10)
    row["search_plain_ms"] = time_ms(
        lambda: orderstats.masked_order_stats_plain(pooled, ks, vmax), 2, 1)
    pairs_ck = [(c, k) for c in range(3) for k in ks[c].tolist()]
    row["kthvalue_ms"] = time_ms(
        lambda: [torch.kthvalue(pooled[c], k + 1) for c, k in pairs_ck], 3)
    kth = torch.stack([torch.kthvalue(pooled[c], k + 1).values
                       for c, k in pairs_ck]).reshape(3, 2)
    if not torch.equal(kth, orderstats.masked_order_stats(pooled, ks, vmax)):
        raise AssertionError("torch.kthvalue disagrees with the search")
    # bytes: the pooled values read once (the ranks and the output are a
    # few bytes); the 7-pass search's floor reads them once a pass.
    # Operations: at least one compare per value
    row["search_bytes_bound_ms"] = (4 * pooled.numel()
                                    / HBM_BYTES_PER_S * 1e3)
    row["search_ops_bound_ms"] = pooled.numel() / F32_INSTR * 1e3
    row["search_pass_floor_ms"] = (SEARCH_LAUNCHES
                                   * row["search_bytes_bound_ms"])
    row["pooled_shape"] = list(pooled.shape)
    row["pooled_finite"] = n.tolist()

    dm = metrics.DeviceMetrics(device=dev)
    row["device_metrics_ms"] = time_ms(lambda: dm(out_lbl, tgt_lbl), 5)
    t0 = time.perf_counter()
    metrics.cal_hausdorff(pred, tgt, True)
    row["host_cal_hausdorff_s"] = time.perf_counter() - t0
    log(timing="metrics", unit="per 240x240x155 volume", **row)
    return row


# ---- fused dispatch (Predictor(fuse_dispatch=True)) and profiling ----

# the fused-dispatch phase's engines: (UNet path, quantize spec)
FUSED_PATHS = {"direct": ("direct", "none"), "s2d": ("s2d", "none"),
               "direct_int8": ("direct", "int8"),
               "s2d_int8": ("s2d", "int8")}
FUSED_ROUNDS = 2                 # timed rounds over the volumes, in turns
# profiles taken of one call before its kernel counts are judged: a graph
# replays the same nodes each time, so a profile that shows fewer of them
# than another lost device events (torch.profiler has dropped a kernel of
# a replay late in a long run); a kernel missing from the graph is missing
# from every profile and still fails
PROFILE_ATTEMPTS = 3
# the port's kernels, by the name of their __global__ function
PORT_KERNELS = ("norm_kernel", "attention_mma_kernel",
                "attention_simt_kernel", "s2d_kernel", "tma_conv_kernel",
                "mma_sync_conv_kernel", "grid_kernel", "from_amax_kernel")
_PORT_KERNEL = re.compile(r"(?:^|[\s:])(" + "|".join(PORT_KERNELS)
                          + r")<([^>]*)>")
NORM_MODES = {"0": "stats", "1": "apply", "2": "fused"}
# each launch counter and the kernels its launches run
COUNTER_KERNELS = {
    "fused_instance_norm_act+fused_instance_norm_act_amax": (
        "norm_kernel/stats", "norm_kernel/apply", "norm_kernel/fused"),
    "fused_attention": ("attention_mma_kernel", "attention_simt_kernel"),
    "space_to_depth": ("s2d_kernel",),
    "int8_conv3d": ("tma_conv_kernel", "mma_sync_conv_kernel"),
    "quantize_absmax": ("grid_kernel",),
    "quantize_from_amax": ("from_amax_kernel",)}
# one B=8 full-width forward, counted by tests/test_torch_profiling.py
FULL_FLOPS = 4_257_332_019_200
FULL_PARAMS = 16_824_556
A8_TOP = 15


def port_kernels(prof) -> collections.Counter:
    """The port's kernels among a profile's device events, by function
    name; K1's by its mode (``norm_kernel/fused``: the fused route's
    cooperative kernel, ``/stats`` and ``/apply``: the split route's)."""
    found = collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = _PORT_KERNEL.search(e.name)
        if m:
            name = m.group(1)
            if name == "norm_kernel":
                name += "/" + NORM_MODES[m.group(2).split(",")[2].strip()]
            found[name] += 1
    return found


def profiled(fn):
    """(profile, fn()) with the card's events recorded."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return prof, out


def event_ms(fn) -> float:
    """One call of ``fn`` timed with CUDA events to a synchronise."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def check_replays(name, staged, fused, volumes):
    """The fused engine's first call warms up, captures and replays (its
    launch counters twice an eager call's: the capture's count is taken
    back); then every volume is replayed (the first again at the end) and
    held torch.equal to the staged engine's eager tiled_probs, each replay
    counting an eager call's launches; one replay and one eager call
    under torch.profiler launch the same port kernels, the eager call as
    many as its launch counters say, K1's fused route among them (and K7's
    grid route under int8); the pair is profiled again, up to
    PROFILE_ATTEMPTS times, while the counts disagree, and every attempt's
    counts are logged."""
    reset_launches()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    outs = [fused.tiled_probs(volumes[0])]
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    pool = torch.cuda.memory_reserved() - reserved
    capture_launches = read_launches()
    reset_launches()
    outs += [fused.tiled_probs(v) for v in (*volumes[1:], volumes[0])]
    torch.cuda.synchronize()
    replay_launches = read_launches()
    equal = []
    for v, out in zip((*volumes, volumes[0]), outs):
        reset_launches()
        want = staged.tiled_probs(v)
        eager_launches = read_launches()
        equal.append(torch.equal(out, want))
        del want
    del outs
    counted = {c: sum(eager_launches[k] for k in c.split("+"))
               for c in COUNTER_KERNELS}
    attempts = []
    for _ in range(PROFILE_ATTEMPTS):
        prof_f, _ = profiled(lambda: fused.tiled_probs(volumes[1]))
        prof_s, _ = profiled(lambda: staged.tiled_probs(volumes[1]))
        replayed, eager = port_kernels(prof_f), port_kernels(prof_s)
        by_counter = {c: sum(eager[k] for k in ks)
                      for c, ks in COUNTER_KERNELS.items()}
        attempts.append([dict(replayed), dict(eager)])
        if replayed == eager and by_counter == counted:
            break
    int8 = eager_launches["int8_conv3d"] > 0
    row = dict(capture_s=capture_s, graph_pool_bytes=pool,
               replays=len(equal),
               replays_equal_eager=equal, replayed_kernels=dict(replayed),
               eager_kernels=dict(eager), eager_launch_counters=counted,
               profile_attempts=attempts,
               capture_launches=capture_launches,
               fused_busy_ms=device_busy_ms(prof_f),
               staged_busy_ms=device_busy_ms(prof_s))
    ok = (all(equal) and replayed == eager and by_counter == counted
          and all(replay_launches[k] == len(volumes) * eager_launches[k]
                  for k in replay_launches)
          and all(capture_launches[k] == 2 * eager_launches[k]
                  for k in capture_launches)
          and replayed["norm_kernel/fused"] > 0
          and (not int8 or replayed["grid_kernel"] > 0))
    log(check="fused_dispatch_replays", path=name, ok=ok, **row)
    if not ok:
        raise AssertionError(f"fused dispatch ({name}): {row}")
    return row


def time_fused(name, staged, fused, volumes, row):
    """tiled_probs a volume, the two engines in turns over FUSED_ROUNDS
    rounds of the volumes: median and spread of each, its idle share (the
    profiled call's busy time against the median), and its peak memory
    after a cache flush: allocated, and the footprint, which for the fused
    engine adds the graph's pool (what its replays use, allocated at the
    capture)."""
    engines = {"staged": staged, "fused": fused}
    times = collections.defaultdict(list)
    for r in range(FUSED_ROUNDS):
        for i, v in enumerate(volumes):
            order = (("staged", "fused") if (r * len(volumes) + i) % 2 == 0
                     else ("fused", "staged"))
            for k in order:
                times[k].append(event_ms(lambda: engines[k].tiled_probs(v)))
    out = {}
    for k, engine in engines.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine.tiled_probs(volumes[0])
        torch.cuda.synchronize()
        med = statistics.median(times[k])
        peak = torch.cuda.max_memory_allocated()
        out[k] = dict(ms=times[k], median_ms=med,
                      spread_ms=[min(times[k]), max(times[k])],
                      device_busy_ms=row[f"{k}_busy_ms"],
                      idle_share=1 - row[f"{k}_busy_ms"] / med,
                      peak_allocated_bytes=peak,
                      footprint_bytes=peak + (row["graph_pool_bytes"]
                                              if k == "fused" else 0))
    out["fused_vs_staged"] = out["fused"]["median_ms"] / out["staged"][
        "median_ms"] - 1
    log(timing="fused_dispatch", path=name, engine="tiled_probs",
        dtype="bfloat16", unit="ms per volume, engines in turns", **out)
    return out


def check_update(name, staged, fused, volumes, weights2):
    """update_params on the fused engine (whose model the staged engine
    shares): its replays change and equal the eager forward under the new
    weights."""
    before = fused.tiled_probs(volumes[0])
    fused.update_params(weights2)
    after = [fused.tiled_probs(v) for v in volumes[:2]]
    equal = [torch.equal(a, staged.tiled_probs(v))
             for a, v in zip(after, volumes)]
    changed = not torch.equal(before, after[0])
    ok = all(equal) and changed
    log(check="fused_dispatch_update_params", path=name, ok=ok,
        replays_equal_eager=equal, answer_changed=changed)
    if not ok:
        raise AssertionError(f"fused replay after update_params ({name})")


def check_graph_replay(dev):
    """K1's fused route and K7's grid route, the two cooperative kernels
    with a barrier, captured in one CUDA graph (with workspaces the graph
    owns) and replayed on 3 inputs in turn, then the first again: each
    replay torch.equal to an eager call on the same input (a replay that
    read its barrier's earlier generation would read stale statistics),
    and a profiled replay runs both kernels."""
    g = gen(dev, SEED + 30)
    shape = (8, 32, 32, 32, 64)
    if fusednorm.plan_for(shape, torch.bfloat16, 8, False,
                          torch.cuda.current_device()).route != "fused":
        raise AssertionError(f"fusednorm at {shape} is not on its fused "
                             "route")
    xs = [torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
          for _ in range(3)]

    def step(x):
        y = fusednorm.fused_instance_norm_act(x, shape[-1], act="relu")
        return (y, *quant.quantize_absmax(y))

    static = xs[0].clone()
    graph, owned = torch.cuda.CUDAGraph(), {}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with _build.owned_workspaces(owned):
        with torch.cuda.stream(side):
            step(static)
        with torch.cuda.graph(graph, stream=side):
            out = step(static)
    torch.cuda.current_stream().wait_stream(side)
    equal = []
    for x in (*xs, xs[0]):
        static.copy_(x)
        graph.replay()
        equal.append(all(torch.equal(a, b) for a, b in zip(out, step(x))))
    static.copy_(xs[1])
    want = {"norm_kernel/fused": 1, "grid_kernel": 1}
    attempts = []
    for _ in range(PROFILE_ATTEMPTS):
        prof, _ = profiled(graph.replay)
        kernels = port_kernels(prof)
        attempts.append(dict(kernels))
        if kernels == want:
            break
    ok = all(equal) and kernels == want
    log(check="graph_replay_k1_fused_k7_grid", shape=list(shape), ok=ok,
        replays_equal_eager=equal, replayed_kernels=dict(kernels),
        profile_attempts=attempts)
    if not ok:
        raise AssertionError("K1/K7 replayed in a CUDA graph differ from "
                             "eager calls")


def run_fused_dispatch(dev, cfg_kw, weights, volumes):
    """Predictor(fuse_dispatch=True) at full width, bf16, on the direct and
    s2d paths, float and int8: replays against the eager forward and their
    kernels (check_replays), both engines in turns (time_fused); on the
    direct path also fused flip TTA against staged and update_params; then
    fold_params with fuse_dispatch on direct int8, with update_params.
    Returns {path: row}."""
    weights2 = cwf.ClsWiseFormer(ModelConfig(**cfg_kw), torch.Generator(
        ).manual_seed(SEED + 1)).state_dict()
    rows = {}
    for name, (path, spec) in FUSED_PATHS.items():
        model = int8_model(dev, cfg_kw, weights, path, spec)
        staged = Predictor(model, device=dev)
        fused = Predictor(model, device=dev, fuse_dispatch=True)
        row = check_replays(name, staged, fused, volumes)
        row.update(time_fused(name, staged, fused, volumes, row))
        if name == "direct":
            g = gen(dev, SEED + 20)
            tta = []
            for _ in range(3):
                x = torch.randn((1, 128, 128, 128, 4), device=dev,
                                generator=g)
                tta.append(torch.equal(fused.tta_probs(x),
                                       staged.tta_probs(x)))
            log(check="fused_dispatch_tta", path=name, ok=all(tta),
                replays_equal_eager=tta)
            if not all(tta):
                raise AssertionError("fused tta_probs differs from staged")
            check_update(name, staged, fused, volumes, weights2)
        rows[name] = row
        del model, staged, fused
        torch.cuda.empty_cache()
    model = int8_model(dev, cfg_kw, weights, "direct", "int8")
    staged = Predictor(model, device=dev)
    both = Predictor(model, device=dev, fold_params=True, fuse_dispatch=True)
    equal = [torch.equal(both.tiled_probs(v), staged.tiled_probs(v))
             for v in (*volumes, volumes[0])]
    log(check="fused_dispatch_fold_params", path="direct_int8",
        ok=all(equal), replays_equal_eager=equal)
    if not all(equal):
        raise AssertionError("folded fused replays differ from eager")
    check_update("direct_int8_folded", staged, both, volumes, weights2)
    del model, staged, both
    torch.cuda.empty_cache()
    return rows


def copy_parents(prof) -> dict:
    """The ops that called a profile's aten::copy_, with their counts."""
    return dict(collections.Counter(
        e.cpu_parent.name if e.cpu_parent is not None else "(python)"
        for e in prof.events() if e.name == "aten::copy_"
        and e.device_type != torch.autograd.DeviceType.CUDA).most_common())


class CopySites(TorchDispatchMode):
    """Counts the calls that copy a tensor (casts, clones, contiguous and
    reshape where they copy, block_diag, repeat, scatter, padding: the
    callers of aten::copy_ as the forward dispatches them under inference
    mode) by op and by the innermost frame of the port's code on the
    Python stack that made them."""
    OPS = ("aten::to", "aten::_to_copy", "aten::clone", "aten::contiguous",
           "aten::reshape", "aten::copy_", "aten::block_diag",
           "aten::repeat", "aten::scatter", "aten::constant_pad_nd")

    def __init__(self):
        super().__init__()
        self.sites = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        if name in self.OPS and profiling.moves_data(func, args, out):
            pkg = f"{os.sep}dctseg_torch{os.sep}"
            own = [f for f in traceback.extract_stack() if pkg in f.filename]
            site = (f"{own[-1].filename.split(pkg)[-1]}:{own[-1].lineno} "
                    f"{own[-1].name}" if own else "(outside the port)")
            self.sites[name, site] += 1
        return out


def ancestors(e):
    while e.cpu_parent is not None:
        e = e.cpu_parent
        yield e.name


def attribute_forward(dev, cfg_kw, weights, vol):
    """A8: one float bf16 B=8 forward (seg_probs on the 8 crops of ``vol``)
    on each path under torch.profiler: the top A8_TOP ops by their own
    device time and their sum against the busy time, the top kernels, the
    ops that call aten::copy_ and, from one more forward under CopySites,
    the lines of the port that call them, the kernels that
    transform a layout (cuDNN's NCHW/NHWC converters, transposes), and the
    conv-bias adds (aten::add_ inside aten::_convolution; cuDNN's
    implicit GEMMs on NHWC, "nhwckrsc_nhwc", are not transforms)."""
    x = Predictor.crops(vol)
    rows = {}
    for path in PATHS:
        predictor = Predictor(int8_model(dev, cfg_kw, weights, path, "none"),
                              device=dev)
        predictor.seg_probs(x)
        torch.cuda.synchronize()
        prof, _ = profiled(lambda: predictor.seg_probs(x))
        ops = sorted((r for r in prof.key_averages()
                      if r.device_type != torch.autograd.DeviceType.CUDA),
                     key=lambda r: -r.self_device_time_total)[:A8_TOP]
        kernels = collections.defaultdict(lambda: [0, 0.0])
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = kernels[e.name[:120]]
                k[0] += 1
                k[1] += (e.time_range.end - e.time_range.start) / 1e3
        layout = {k: v for k, v in kernels.items()
                  if "implicit_gemm" not in k and re.search(
                      r"nchwtonhwc|nhwctonchw|transpose|convert|reorder|"
                      r"padding", k, re.I)}
        cpu = [e for e in prof.events()
               if e.device_type != torch.autograd.DeviceType.CUDA]
        busy = device_busy_ms(prof)
        top_ms = sum(r.self_device_time_total for r in ops) / 1e3
        rows[path] = row = dict(
            device_busy_ms=busy,
            top_ops={r.key: [r.count, r.self_device_time_total / 1e3]
                     for r in ops},
            top_ops_ms=top_ms, top_ops_share=top_ms / busy,
            top_kernels=dict(sorted(kernels.items(),
                                    key=lambda kv: -kv[1][1])[:A8_TOP]),
            kernel_launches=sum(v[0] for v in kernels.values()),
            copy_calls=sum(e.name == "aten::copy_" for e in cpu),
            copy_parents=copy_parents(prof),
            layout_kernels=layout,
            convolutions=sum(e.name == "aten::convolution" for e in cpu),
            conv_bias_adds=sum(e.name == "aten::add_"
                               and "aten::_convolution" in ancestors(e)
                               for e in cpu))
        with CopySites() as sites:
            predictor.seg_probs(x)
        row["copy_sites"] = {f"{op} {site}": n for (op, site), n
                             in sites.sites.most_common(A8_TOP)}
        log(phase="a8_forward", path=path, dtype="bfloat16", batch=8,
            unit="ms of device time, [calls, ms] per op / kernel", **row)
        del predictor
    return rows


def run_profiling(dev, cfg_kw, weights):
    """The profiling module at full width: profile_model of a B=8 forward
    on fake tensors on the card (nothing runs), its parameters and flops
    held to the counts the CPU tests pin."""
    model = cwf.build_model(ModelConfig(**cfg_kw), device=dev)
    model.load_state_dict(weights, strict=True)
    t0 = time.perf_counter()
    stats = profiling.profile_model(
        model, torch.zeros((8, 128, 128, 128, 4), device=dev))
    ok = stats["params"] == FULL_PARAMS and stats["flops"] == FULL_FLOPS
    log(phase="profile_model", batch=8, seconds=time.perf_counter() - t0,
        flops_readable=profiling.clever_format(stats["flops"]), ok=ok,
        **stats)
    if not ok:
        raise AssertionError(f"profile_model at full width: {stats}")
    return stats


# ------------------------------- multi-GPU (A12), the conv VJP (A10) -----
#
# The card's machine has one H100, and NCCL takes no two ranks on one
# device, so the space axis runs two ranks on the one card over a gloo
# group (parallel/spatial.py GLOO_CUDA_OPS: gloo takes CUDA tensors in the
# two operations the space axis uses); the data axis runs one rank over
# NCCL (parallel_train).  Multi-card speed is not measured here.

SPACE_RANKS = 2
# sharded bf16 tiled_probs against the unsharded fp32 engine, beside the
# unsharded bf16 engine against it: the sharded sums run in other orders
# (the halo'd convs' shapes, the statistics in two parts), which bf16 and
# random weights with many near-tied classes amplify, so the sharded bf16
# forward is held to stay as close to the fp32 function as the unsharded
# one (mean |dp| at most SPACE_DRIFT times as far, argmax agreement at
# most SPACE_AGREE_LOSS lower); fp32 sharded against fp32 unsharded is held
# within 1e-3, as check_fp32_paths holds the kernels' paths
SPACE_DRIFT = 1.5
SPACE_AGREE_LOSS = 0.005
# spatial_train: the gradient difference of a parameter group (a
# top-level module) from one rank's unsharded step, its L2 norm relative
# to the group's gradient's (the largest element's difference, relative to
# the group's largest gradient, is printed beside it).  At full width some
# ReLU / LeakyReLU inputs lie within rounding of zero, and the sharded
# sums' other order puts them on the other side of the kink: that element's
# derivative changes by 99-100 %, and the change spreads through the
# backward (one such flip, in a tiny img_dim 32 model on the CPU, moved
# sum_fusion's gradient by 2.5e-3).  A wrong gradient scale moves a group
# by 0.5 or more, a lost halo cotangent by a plane's share of it.  In
# bf16 a rounding is 2^-8 and such flips are everywhere, so the bf16 step
# is held to the f32 gradient: at most SPACE_BF16_SLACK times as far from
# it as the unsharded bf16 step, plus SPACE_GRAD_RTOL
SPACE_GRAD_RTOL = 1e-2
SPACE_BF16_SLACK = 1.5
PARALLEL_STEPS = 6                # parallel_train: B=1 steps per run


def check_fusednorm_ext(dev, widths, batch=8):
    """K1's external-statistics variant (fused_norm_stats, then
    fused_norm_apply) at the slab shapes the space axis gives it (B=8, D
    cut in two) and on the s2d views, f32 and bf16, relu and lrelu with a
    residual: the two slabs' kernel sums against the plain sums (within
    1e-4 of the sums of |x| and of x^2: another order of f32 adds), then
    each slab normed with their total and the whole count and
    concatenated, within check_fusednorm's bounds of the plain fused norm
    of the whole tensor; a slab with its own sums and count torch.equal to
    the split route of fused_instance_norm_act where its plan is split;
    one launch per call on each counter.  Then the same with absmax slots
    (the int8 forward on a slab: fused_norm_stats_amax, then
    fused_norm_apply_amax): its output within the same bounds, each slab's
    slots torch.equal to the per-sample max |out| of its own output, and a
    slab with its own sums torch.equal, output and slots, to
    fused_instance_norm_act_amax where that variant's plan is split.
    Returns the largest bf16 error at the main path's widths, of the
    plain pair and of the pair with slots."""
    g = gen(dev, SEED + 11)
    cases = []
    for edge, c in widths:
        shape = (batch, edge, edge, edge, c)
        cases += [(shape, c, "relu", False), (shape, c, "lrelu", True)]
    cases += [((batch, 64, 64, 64, 128), 16, "relu", False),
              ((batch, 32, 32, 32, 256), 32, "lrelu", True)]
    worst, worst_amax, split_seen, amax_split_seen = 0.0, 0.0, False, False
    for shape, fine, act, with_res in cases:
        x32 = torch.randn(shape, device=dev, generator=g) * 3 + 1
        r32 = torch.randn(shape, device=dev, generator=g)
        for dt in (torch.float32, torch.bfloat16):
            x, r = x32.to(dt), (r32.to(dt) if with_res else None)
            halves = [t.contiguous() for t in x.chunk(2, dim=1)]
            rh = ([None, None] if r is None
                  else [t.contiguous() for t in r.chunk(2, dim=1)])
            before = (fusednorm.fused_norm_stats.launches,
                      fusednorm.fused_norm_apply.launches)
            sums = [fusednorm.fused_norm_stats(h, fine) for h in halves]
            count = 2 * fusednorm.norm_count(halves[0], fine)
            total = sums[0] + sums[1]
            got = torch.cat([fusednorm.fused_norm_apply(
                h, total, count, fine, act=act, residual=rr)
                for h, rr in zip(halves, rh)], dim=1)
            launched = (fusednorm.fused_norm_stats.launches - before[0],
                        fusednorm.fused_norm_apply.launches - before[1])
            sum_err = 0.0
            for h, s in zip(halves, sums):
                want_s = fusednorm.fused_norm_stats_plain(h, fine)
                scale = torch.stack(
                    [fusednorm.fused_norm_stats_plain(h.abs(), fine)[:, 0],
                     want_s[:, 1]], dim=1)
                sum_err = max(sum_err, ((s - want_s).abs()
                                        / scale.clamp(min=1e-30)).max().item())
            want = fusednorm.fused_instance_norm_act_plain(x, fine, act=act,
                                                           residual=r)
            within, err, tol, over_ulps = norm_within_bounds(got, want, x,
                                                             fine, act, r)
            route = fusednorm.plan_for(
                tuple(halves[0].shape), dt, fusednorm.vector_width(halves[0]),
                with_res, 0).route
            own_bits = None
            if route == "split":
                split_seen = True
                own_bits = torch.equal(
                    fusednorm.fused_norm_apply(
                        halves[0], sums[0], count / 2, fine, act=act,
                        residual=rh[0]),
                    fusednorm.fused_instance_norm_act(
                        halves[0], fine, act=act, residual=rh[0]))
            if dt == torch.bfloat16 and shape[-1] == fine:
                worst = max(worst, err.max().item())
            ok = (within and sum_err <= 1e-4 and launched == (2, 2)
                  and own_bits is not False)
            # with absmax slots
            before = (fusednorm.fused_norm_stats_amax.launches,
                      fusednorm.fused_norm_apply_amax.launches)
            st = [fusednorm.fused_norm_stats_amax(h, fine) for h in halves]
            total_a = st[0][0] + st[1][0]
            outs = [fusednorm.fused_norm_apply_amax(
                h, total_a, slots, count, fine, act=act, residual=rr)
                for h, (_, slots), rr in zip(halves, st, rh)]
            launched_a = (fusednorm.fused_norm_stats_amax.launches
                          - before[0],
                          fusednorm.fused_norm_apply_amax.launches
                          - before[1])
            slots_equal = all(torch.equal(
                a, o.reshape(shape[0], -1).float().abs().amax(dim=1))
                for o, a in outs)
            within_a, err_a, _, over_a = norm_within_bounds(
                torch.cat([o for o, _ in outs], dim=1), want, x, fine, act,
                r)
            route_a = fusednorm.plan_for(
                tuple(halves[0].shape), dt, fusednorm.vector_width(halves[0]),
                with_res, 0, True).route
            own_a = None
            if route_a == "split":
                amax_split_seen = True
                o1, a1 = fusednorm.fused_norm_apply_amax(
                    halves[0], *fusednorm.fused_norm_stats_amax(halves[0],
                                                                fine),
                    count / 2, fine, act=act, residual=rh[0])
                o2, a2 = fusednorm.fused_instance_norm_act_amax(
                    halves[0], fine, act=act, residual=rh[0])
                own_a = torch.equal(o1, o2) and torch.equal(a1, a2)
            if dt == torch.bfloat16 and shape[-1] == fine:
                worst_amax = max(worst_amax, err_a.max().item())
            ok = (ok and within_a and slots_equal and launched_a == (2, 2)
                  and own_a is not False)
            log(check="fusednorm_ext", shape=list(shape), slabs=2,
                fine=fine, act=act, residual=with_res, dtype=str(dt),
                launches=launched, sums_rel_err=sum_err,
                max_abs_err=err.max().item(), tol=tol, over_ulps=over_ulps,
                slab_route=route, own_sums_equal_split_route=own_bits,
                amax=dict(launches=launched_a, max_abs_err=err_a.max().item(),
                          over_ulps=over_a, within_bounds=within_a,
                          slots_equal_max_abs_out=slots_equal,
                          slab_route=route_a,
                          own_sums_equal_amax_variant=own_a),
                ok=ok)
            if not ok:
                raise AssertionError(f"fusednorm external statistics at "
                                     f"{shape} {fine} {act} {dt}")
            del got, want, err, halves, rh, sums, st, outs, err_a
    if not (split_seen and amax_split_seen):
        raise AssertionError("no slab ran the split route's arithmetic")
    torch.cuda.synchronize()
    return worst, worst_amax


def time_fusednorm_ext(dev, widths, batch=8, iters=10):
    """The external-statistics pair (stats, then apply) per bf16 slab
    forward of a space=2 rank, over the 32 norm calls: the kernels, the
    plain versions, and the bound (x read once, the output written once,
    the residual read once), at each width's slab (D cut in two)."""
    g = gen(dev, SEED + 12)
    row = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, device_ms=0.0,
               per_width_ms={})
    for edge, c in widths:
        shape = (batch, edge // 2, edge, edge, c)
        x = torch.randn(shape, device=dev, generator=g).bfloat16()
        r = torch.randn(shape, device=dev, generator=g).bfloat16()
        count = fusednorm.norm_count(x, c) * 2
        sums = fusednorm.fused_norm_stats(x, c) * 2
        for kind, res in (("nores", None), ("res", r)):
            act = "relu" if res is None else "lrelu"

            def call():
                fusednorm.fused_norm_stats(x, c)
                return fusednorm.fused_norm_apply(x, sums, count, c, act=act,
                                                  residual=res)

            def plain():
                fusednorm.fused_norm_stats_plain(x, c)
                return fusednorm.fused_norm_apply_plain(
                    x, sums, count, c, act=act, residual=res)
            calls = NORM_CALLS[kind]
            ms, dms = time_ms(call, iters), queued_ms(call, iters)
            row["ms"] += calls * ms
            row["device_ms"] += calls * dms
            row["plain_ms"] += calls * time_ms(plain, max(2, iters // 4))
            tensor_ms = x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            row["bound_ms"] += calls * tensor_ms * (2 if res is None else 3)
            row["per_width_ms"][f"{edge // 2}x{edge}^2x{c}_{kind}"] = dict(
                ms=ms, device_ms=dms)
        del x, r
    fusednorm.fused_norm_stats.launches = 0
    fusednorm.fused_norm_apply.launches = 0
    log(timing="fusednorm_ext", unit="per B=8 bf16 slab forward of a "
        "space=2 rank (32 calls, 2 launches each)", **row)
    return row


def run_conv3_vjp(dev):
    """A10: the 3^3 stride-1 SAME conv at the s2d full-resolution shape of
    a B=1 train step (64^3 x 128 -> 128, the dense conv3 view) with
    CONV3_BWD 'explicit' against 'xla' (autograd): dx and dW in f32 (TF32
    off), each within 1e-4 of the largest entry; then forward + backward
    ms of each in bf16, in turns."""
    from dctseg_torch.ops import s2d
    g = gen(dev, SEED + 13)
    shape, co = (1, 64, 64, 64, 128), 128
    x32 = torch.randn(shape, device=dev, generator=g)
    w = torch.randn((co, shape[-1], 3, 3, 3), device=dev, generator=g) * 0.03
    b = torch.randn(co, device=dev, generator=g)
    g32 = torch.randn(shape[:-1] + (co,), device=dev, generator=g)
    row, grads = {}, {}
    try:
        for route in ("xla", "explicit"):
            s2d.CONV3_BWD = route
            xs, ws = x32.clone().requires_grad_(), w.clone().requires_grad_()
            s2d.conv3d_s2d(xs, ws, b).backward(g32)
            grads[route] = (xs.grad, ws.grad)
        for i, name in enumerate(("dx", "dw")):
            want = grads["xla"][i]
            row[f"{name}_max_abs_err"] = (grads["explicit"][i]
                                          - want).abs().max().item()
            row[f"{name}_rel_err"] = (row[f"{name}_max_abs_err"]
                                      / want.abs().max().item())
        del grads
        x16, g16 = x32.bfloat16(), g32.bfloat16()
        times = collections.defaultdict(list)
        for i in range(3):
            for route in (("xla", "explicit") if i % 2 == 0
                          else ("explicit", "xla")):
                s2d.CONV3_BWD = route
                xs = x16.clone().requires_grad_()
                ws = w.clone().requires_grad_()

                def step():
                    xs.grad = ws.grad = None
                    s2d.conv3d_s2d(xs, ws, b).backward(g16)
                times[route].append(time_ms(step, 3, warmup=1))
    finally:
        s2d.CONV3_BWD = "xla"
    for route, ms in times.items():
        row[f"{route}_ms"] = statistics.median(ms)
        row[f"{route}_spread_ms"] = [min(ms), max(ms)]
    ok = row["dx_rel_err"] <= 1e-4 and row["dw_rel_err"] <= 1e-4
    log(phase="conv3_vjp", shape=list(shape), co=co,
        unit="ms per bf16 forward + backward, median of 3 in turns",
        tol="f32 errors within 1e-4 of the largest entry", ok=ok, **row)
    if not ok:
        raise AssertionError(f"explicit conv VJP disagrees: {row}")
    return row


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_parallel_train(dev):
    """parallel_train: the train driver at full width (bf16, B=1, s2d,
    PARALLEL_STEPS steps) joined to a process group of one over NCCL
    (--num-processes 1 --process-id 0 --coordinator 127.0.0.1:<port>), so
    that DistributedDataParallel wraps the model and all-reduces every
    step, against the same seed's run without a process group: per-step
    losses within the printed tolerance, ms per step of both, and the
    all-reduces per step (DDP's buckets, nccl:all_reduce) with their
    device time under torch.profiler on the last step."""
    from dctseg_torch.parallel import distributed
    rows = {}
    for name, extra in (("single", []), ("ddp_nccl", [
            "--num-processes", "1", "--process-id", "0",
            "--coordinator", f"127.0.0.1:{free_port()}"])):
        losses, times, prof_row = [], [], {}
        orig = Trainer.train_step

        def timed(self, *a):
            last = len(times) == PARALLEL_STEPS - 1
            prof = (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) if last else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with prof or contextlib.nullcontext():
                out = orig(self, *a)
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(out["loss"].item())
            if prof is not None:
                ev = prof.events()
                prof_row.update(
                    all_reduce_calls=sum(e.name == "nccl:all_reduce"
                                         for e in ev),
                    nccl_device_ms=sum(
                        e.time_range.end - e.time_range.start for e in ev
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "nccl" in e.name.lower()) / 1e3,
                    device_busy_ms=device_busy_ms(prof),
                    top_device_ops_ms=top_device_ops(prof),
                    top_kernels_ms=top_kernels(prof))
            return out
        Trainer.train_step = timed
        try:
            with tempfile.TemporaryDirectory() as d:
                tr, _ = train.main([
                    "--amp", "--num-samples", str(PARALLEL_STEPS),
                    "--input-shape", *TRAIN_SHAPE, "--end-epoch", "1",
                    "--save-freq", "1000", "--num-workers", "2",
                    "--checkpoint-dir", f"{d}/ckpt", "--log-dir",
                    f"{d}/logs", *extra])
                wrapped = type(tr.net).__name__
                del tr
        finally:
            Trainer.train_step = orig
            distributed.shutdown()
        # steady: without the first step and the profiled last one
        rows[name] = dict(losses=losses, step_ms=times,
                          steady_step_ms=statistics.median(times[1:-1]),
                          module=wrapped, **prof_row)
        torch.cuda.empty_cache()
    single, ddp = rows["single"]["losses"], rows["ddp_nccl"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(ddp, single))
    ok = (len(ddp) == len(single) == PARALLEL_STEPS and rel <= 1e-3
          and rows["ddp_nccl"]["module"] == "DistributedDataParallel"
          and rows["ddp_nccl"]["all_reduce_calls"] > 0
          and all(math.isfinite(v) for v in ddp))
    log(phase="parallel_train", entry="dctseg_torch.cli.train",
        backend="nccl", world=1, dtype="bfloat16", batch=1,
        loss_rel_err=rel, tol="per-step losses within 1e-3 relative "
        "(cuDNN's backward is not bit-deterministic)", ok=ok, **rows)
    if not ok:
        raise AssertionError(f"parallel_train failed: {rows}")
    return rows


@contextlib.contextmanager
def comm_timed(rows):
    """Time every collective of parallel/spatial.py, the card synchronised
    before and after each: rows[kind] = {calls, ms, bytes}, kind the
    function of the forward that called it (halo_exchange, reduce_stats,
    gather, reduce_amax: the int8 scale's MAX, all_gather_cat: the data
    axis' rows) or 'backward' (the autograd functions' backward)."""
    from dctseg_torch.parallel import spatial
    kind, origs = ["backward"], {}

    def labelled(name):
        def call(*a, **kw):
            kind.append(name)
            try:
                return origs[name](*a, **kw)
            finally:
                kind.pop()
        return call

    def timed(name):
        def call(t, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = origs[name](t, *a, **kw)
            torch.cuda.synchronize()
            r = rows.setdefault(kind[-1], dict(calls=0, ms=0.0, bytes=0))
            r["calls"] += 1
            r["ms"] += (time.perf_counter() - t0) * 1e3
            r["bytes"] += t.numel() * t.element_size()
            return out
        return call
    for name, wrap in (("halo_exchange", labelled), ("reduce_stats", labelled),
                       ("gather", labelled), ("reduce_amax", labelled),
                       ("all_gather_cat", labelled), ("all_gather", timed),
                       ("all_reduce", timed)):
        origs[name] = getattr(spatial, name)
        setattr(spatial, name, wrap(name))
    try:
        yield rows
    finally:
        for name, f in origs.items():
            setattr(spatial, name, f)


def check_transport(m, dev) -> dict:
    """The space axis' two collectives on CUDA tensors over the gloo group,
    as they are (no host staging): each rank's values gathered in rank
    order and summed, exactly."""
    from dctseg_torch.parallel import spatial
    r = m.space_index
    t = torch.arange(6, device=dev, dtype=torch.float32).reshape(1, 2, 3) \
        + 100 * r
    got = spatial.all_gather_cat(t, m.space_group, 1)
    want = torch.cat([t - 100 * r + 100 * i for i in range(m.space)], 1)
    total = spatial.all_reduce(t, m.space_group)
    ok = (got.is_cuda and torch.equal(got, want) and torch.equal(
        total, sum(t - 100 * r + 100 * i for i in range(m.space))))
    if not ok:
        raise AssertionError("gloo collectives on CUDA tensors disagree")
    return {"all_gather": "cuda tensors, direct",
            "all_reduce": "cuda tensors, direct"}


def _space_entry(rank, job, store, out):
    """One rank of a space=2 phase on the one card (a gloo group)."""
    from dctseg_torch.parallel import distributed, mesh
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = distributed.initialize(f"file://{store}", SPACE_RANKS, rank,
                                 device="cuda", backend="gloo")
    m = mesh.make_mesh(spatial=SPACE_RANKS)
    try:
        res = {"forward": _space_forward, "train": _space_train,
               "int8": _space_int8}[job](rank, m, dev)
        if rank == 0:
            torch.save(res, out)
    finally:
        distributed.barrier("chip_smoke:space_done")
        distributed.shutdown()


def run_space_phase(job):
    """Run ``job`` on SPACE_RANKS processes sharing the card; rank 0's
    result."""
    import torch.multiprocessing as mp
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "result.pt")
        mp.spawn(_space_entry, args=(job, os.path.join(d, "store"), out),
                 nprocs=SPACE_RANKS, join=True)
        return torch.load(out, weights_only=False)


def _full_model(dev, **flags):
    cfg_kw = dict(img_dim=128, base_channels=16, num_heads=8, top_num=128,
                  pe_type="fixed")
    weights = cwf.ClsWiseFormer(ModelConfig(**cfg_kw),
                                torch.Generator().manual_seed(SEED)
                                ).state_dict()
    model = cwf.build_model(ModelConfig(**cfg_kw, **flags), device=dev)
    model.load_state_dict(weights, strict=True)
    return model


def _space_forward(rank, m, dev):
    """spatial_forward on one rank: bf16 tiled_probs of one seeded
    240x240x160 volume over (data=1, space=2), its launches, ms and peak
    memory; then fp32 seg_probs of its 8 crops.  Rank 0 then runs the
    unsharded engine on the same inputs and compares."""
    from dctseg_torch.parallel import distributed, spatial
    model = _full_model(dev)
    vol = torch.randn(VOLUME, device=dev, generator=gen(dev, SEED + 21))
    sharded = Predictor(model, device=dev, mesh=m)
    row = dict(transport=check_transport(m, dev), backend="gloo",
               mesh=m.shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    probs = sharded.tiled_probs(vol)
    torch.cuda.synchronize()
    launches = read_launches()
    row["launches"] = {k: launches[k] for k in (
        "fused_instance_norm_act", "fused_norm_stats", "fused_norm_apply",
        "fused_attention", "attention_mma")}
    times = []
    for _ in range(3):
        distributed.barrier("chip_smoke:timed")
        t0 = time.perf_counter()
        sharded.tiled_probs(vol)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    row.update(volume_ms=statistics.median(times), volume_ms_all=times,
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    # one more volume with every collective timed apart
    distributed.barrier("chip_smoke:comm")
    with comm_timed({}) as comm:
        t0 = time.perf_counter()
        sharded.tiled_probs(vol)
        torch.cuda.synchronize()
    row.update(comm_per_volume=comm,
               comm_timed_volume_ms=(time.perf_counter() - t0) * 1e3)
    model32 = _full_model(dev, compute_dtype="float32")
    crops = Predictor.crops(vol)
    p32 = Predictor(model32, device=dev, mesh=m).seg_probs(crops)
    peaks = spatial.all_gather_cat(
        torch.tensor([row["peak_memory_bytes"]], device=dev),
        m.space_group, 0).tolist()
    if rank != 0:
        return None
    del sharded
    row["rank_peak_memory_bytes"] = peaks
    whole = Predictor(model, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = whole.tiled_probs(vol)
    torch.cuda.synchronize()
    row["unsharded_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        whole.tiled_probs(vol)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    row["unsharded_volume_ms"] = statistics.median(times)
    d = (probs - want).abs()
    row.update(max_abs_dprob=d.max().item(), mean_abs_dprob=d.mean().item(),
               argmax_agreement=(probs.argmax(-1) == want.argmax(-1)
                                 ).float().mean().item(),
               sum_err=(probs.sum(-1) - 1).abs().max().item(),
               shape=list(probs.shape))
    want32 = Predictor(model32, device=dev).seg_probs(crops)
    row["fp32_seg_probs_max_abs_dprob"] = (p32 - want32).abs().max().item()
    del want32, p32
    ref = Predictor(model32, device=dev).tiled_probs(vol)
    for name, p in (("sharded", probs), ("unsharded", want)):
        row[f"{name}_bf16_vs_fp32"] = dict(
            mean_abs_dprob=(p - ref).abs().mean().item(),
            argmax_agreement=(p.argmax(-1) == ref.argmax(-1)).float().mean()
            .item())
    return row


# the plain versions of K1, K6 and K7: none may run on the card's paths
PLAIN_FUNCS = ((quant, "quantize_absmax_plain"),
               (quant, "quantize_from_amax_plain"),
               (quant, "quantize_amax_plain"), (quant, "int8_conv3d_plain"),
               (fusednorm, "fused_norm_stats_plain"),
               (fusednorm, "fused_norm_apply_plain"),
               (fusednorm, "fused_norm_apply_amax_plain"),
               (fusednorm, "fused_instance_norm_act_plain"),
               (fusednorm, "fused_instance_norm_act_amax_plain"))
# the int8 meshes on two ranks of the card: (data, space)
INT8_MESHES = {"data1_space2": (1, 2), "data2_space1": (2, 1)}
INT8_MESH_TIMED = 2               # timed volumes a mesh, after the counted
# fp32 int8 seg_probs of a volume's 8 crops on a mesh against unsharded.
# The mesh sums the norms' statistics in another order: the first int8
# conv's absmax moves by ulps, every x / sx with it, values near a .5
# boundary round to the neighbouring int8 value, and 25 int8 convs in a
# row carry that on (the K7 stats of the two forwards drift apart call by
# call, and the couplers route other tokens), where the float forward
# stays within 1e-6.  The witness is that sensitivity itself: the
# unsharded fp32 int8 forward on its input nudged one ulp toward zero,
# against itself; the mesh's fp32 drift (mean |dp|) is held to at most
# INT8_MESH_WITNESS times the witness's.
INT8_MESH_WITNESS = 2.0


@contextlib.contextmanager
def recording_int8(k7, norms, plain, sigs=None):
    """Record every K7 call of the model (x's shape, its route over the
    mesh, its stats) into ``k7``, every K1 external-statistics call with
    absmax slots (shape, fine channels, residual) into ``norms``, and
    count calls of the plain versions into ``plain``.  With ``sigs`` (a
    dict of sets), also the arguments every other kernel of the forward
    took: sigs["k6"] K6's (xq shape, wq shape, stride, padding, bias,
    output dtype), sigs["k1"] K1's (variant, shape, dtype, fine channels,
    eps, act, residual), the variant one of "fused", "amax" (its absmax
    variant), "ext", "ext_amax" (the external-statistics pair without and
    with slots), and sigs["k2"] K2's (q shape, N2, dtype).  K6's wrapper
    counts its launches on the function the module holds under its name:
    the recording one takes them and hands them on at the end."""
    sigs = collections.defaultdict(set) if sigs is None else sigs
    orig_k7, orig_k6 = quant.quantize_input, quant.int8_conv3d
    norm_names = {"fused": "fused_instance_norm_act",
                  "amax": "fused_instance_norm_act_amax",
                  "ext": "fused_norm_apply",
                  "ext_amax": "fused_norm_apply_amax"}
    orig_norms = {kind: getattr(unet, name)
                  for kind, name in norm_names.items()}
    orig_attn = attn_model.fused_attention
    origs = [(mod, name, getattr(mod, name)) for mod, name in PLAIN_FUNCS]

    def k7_recording(x, amax=None):
        xq, stats = orig_k7(x, amax)
        k7.append((tuple(x.shape), "amax" if amax is None else "from_amax",
                   stats))
        return xq, stats

    def k6_recording(xq, stats, wq, sw, bias, stride, padding, out_dtype):
        sigs["k6"].add((tuple(xq.shape), tuple(wq.shape),
                        quant._triple(stride), quant._pairs(padding),
                        bias is not None, out_dtype))
        return orig_k6(xq, stats, wq, sw, bias, stride, padding, out_dtype)
    k6_recording.launches, k6_recording.routes = 0, orig_k6.routes

    def norm_recording(kind):
        fn = orig_norms[kind]

        def one_call(x, fine, eps, act, residual):
            sigs["k1"].add((kind, tuple(x.shape), x.dtype, fine, eps, act,
                            residual is not None))
            return fn(x, fine, eps, act=act, residual=residual)

        def ext(x, sums, *slots, **kw):
            sigs["k1"].add((kind, tuple(x.shape), x.dtype,
                            kw["fine_channels"], kw["eps"], kw["act"],
                            kw["residual"] is not None))
            if slots:
                norms.append((tuple(x.shape), kw["fine_channels"],
                              kw["residual"] is not None))
            return fn(x, sums, *slots, **kw)
        return ext if kind.startswith("ext") else one_call

    def attn_recording(q, k, v, scale):
        sigs["k2"].add((tuple(q.shape), k.shape[2], q.dtype))
        return orig_attn(q, k, v, scale)

    def counted(name, fn):
        def call(*a, **kw):
            plain[name] += 1
            return fn(*a, **kw)
        return call
    quant.quantize_input, quant.int8_conv3d = k7_recording, k6_recording
    for kind, name in norm_names.items():
        setattr(unet, name, norm_recording(kind))
    attn_model.fused_attention = attn_recording
    for mod, name, fn in origs:
        setattr(mod, name, counted(name, fn))
    try:
        yield
    finally:
        quant.quantize_input, quant.int8_conv3d = orig_k7, orig_k6
        orig_k6.launches += k6_recording.launches
        for kind, name in norm_names.items():
            setattr(unet, name, orig_norms[kind])
        attn_model.fused_attention = orig_attn
        for mod, name, fn in origs:
            setattr(mod, name, fn)


def drift(got, want) -> dict:
    d = (got - want).abs()
    return dict(max_abs_dprob=d.max().item(), mean_abs_dprob=d.mean().item(),
                argmax_agreement=(got.argmax(-1) == want.argmax(-1)).float()
                .mean().item())


def fp32_int8(predictor, crops):
    """(seg_probs, every K7 call's amax, every top-k routing) of one fp32
    int8 forward on ``crops``."""
    k7, routes = [], []
    orig_topk = record_topk(routes)
    try:
        with recording_int8(k7, [], collections.Counter()):
            p = predictor.seg_probs(crops)
    finally:
        cwf.topk_select = orig_topk
    return p, torch.stack([stats[0] for _, _, stats in k7]), routes


# the exact int8 halo check on a space axis: the direct path's first int8
# conv input (B=8, 32^3 x 64) through a 3^3 conv of stride 1 and of stride
# 2 and a 1x1 conv, as (out channels, kernel, stride)
HALO_X = (8, 32, 32, 32, 64)
HALO_CONVS = {"conv3_s1": (64, 3, 1), "conv3_s2": (128, 3, 2),
              "pw": (32, 1, 1)}


def halo_int8_convs(m, dev):
    """On each rank of a space mesh ``m``: one seeded bf16 tensor
    quantized whole (K7's grid route), this rank's D slab of it and of its
    xq through quant.conv3d_int8_prepared under the space group (the int8
    halo exchanged, K6 with D padding (0, 0)) for each of HALO_CONVS, the
    slabs' outputs gathered; torch.equal to int8_conv3d_plain of the whole
    xq.  Returns {conv: (equal, max |difference|, K6's slab shape)}."""
    from dctseg_torch.parallel import spatial
    g = gen(dev, SEED + 25)
    x = torch.randn(HALO_X, device=dev, generator=g).bfloat16()
    xq, stats = quant.quantize_absmax(x)
    shard = spatial.space_shard(m)
    d = x.shape[1] // shard.size
    part = slice(shard.index * d, (shard.index + 1) * d)
    rows = {}
    for name, (co, k, stride) in HALO_CONVS.items():
        w = torch.randn((co, x.shape[-1], k, k, k), device=dev,
                        generator=g) * 0.05
        bias = torch.randn(co, device=dev, generator=g)
        wq, sw = quant.prepare_weight(w)
        sigs = collections.defaultdict(set)
        with recording_int8([], [], collections.Counter(), sigs), \
                spatial.sharded(shard):
            y = spatial.gather(quant.conv3d_int8_prepared(
                x[:, part].contiguous(), wq, sw, stride, k // 2, bias,
                quantized=(xq[:, part].contiguous(), stats)), shard)
        want = quant.int8_conv3d_plain(xq, stats, wq, sw, bias.bfloat16(),
                                       stride, k // 2, torch.bfloat16)
        (sig,) = sigs["k6"]
        rows[name] = dict(equal=torch.equal(y, want),
                          max_abs_err=(y.float() - want.float()).abs().max()
                          .item(), k6_x=list(sig[0]),
                          k6_padding=[list(p) for p in sig[3]])
    return rows


def _space_int8(rank, m, dev):
    """spatial_int8 on one rank: bf16 int8 tiled_probs (direct path) of
    one seeded 240x240x160 volume over each mesh of INT8_MESHES, two
    ranks of the card: one counted volume (launches, every K7 call's shape,
    route and stats, the K1 calls with absmax slots, the arguments of
    every K6, K1 and K2 call, the plain versions' calls; every rank's
    launches and stats gathered to rank 0), then INT8_MESH_TIMED timed
    volumes and one with every collective timed apart; on a space axis the
    exact halo'd int8 convs (halo_int8_convs).  Rank 0 then runs the
    unsharded int8 engine on the same volume and compares; then fp32 int8
    seg_probs of the volume's 8 crops on each mesh against unsharded
    (every K7 call's amax and every routing compared), and the unsharded
    fp32 int8 forward on the crops nudged one ulp toward zero (the
    witness, INT8_MESH_WITNESS)."""
    from dctseg_torch.parallel import distributed, mesh, spatial
    model = _full_model(dev, quantize="int8")
    model32 = _full_model(dev, quantize="int8", compute_dtype="float32")
    vol = torch.randn(VOLUME, device=dev, generator=gen(dev, SEED + 21))
    crops = Predictor.crops(vol)
    rows, probs, probs32 = {}, {}, {}
    for name, (data, space) in INT8_MESHES.items():
        mm = m if (data, space) == (m.data, m.space) else mesh.make_mesh(
            spatial=space)
        sharded = Predictor(model, device=dev, mesh=mm)
        k7, norms, plain = [], [], collections.Counter()
        sigs = collections.defaultdict(set)
        torch.cuda.synchronize()
        reset_launches()
        with recording_int8(k7, norms, plain, sigs):
            probs[name] = sharded.tiled_probs(vol)
        torch.cuda.synchronize()
        launches = read_launches()
        keys = sorted(launches)
        every = spatial.all_gather(
            torch.tensor([launches[k] for k in keys] + [sum(plain.values())],
                         device=dev), mm.group)
        stats = spatial.all_gather(torch.stack([st for _, _, st in k7]),
                                   mm.group)
        row = dict(mesh=mm.shape, launches=launches,
                   rank_launches=[dict(zip(keys, t.tolist()[:-1]))
                                  for t in every],
                   rank_plain_calls=[int(t[-1]) for t in every],
                   plain_calls=dict(plain),
                   k7_calls=[(list(sh), route) for sh, route, _ in k7],
                   k7_stats_equal_over_ranks=all(
                       torch.equal(t.view(torch.int32),
                                   stats[0].view(torch.int32))
                       for t in stats[1:]),
                   k7_stats=stats[0].tolist(),
                   amax_norm_calls=[(list(sh), f, r) for sh, f, r in norms],
                   kernel_calls={k: sorted(v, key=str)
                                 for k, v in sigs.items()})
        times = []
        for _ in range(INT8_MESH_TIMED):
            distributed.barrier("chip_smoke:int8_timed")
            t0 = time.perf_counter()
            sharded.tiled_probs(vol)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        distributed.barrier("chip_smoke:int8_comm")
        with comm_timed({}) as comm:
            t0 = time.perf_counter()
            sharded.tiled_probs(vol)
            torch.cuda.synchronize()
        row.update(volume_ms=statistics.median(times), volume_ms_all=times,
                   comm_per_volume=comm,
                   comm_timed_volume_ms=(time.perf_counter() - t0) * 1e3)
        if space > 1:
            row["halo_convs"] = halo_int8_convs(mm, dev)
        probs32[name] = fp32_int8(Predictor(model32, device=dev, mesh=mm),
                                  crops)
        rows[name] = row
        del sharded
    if rank != 0:
        return None
    whole = Predictor(model, device=dev)
    want = whole.tiled_probs(vol)
    times = []
    for _ in range(INT8_MESH_TIMED):
        t0 = time.perf_counter()
        whole.tiled_probs(vol)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rows["unsharded_volume_ms"] = statistics.median(times)
    whole32 = Predictor(model32, device=dev)
    want32, amax32, routes32 = fp32_int8(whole32, crops)
    nudged = fp32_int8(whole32, torch.nextafter(crops,
                                                torch.zeros_like(crops)))[0]
    rows["fp32_witness"] = drift(nudged, want32)
    for name, (p, amax, routes) in probs32.items():
        rows_of = mesh.batch_rows(mesh.Mesh(*INT8_MESHES[name], 0),
                                  crops.shape[0])
        rel = ((amax - amax32) / amax32).abs()
        rows[name]["fp32_seg_probs"] = dict(
            drift(p, want32), k7_calls=len(amax),
            k7_amax_rel_diff_max=rel.max().item(),
            k7_first_differing_call=int(rel.nonzero()[0]) if rel.any()
            else None,
            routings=len(routes), routings_differing=sum(
                not torch.equal(a.sort(1).values,
                                b[rows_of].sort(1).values)
                for a, b in zip(routes, routes32)))
    for name, p in probs.items():
        d = (p - want).abs()
        rows[name].update(
            shape=list(p.shape), finite=bool(torch.isfinite(p).all()),
            sum_err=(p.sum(-1) - 1).abs().max().item(),
            max_abs_dprob=d.max().item(), mean_abs_dprob=d.mean().item(),
            argmax_agreement=(p.argmax(-1) == want.argmax(-1)).float()
            .mean().item())
    return rows


@contextlib.contextmanager
def routed_as(recorded, flipped):
    """Every topk_select of the model takes the next index tensor of
    ``recorded`` (one forward's routings, in order) instead of its own;
    ``flipped`` gets, per call, whether its own top-k set differed."""
    orig, replay = cwf.topk_select, iter(recorded)

    def replayed(tokens, query, k):
        own = orig(tokens, query, k)[1]
        idx = next(replay)
        flipped.append(not torch.equal(own.sort(dim=1).values,
                                       idx.sort(dim=1).values))
        return torch.gather(tokens, 1, idx[:, :, None].expand(
            -1, -1, tokens.shape[-1])), idx
    cwf.topk_select = replayed
    try:
        yield
    finally:
        cwf.topk_select = orig


@contextlib.contextmanager
def recording_topk(store):
    orig = record_topk(store)
    try:
        yield
    finally:
        cwf.topk_select = orig


def _space_train(rank, m, dev):
    """spatial_train on one rank: the train step (s2d, plain norms, B=1,
    DistributedDataParallel over the gloo group) on one seeded 128^3
    sample over (data=1, space=2), from seeded weights and one dropout
    seed: an f32 step (its top-k routings recorded), then two bf16 steps,
    the first on the f32 step's routings.  Rank 0 then runs one rank's
    unsharded step in f32 and in bf16 on the same routings (a near-tie
    that another order of sums flips would route other tokens; the
    routings whose own sets differ are counted) and with cuDNN's
    deterministic algorithms in f32 (a noise floor), and compares the
    gradients per parameter group (top-level module)."""
    from torch.nn.parallel import DistributedDataParallel
    from dctseg_torch.config import TrainConfig
    from dctseg_torch.train import optim
    from dctseg_torch.train.trainer import train_step
    g = torch.Generator().manual_seed(SEED + 22)
    x = torch.randn((1, 128, 128, 128, 4), generator=g).to(dev)
    tgt = torch.randint(0, 4, (1, 128, 128, 128), generator=g,
                        dtype=torch.uint8).to(dev)
    edge = torch.randint(0, 9, (1, 128, 128, 128), generator=g,
                         dtype=torch.uint8).to(dev)
    tcfg = TrainConfig(lr=2e-4, end_epoch=10)
    flags = dict(s2d_fullres=True, s2d_halfres=True, fused_norms=False,
                 use_pallas_attention=False)
    rows, grads, routed = {}, {}, []

    def step(model, dtype, mesh=None, routing=None, comm=None):
        """One train step of ``model`` (wrapped in DDP over ``mesh``) on
        the routings ``routing`` gives (a context), with every collective
        timed into ``comm``: (loss, ms, gradients)."""
        net = model if mesh is None else DistributedDataParallel(
            model, device_ids=[dev.index], broadcast_buffers=False)
        opt = optim.make_optimizer(model.parameters(), tcfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (routing or contextlib.nullcontext()), (
                comm_timed(comm) if comm is not None
                else contextlib.nullcontext()):
            loss = train_step(net, opt, 2e-4, x.to(getattr(torch, dtype)),
                              tgt, edge, generator=gen(dev, SEED + 23),
                              mesh=mesh)["loss"].item()
        ms = (time.perf_counter() - t0) * 1e3
        return loss, ms, {n: p.grad.float().clone()
                          for n, p in model.named_parameters()}

    for dtype in ("float32", "bfloat16"):
        model = _full_model(dev, compute_dtype=dtype, **flags)
        loss, ms, grads[dtype, "sharded"] = step(
            model, dtype, m, recording_topk(routed) if not routed
            else routed_as(routed, []))
        row = dict(losses=[loss], step_ms=[ms])
        if dtype == "bfloat16":
            # a second step, on its own routings, every collective timed
            comm = {}
            loss, ms, _ = step(model, dtype, m, comm=comm)
            row.update(losses=[row["losses"][0], loss],
                       step_ms=[row["step_ms"][0], ms], comm_per_step=comm)
        row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        del model
        if rank == 0:
            flipped = []
            (row["unsharded_loss"], row["unsharded_step_ms"],
             grads[dtype, "unsharded"]) = step(
                 _full_model(dev, compute_dtype=dtype, **flags), dtype,
                 routing=routed_as(routed, flipped))
            row.update(routings=len(flipped),
                       routings_differing=sum(flipped))
            if dtype == "float32":
                # the noise floor: cuDNN's deterministic algorithms, which
                # sum in other orders
                torch.backends.cudnn.deterministic = True
                try:
                    grads["noise"] = step(
                        _full_model(dev, compute_dtype=dtype, **flags),
                        dtype, routing=routed_as(routed, []))[2]
                finally:
                    torch.backends.cudnn.deterministic = False
        rows[dtype] = row
        torch.cuda.empty_cache()
    if rank != 0:
        return None
    f32 = grads["float32", "unsharded"]
    rows["float32"].update(
        grad_rel_err=_group_rel_err(grads["float32", "sharded"], f32),
        noise_rel_err=_group_rel_err(grads["noise"], f32))
    # bf16: each step's distance from the f32 gradient
    rows["bfloat16"].update(
        grad_rel_err=_group_rel_err(grads["bfloat16", "sharded"],
                                    grads["bfloat16", "unsharded"]),
        sharded_vs_f32=_group_rel_err(grads["bfloat16", "sharded"], f32),
        unsharded_vs_f32=_group_rel_err(grads["bfloat16", "unsharded"],
                                        f32))
    return rows


def _group_rel_err(got, want) -> dict:
    """Per parameter group (top-level module): (the largest |got - want|
    over its gradients relative to its largest |want|, and ||got - want||
    relative to ||want|| over all its entries)."""
    groups = collections.defaultdict(lambda: [0.0, 0.0, 0.0, 0.0])
    for n, g in want.items():
        top = groups[n.split(".")[0]]
        d = got[n] - g
        top[0] = max(top[0], d.abs().max().item())
        top[1] = max(top[1], g.abs().max().item())
        top[2] += d.double().square().sum().item()
        top[3] += g.double().square().sum().item()
    return {k: (d / max(t, 1e-30), math.sqrt(d2 / max(t2, 1e-300)))
            for k, (d, t, d2, t2) in sorted(groups.items())}


def run_spatial_forward():
    row = run_space_phase("forward")
    l = row["launches"]
    expected_ext = sum(NORM_CALLS.values()) * len(NORM_WIDTHS)
    sh, un = row["sharded_bf16_vs_fp32"], row["unsharded_bf16_vs_fp32"]
    ok = (row["shape"] == [1, 240, 240, 155, 4]
          and row["sum_err"] <= 1e-3
          and sh["mean_abs_dprob"] <= SPACE_DRIFT * un["mean_abs_dprob"]
          and sh["argmax_agreement"] >= (un["argmax_agreement"]
                                         - SPACE_AGREE_LOSS)
          and row["fp32_seg_probs_max_abs_dprob"] <= 1e-3
          and l["fused_instance_norm_act"] == 0
          and l["fused_norm_stats"] == l["fused_norm_apply"] == expected_ext
          and l["fused_attention"] == l["attention_mma"] == ATTN_CALLS)
    log(phase="spatial_forward", engine="tiled_probs", dtype="bfloat16",
        ranks_on_one_card=SPACE_RANKS,
        drift_bound=dict(mean_times=SPACE_DRIFT,
                         agreement_loss=SPACE_AGREE_LOSS),
        fp32_tol="seg_probs of the 8 crops within 1e-3",
        expected_ext_launches=expected_ext, ok=ok, **row)
    if not ok:
        raise AssertionError(f"spatial_forward failed: {row}")
    return row


def int8_mesh_expected(calls, data, space):
    """Every counter's launches for one B=8 bf16 int8 forward (direct) on
    one rank of a (data, space) mesh: K6 as unsharded; every K7 call on
    from_amax, those the grid route takes unsharded first on the amax
    route; on a space axis every K1 call on the external-statistics pair,
    with absmax slots where the unsharded forward reports an absmax; on a
    data axis K1 as unsharded at B = 8 / data."""
    base = int8_expected(calls, "direct", "int8")
    k7 = K7_CALLS["direct", "int8"]
    want = dict(base, quantize_absmax=0, quantize_amax=k7["grid"],
                quantize_from_amax=k7["grid"] + k7["from_amax"],
                **dict.fromkeys(EXT_COUNTERS, 0), minplus_pass=0,
                masked_order_stats=0, count_leq=0)
    batch = 8 // data
    if space > 1:
        n = sum(NORM_CALLS.values()) * len(NORM_WIDTHS)
        amax = len(calls.norms["direct", "int8"])
        want.update(fused_instance_norm_act=0,
                    fused_instance_norm_act_amax=0, fused_norm_stats=n - amax,
                    fused_norm_apply=n - amax, fused_norm_stats_amax=amax,
                    fused_norm_apply_amax=amax)
    else:
        amax = sum(fusednorm.plan_for((batch,) + shape[1:], torch.bfloat16,
                                      8, res, 0, True).launches
                   for shape, _, res in calls.norms["direct", "int8"])
        want.update(fused_instance_norm_act=norm_launches(
                        torch.bfloat16, False, batch) - amax,
                    fused_instance_norm_act_amax=amax)
    return want


def run_spatial_int8(calls):
    """spatial_int8: int8 tiled_probs over (data=1, space=2) and (data=2,
    space=1), two gloo ranks of the card.  Fails unless, on each mesh:
    every rank's launches are int8_mesh_expected's and no plain version
    ran; every K7 call's stats are equal over the ranks; the
    probabilities are finite, sum to one, and stay within INT8_DRIFT of
    the unsharded int8 engine's (mean |dp|, argmax agreement); in fp32
    the 8 crops' seg_probs within INT8_MESH_WITNESS times the one-ulp
    witness's drift of unsharded; on a space axis the halo'd int8 convs
    equal the whole tensor's (halo_int8_convs)."""
    rows = run_space_phase("int8")
    ok, bound = True, INT8_DRIFT["direct"]
    for name, (data, space) in INT8_MESHES.items():
        row = rows[name]
        want = int8_mesh_expected(calls, data, space)
        row["expected_launches"] = want
        row["launches_ok"] = all({k: r[k] for k in want} == want
                                 for r in row["rank_launches"])
        row["ok"] = (row["launches_ok"] and row["plain_calls"] == {}
                     and row["rank_plain_calls"] == [0] * SPACE_RANKS
                     and row["k7_stats_equal_over_ranks"]
                     and len(row["k7_calls"]) == sum(
                         K7_CALLS["direct", "int8"].values())
                     and row["shape"] == [1, 240, 240, 155, 4]
                     and row["finite"] and row["sum_err"] <= 1e-3
                     and row["mean_abs_dprob"] < bound["mean"]
                     and row["argmax_agreement"] > bound["agree"]
                     and row["fp32_seg_probs"]["mean_abs_dprob"]
                     <= INT8_MESH_WITNESS
                     * rows["fp32_witness"]["mean_abs_dprob"]
                     and all(c["equal"] for c in
                             row.get("halo_convs", {}).values())
                     and (space == 1 or len(row.get("halo_convs", {}))
                          == len(HALO_CONVS)))
        ok = ok and row["ok"]
        log(phase="spatial_int8", engine="tiled_probs", quantize="int8",
            dtype="bfloat16", path="direct", data=data, space=space,
            ranks_on_one_card=SPACE_RANKS, drift_bound=bound,
            fp32_witness=rows["fp32_witness"],
            fp32_witness_factor=INT8_MESH_WITNESS,
            unsharded_volume_ms=rows["unsharded_volume_ms"],
            kernel_call_signatures={k: len(v) for k, v in
                                    row["kernel_calls"].items()},
            **{k: v for k, v in row.items() if k != "kernel_calls"})
    if not ok:
        raise AssertionError("spatial_int8 failed")
    return rows


def k1_case(dev, g, kind, shape, dt, fine, eps, act, res):
    """K1 at one call of a mesh forward, on seeded input: ``kind`` "fused"
    or "amax" (fused_instance_norm_act, its absmax variant), "ext" or
    "ext_amax" (the external-statistics pair without and with slots, on
    the slab's own sums and count).  Its output within norm_within_bounds
    of the plain norm of the input, an absmax torch.equal to the max |out|
    per sample of its own output, its launches the plan's on its own
    counters.  Returns (ok, max |difference|, launches)."""
    x = (torch.randn(shape, device=dev, generator=g) * 3 + 1).to(dt)
    r = torch.randn(shape, device=dev, generator=g).to(dt) if res else None
    vec = fusednorm.vector_width(x)
    names = {"fused": ("fused_instance_norm_act",),
             "amax": ("fused_instance_norm_act_amax",),
             "ext": ("fused_norm_stats", "fused_norm_apply"),
             "ext_amax": ("fused_norm_stats_amax", "fused_norm_apply_amax")}
    before = [KERNEL_COUNTERS[n].launches for n in names[kind]]
    if kind.startswith("ext"):
        count = fusednorm.norm_count(x, fine)
        if kind == "ext":
            out, amax = fusednorm.fused_norm_apply(
                x, fusednorm.fused_norm_stats(x, fine), count, fine, eps,
                act=act, residual=r), None
        else:
            out, amax = fusednorm.fused_norm_apply_amax(
                x, *fusednorm.fused_norm_stats_amax(x, fine), count, fine,
                eps, act=act, residual=r)
        want_launches = [1, 1]
    else:
        fn = (fusednorm.fused_instance_norm_act if kind == "fused"
              else fusednorm.fused_instance_norm_act_amax)
        out = fn(x, fine, eps, act=act, residual=r)
        out, amax = out if kind == "amax" else (out, None)
        want_launches = [fusednorm.plan_for(shape, dt, vec, res, 0,
                                            kind == "amax").launches]
    launched = [KERNEL_COUNTERS[n].launches - b
                for n, b in zip(names[kind], before)]
    want = fusednorm.fused_instance_norm_act_plain(x, fine, eps, act=act,
                                                   residual=r)
    within, err, _, _ = norm_within_bounds(out, want, x, fine, act, r)
    ok = (within and launched == want_launches
          and (amax is None or torch.equal(
              amax, out.reshape(shape[0], -1).float().abs().amax(dim=1))))
    return ok, err.max().item(), launched


def check_mesh_int8_calls(dev, rows, calls):
    """Every kernel at every call the int8 mesh forwards made (``rows``:
    run_spatial_int8's, rank 0's calls on each mesh; ``calls``:
    record_int8_calls', whose K6 calls check_int8_conv held): K6 at each
    call the unsharded forwards did not make (the halo'd slabs of a space
    axis, D padded (0, 0); B=4 on a data axis) through check_k6 in the
    call's output dtype and bias; K1 at each (variant, shape, dtype, fine
    channels, act, residual) through k1_case; K2 at each shape other than
    ATTN_SHAPE through check_attention.  Returns the largest K6, K1 and
    K2 (bf16) differences."""
    g = gen(dev, SEED + 26)
    checked = {sig for sigs in calls.k6.values() for sig in sigs}
    k6 = sorted({tuple(c) for name in INT8_MESHES
                 for c in rows[name]["kernel_calls"]["k6"]}, key=str)
    new = [c for c in k6 if c[:4] not in checked]
    worst = dict(k6=0.0, k1=0.0, k2=0.0)
    for x_shape, w_shape, stride, pads, bias, dt in new:
        worst["k6"] = max(worst["k6"], check_k6(
            dev, g, (x_shape, w_shape, stride, pads), "tma",
            ((dt, bias),), what="int8_conv3d_mesh"))
    k1 = sorted({tuple(c) for name in INT8_MESHES
                 for c in rows[name]["kernel_calls"]["k1"]}, key=str)
    for kind, shape, dt, fine, eps, act, res in k1:
        ok, err, launched = k1_case(dev, g, kind, shape, dt, fine, eps, act,
                                    res)
        if dt == torch.bfloat16:
            worst["k1"] = max(worst["k1"], err)
        log(check="fusednorm_mesh", variant=kind, shape=list(shape),
            dtype=str(dt), fine=fine, act=act, residual=res,
            launches=launched, max_abs_err=err,
            tol="check_fusednorm's bounds", ok=ok)
        if not ok:
            raise AssertionError(f"K1 ({kind}) at a mesh call {shape} {dt} "
                                 f"{fine} {act} {res}")
    k2 = sorted({tuple(c) for name in INT8_MESHES
                 for c in rows[name]["kernel_calls"]["k2"]}, key=str)
    for q_shape, n2, dt in k2:
        shp = q_shape if n2 == q_shape[2] else (*q_shape[:3], n2,
                                                q_shape[3])
        if shp != ATTN_SHAPE:
            worst["k2"] = max(worst["k2"], check_attention(dev, shp, ()))
    log(check="int8_mesh_kernel_calls", k6_calls=len(k6),
        k6_checked_here=len(new), k1_calls=len(k1), k2_calls=len(k2),
        worst=worst, ok=True)
    torch.cuda.synchronize()
    return worst


def run_spatial_train():
    rows = run_space_phase("train")
    f32, b16 = rows["float32"], rows["bfloat16"]
    f32["worst_grad_rel_err"] = max(l2 for _, l2 in
                                    f32["grad_rel_err"].values())
    # bf16: the sharded step's gradient as close to the f32 gradient as
    # the unsharded bf16 step's, group by group
    b16["worst_excess_vs_f32"] = max(
        b16["sharded_vs_f32"][k][1] - SPACE_BF16_SLACK
        * b16["unsharded_vs_f32"][k][1] for k in b16["sharded_vs_f32"])
    ok = (f32["worst_grad_rel_err"] <= SPACE_GRAD_RTOL
          and b16["worst_excess_vs_f32"] <= SPACE_GRAD_RTOL
          and f32["routings"] == b16["routings"] == ATTN_CALLS
          and f32["routings_differing"] == 0
          and all(math.isfinite(v) for r in (f32, b16)
                  for v in r["losses"])
          and abs(f32["losses"][0] - f32["unsharded_loss"])
          <= 1e-5 * abs(f32["unsharded_loss"]))
    log(phase="spatial_train", batch=1, path="s2d", space=SPACE_RANKS,
        f32_grad_l2_rtol=SPACE_GRAD_RTOL, bf16_slack=SPACE_BF16_SLACK,
        ok=ok, **rows)
    if not ok:
        raise AssertionError(f"spatial_train failed: {rows}")
    return rows



# ------------------------------------------------------------ Swin UNETR

# the four Swin stages of a B=8 forward on 128^3 crops: (tokens a side,
# channels, heads); every stage's head dim is 16
SWIN_STAGES = ((64, 48, 3), (32, 96, 6), (16, 192, 12), (8, 384, 24))
SWIN_WINDOW = 7
SWIN_MODEL = dict(in_channels=4, out_channels=3, feature_size=48,
                  depths=[2, 2, 2, 2], num_heads=[3, 6, 12, 24],
                  window_size=7, mlp_ratio=4.0, qkv_bias=True,
                  norm_eps=1e-5)
# (shape, act) of K1's pre-activation residual route: the 128^3 x 48 site
# of encoder1 and decoder1 (split route) and a bottleneck one (fused)
NORM_PRE_CASES = (((8, 128, 128, 128, 48), "lrelu"),
                  ((8, 32, 32, 32, 96), "lrelu"),
                  ((8, 4, 4, 4, 768), "lrelu"),
                  ((2, 8, 8, 8, 24), "none"))


def swin_window_inputs(dev, g, edge, c, heads, batch=8, dt=torch.bfloat16,
                       ws=SWIN_WINDOW):
    """q, k, v as views of one (BW, N, 3, H, D) projection, the bias table
    and the shift's region ids of one stage's windows at ``batch``."""
    from dctseg_torch.models import swin_unetr as su
    side = -(-edge // ws) * ws
    nw = (side // ws) ** 3
    n = ws ** 3
    qkv = torch.randn((batch * nw, n, 3, heads, c // heads), device=dev,
                      generator=g).to(dt)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    table = (torch.randn(((2 * ws - 1) ** 3, heads), device=dev,
                         generator=g) * 0.02).clamp(-2, 2)
    ids = su.region_ids((side,) * 3, (ws,) * 3, (ws // 2,) * 3, dev)
    return q, k, v, table, ids, nw


def check_window_attention(dev):
    """K8 against its plain version (in f32, by batch element) at the four
    stages' B=8 shapes, shifted (the region ids) and unshifted, bf16; f16
    and D = 32, 64 on a small case.  Bound: one bf16 (f16) ulp of the f32
    result + 1e-5: the kernel computes in f32 and rounds once, and its f32
    differs from the plain version's by the order of its sums, exp2 and
    p's 16-bit hi + lo split.  Returns the worst bf16 error at the
    stages."""
    g = gen(dev, SEED + 11)
    cases = [(edge, c, h, torch.bfloat16, 8) for edge, c, h in SWIN_STAGES]
    cases += [(14, 96, 3, torch.float16, 2), (14, 64, 2, torch.bfloat16, 2),
              (8, 128, 2, torch.bfloat16, 1)]
    worst = 0.0
    for edge, c, heads, dt, batch in cases:
        q, k, v, table, ids, nw = swin_window_inputs(dev, g, edge, c, heads,
                                                     batch, dt)
        scale = (c // heads) ** -0.5
        for shifted in (False, True):
            mask = ids if shifted else None
            before = attn.fused_window_attention.launches
            got = attn.fused_window_attention(q, k, v, table, mask, scale,
                                              SWIN_WINDOW)
            launched = attn.fused_window_attention.launches - before
            again = attn.fused_window_attention(q, k, v, table, mask, scale,
                                                SWIN_WINDOW)
            err = 0.0
            over = 0
            for b in range(batch):
                rows = slice(b * nw, (b + 1) * nw)
                want = attn.fused_window_attention_plain(
                    q[rows].float(), k[rows].float(), v[rows].float(), table,
                    mask, scale, SWIN_WINDOW)
                e = (got[rows].float() - want).abs()
                ulp = (bf16_ulp(want) if dt == torch.bfloat16
                       else torch.exp2(torch.floor(torch.log2(
                           want.abs().clamp(min=2.0 ** -14))) - 10))
                over += int((e > ulp + 1e-5).sum())
                err = max(err, e.max().item())
                del want, e, ulp
            ok = over == 0 and launched == 1 and torch.equal(got, again)
            if dt == torch.bfloat16 and batch == 8:
                worst = max(worst, err)
            log(check="window_attention", stage_edge=edge, channels=c,
                heads=heads, dtype=str(dt), batch=batch, windows=nw * batch,
                shifted=shifted, launches=launched, max_abs_err=err,
                over_bound=over, tol="1 ulp of the f32 result + 1e-5",
                bitwise_repeat=torch.equal(got, again), ok=ok)
            if not ok:
                raise AssertionError(f"window attention disagrees at {edge} "
                                     f"{c} {heads} {dt} shifted={shifted}")
            del got, again
        del q, k, v
    torch.cuda.synchronize()
    return worst


def check_norm_pre(dev):
    """K1's pre-activation residual route against its plain version:
    act(x*a + b + r) in f32, cast once; within 1e-4 + one ulp of the
    output (the kernel's f32 statistics differ in the last bits), a second
    call bitwise equal, both routes occurring, each launch counted on
    fused_instance_norm_act and on its ``*_pre`` route."""
    g = gen(dev, SEED + 12)
    worst, routes = 0.0, set()
    for shape, act in NORM_PRE_CASES:
        c = shape[-1]
        x = (torch.randn(shape, device=dev, generator=g) * 3 + 1).bfloat16()
        r = torch.randn(shape, device=dev, generator=g).bfloat16()
        want = fusednorm.fused_norm_residual_act_plain(x, r, c, act=act)
        plan = fusednorm.plan_for(shape, x.dtype, 8, fusednorm.RES_BEFORE, 0)
        before = dict(fusednorm.fused_instance_norm_act.routes)
        got = fusednorm.fused_norm_residual_act(x, r, c, act=act)
        moved = {k: n - before[k] for k, n in
                 fusednorm.fused_instance_norm_act.routes.items()
                 if n != before[k]}
        again = fusednorm.fused_norm_residual_act(x, r, c, act=act)
        err = (got.float() - want.float()).abs()
        ulps = bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
        ok = (bool((err <= 1e-4 + ulps).all()) and torch.equal(got, again)
              and moved == {plan.route + "_pre": plan.launches})
        routes.add(plan.route)
        if shape[-1] == 48:
            worst = max(worst, err.max().item())
        log(check="fusednorm_pre", shape=list(shape), act=act,
            route=plan.route, launches=moved, max_abs_err=err.max().item(),
            tol="1e-4 + 1 bf16 ulp of the output",
            bitwise_repeat=torch.equal(got, again), ok=ok)
        if not ok:
            raise AssertionError(f"fusednorm pre route disagrees: {shape}")
        del x, r, want, got, again, err, ulps
    if routes != {"fused", "split"}:
        raise AssertionError(f"pre route checked on {routes} only")
    torch.cuda.synchronize()
    return worst


def window_bound_ms(bw, heads, n, d, elem=2):
    """K8's bound on one call: q, k, v read and the output written once at
    HBM's rate, or its two products at the bf16 peak, the larger."""
    nbytes = 4 * bw * n * heads * d * elem
    flops = 4 * bw * heads * n * n * d
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3


def sdpa_mask(table, ids, heads, n, ws=SWIN_WINDOW):
    """The additive float mask F.scaled_dot_product_attention takes in
    K8's place: (nW, H, N, N) bias + shift mask, bf16."""
    idx = attn.relative_position_index(ws, n).to(table.device)
    bias = table[idx].permute(2, 0, 1)[None]
    if ids is None:
        return bias.bfloat16()
    i = ids.long()
    m = torch.where(i[:, :, None] != i[:, None, :], attn.MASK_VALUE, 0.0)
    return (bias + m[:, None]).bfloat16()


def time_window_attention(dev, iters=5):
    """Per stage, bf16 at B=8, one shifted and one unshifted call: K8's
    call time (CUDA events) and card time (queued), its bound, the plain
    version (f32, per batch element, times 8) and
    F.scaled_dot_product_attention with the bias and mask as one float
    mask (the mask made beforehand, not timed).  Sums are per volume: two
    blocks a stage."""
    g = gen(dev, SEED + 13)
    rows, total = [], collections.Counter()
    for edge, c, heads in SWIN_STAGES:
        q, k, v, table, ids, nw = swin_window_inputs(dev, g, edge, c, heads)
        scale = (c // heads) ** -0.5
        bw, n, d = q.shape[0], q.shape[2], q.shape[3]
        row = dict(stage_edge=edge, windows=bw, heads=heads, n=n, d=d)
        for tag, mask in (("unshifted", None), ("shifted", ids)):
            def call():
                return attn.fused_window_attention(q, k, v, table, mask,
                                                   scale, SWIN_WINDOW)
            row[f"{tag}_ms"] = time_ms(call, iters)
            row[f"{tag}_device_ms"] = queued_ms(call, iters)
            row[f"{tag}_plain_ms"] = 8 * time_ms(
                lambda: attn.fused_window_attention_plain(
                    q[:nw], k[:nw], v[:nw], table, mask, scale,
                    SWIN_WINDOW), 1, warmup=1)
            full = sdpa_mask(table, mask, heads, n)
            if mask is not None:    # (nW, H, N, N) -> (BW, H, N, N)
                full = full.repeat(bw // full.shape[0], 1, 1, 1)
            try:
                row[f"{tag}_library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=full, scale=scale), iters)
            except RuntimeError as exc:   # no kernel takes the call
                row[f"{tag}_library_ms"] = None
                row[f"{tag}_library_error"] = str(exc)[:200]
            del full
        row["bound_ms"] = window_bound_ms(bw, heads, n, d)
        for key in ("ms", "device_ms", "plain_ms", "library_ms"):
            vals = [row[f"{t}_{key}"] for t in ("unshifted", "shifted")]
            if all(x is not None for x in vals):
                total[key] += sum(vals)
        total["bound_ms"] += 2 * row["bound_ms"]
        log(timing="window_attention", **row)
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    total = dict(total)
    total["roofline_pct"] = 100.0 * total["bound_ms"] / total["device_ms"]
    log(timing="window_attention_volume", **total)
    return rows, total


def time_norm_pre(dev, iters=10):
    """K1's pre route at 128^3 x 48, B=8, bf16 (a decoder1 or encoder1
    site): call and card time, bound (x and r read, the output written
    once), plain, and the library's instance_norm + add + leaky_relu."""
    g = gen(dev, SEED + 14)
    shape = (8, 128, 128, 128, 48)
    x = torch.randn(shape, device=dev, generator=g).bfloat16()
    r = torch.randn(shape, device=dev, generator=g).bfloat16()
    xc, rc = x.permute(0, 4, 1, 2, 3), r.permute(0, 4, 1, 2, 3)

    def call():
        return fusednorm.fused_norm_residual_act(x, r, 48, act="lrelu")
    row = dict(shape=list(shape), dtype="bf16",
               route=fusednorm.plan_for(shape, x.dtype, 8,
                                        fusednorm.RES_BEFORE, 0).route)
    row["ms"] = time_ms(call, iters)
    row["device_ms"] = queued_ms(call, iters)
    row["bound_ms"] = 3 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
    row["plain_ms"] = time_ms(lambda: fusednorm.fused_norm_residual_act_plain(
        x, r, 48, act="lrelu"), 2)
    row["library_ms"] = time_ms(
        lambda: F.leaky_relu(F.instance_norm(xc) + rc, 0.01), 2)
    log(timing="fusednorm_pre", **row)
    return row


# K9's launches in a B=8 forward: norm1 and norm2 of the 8 blocks, the 4
# merging norms and the 5 proj_out norms
K9_LAUNCHES = {"layer_norm_to_windows": 8, "windows_residual_layer_norm": 8,
               "layer_norm": 9}


def k9_cases(dev, edge, c, shift):
    """One stage's K9 inputs at B=8, bf16: x, norm weight and bias, the
    window and shift get_window_size gives, the merging's gathered rows
    and their weight."""
    from dctseg_torch.models import swin_unetr as su
    g = gen(dev, SEED + 17 + edge + shift)
    grid = (edge,) * 3
    window, sh = su.get_window_size(grid, (SWIN_WINDOW,) * 3, (shift,) * 3)
    x = (torch.randn((8, *grid, c), device=dev, generator=g) * 2
         + 0.5).bfloat16()
    w = torch.randn(c, device=dev, generator=g) * 0.5 + 1
    b = torch.randn(c, device=dev, generator=g) * 0.1
    half = -(-edge // 2)
    merged = torch.randn((8, half, half, half, 8 * c), device=dev,
                         generator=g).bfloat16()
    wm = torch.randn(8 * c, device=dev, generator=g) * 0.5 + 1
    return x, w, b, window, sh, merged, wm


def check_layer_norm(dev):
    """K9 on each route at the four stages' B=8 shapes, shifted and
    unshifted, against its plain version on f32 inputs: within one bf16
    ulp of the f32 result + 1e-6 (the kernel's f32 sums differ in order);
    the residual sum x + y bit for bit; one launch a call, counted on its
    wrapper; a second call bitwise equal.  Returns the worst error."""
    worst = 0.0
    for edge, c, _ in SWIN_STAGES:
        for shift in (0, SWIN_WINDOW // 2):
            x, w, b, window, sh, merged, wm = k9_cases(dev, edge, c, shift)
            y = torch.randn(layernorm._to_windows_shape(x, window),
                            device=dev).bfloat16()
            before = _build.launch_counts()
            calls = {
                "to_windows": (
                    lambda: layernorm.layer_norm_to_windows(
                        x, w, b, 1e-5, window, sh),
                    lambda: layernorm.layer_norm_to_windows_plain(
                        x.float(), w, b, 1e-5, window, sh)),
                "windows_residual": (
                    lambda: layernorm.windows_residual_layer_norm(
                        y, x, w, b, 1e-5, window, sh),
                    lambda: layernorm.windows_residual_layer_norm_plain(
                        y, x, w, b, 1e-5, window, sh)),
                "merging": (
                    lambda: layernorm.layer_norm(merged, wm, None, 1e-5),
                    lambda: layernorm.layer_norm_plain(merged.float(), wm,
                                                       None, 1e-5)),
                "proj_out": (
                    lambda: layernorm.layer_norm(x, None, None, 1e-5),
                    lambda: layernorm.layer_norm_plain(x.float(), None,
                                                       None, 1e-5))}
            for route, (kernel, plain) in calls.items():
                got, again, want = kernel(), kernel(), plain()
                if route == "windows_residual":
                    same_sum = torch.equal(got[0], want[0])
                    again, got = again[1], got[1]
                    want = layernorm.layer_norm_plain(want[0].float(), w, b,
                                                      1e-5)
                else:
                    same_sum = True
                err = (got.float() - want).abs()
                over = int((err > bf16_ulp(want) + 1e-6).sum())
                ok = over == 0 and same_sum and torch.equal(got, again)
                worst = max(worst, err.max().item())
                log(check="layer_norm", route=route, stage_edge=edge,
                    channels=c, window=list(window), shift=list(sh),
                    max_abs_err=err.max().item(), over_bound=over,
                    residual_sum_bitwise=same_sum,
                    tol="1 bf16 ulp of the f32 result + 1e-6",
                    bitwise_repeat=torch.equal(got, again), ok=ok)
                if not ok:
                    raise AssertionError(f"K9 {route} disagrees at {edge} "
                                         f"{c} shift={shift}")
                del got, again, want, err
            moved = {(fn.__name__, kind): n for (fn, _, kind), n
                     in _build.launches_since(before).items()}
            want_moved = {("layer_norm_to_windows", None): 2,
                          ("windows_residual_layer_norm", None): 2,
                          ("layer_norm", None): 4}
            if moved != want_moved:
                raise AssertionError(f"K9 launches {moved}")
            del x, y, merged
    torch.cuda.synchronize()
    return worst


def time_layer_norm(dev, iters=10):
    """Per stage at B=8, bf16: each route's call time (CUDA events) and
    card time (queued), its bound (every input row read once and every
    output row written once, the windows' padding rows included), the
    plain sequence's time and F.layer_norm's on the same rows (bf16 in and
    out, the library's norm alone: no pad, roll or windows).  Sums a
    volume: two blocks a stage (one unshifted, one shifted), the merging
    norm, and proj_out of the stage's input (and of the last output); the
    summed bound must equal ``swin_norm_roofline.swin``'s."""
    rows, total = [], collections.Counter()
    elem = 2
    for i, (edge, c, _) in enumerate(SWIN_STAGES):
        row = dict(stage_edge=edge, channels=c)
        for shift in (0, SWIN_WINDOW // 2):
            x, w, b, window, sh, merged, wm = k9_cases(dev, edge, c, shift)
            win = layernorm.layer_norm_to_windows(x, w, b, 1e-5, window, sh)
            y = torch.randn_like(win)
            wb, bb = w.bfloat16(), b.bfloat16()
            tag = "shifted" if shift else "unshifted"
            routes = {
                "to_windows": (
                    lambda: layernorm.layer_norm_to_windows(
                        x, w, b, 1e-5, window, sh),
                    lambda: layernorm.layer_norm_to_windows_plain(
                        x, w, b, 1e-5, window, sh),
                    lambda: F.layer_norm(x, (c,), wb, bb),
                    (x.numel() + win.numel()) * elem),
                "windows_residual": (
                    lambda: layernorm.windows_residual_layer_norm(
                        y, x, w, b, 1e-5, window, sh),
                    lambda: layernorm.windows_residual_layer_norm_plain(
                        y, x, w, b, 1e-5, window, sh),
                    lambda: F.layer_norm(x, (c,), wb, bb),
                    4 * x.numel() * elem)}
            if shift == 0:
                routes["merging"] = (
                    lambda: layernorm.layer_norm(merged, wm, None, 1e-5),
                    lambda: layernorm.layer_norm_plain(merged, wm, None,
                                                       1e-5),
                    lambda: F.layer_norm(merged, (8 * c,), wm.bfloat16()),
                    2 * merged.numel() * elem)
                routes["proj_out"] = (
                    lambda: layernorm.layer_norm(x, None, None, 1e-5),
                    lambda: layernorm.layer_norm_plain(x, None, None, 1e-5),
                    lambda: F.layer_norm(x, (c,)),
                    2 * x.numel() * elem)
            for route, (kernel, plain, library, nbytes) in routes.items():
                key = f"{route}_{tag}" if route in ("to_windows",
                                                    "windows_residual") \
                    else route
                row[f"{key}_ms"] = time_ms(kernel, iters)
                row[f"{key}_device_ms"] = queued_ms(kernel, iters)
                row[f"{key}_plain_ms"] = time_ms(plain, 3)
                row[f"{key}_library_ms"] = time_ms(library, iters)
                row[f"{key}_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
                for k in ("ms", "device_ms", "plain_ms", "library_ms",
                          "bound_ms"):
                    total[k] += row[f"{key}_{k}"]
            del x, merged, win, y
            torch.cuda.empty_cache()
        log(timing="layer_norm", **row)
        rows.append(row)
        if i == len(SWIN_STAGES) - 1:    # proj_out of the last output
            half = -(-edge // 2)
            z = torch.randn((8, half, half, half, 2 * c), device=dev
                            ).bfloat16()
            total["ms"] += time_ms(
                lambda: layernorm.layer_norm(z, None, None, 1e-5), iters)
            total["device_ms"] += queued_ms(
                lambda: layernorm.layer_norm(z, None, None, 1e-5), iters)
            total["plain_ms"] += time_ms(
                lambda: layernorm.layer_norm_plain(z, None, None, 1e-5), 3)
            total["library_ms"] += time_ms(lambda: F.layer_norm(z, (2 * c,)),
                                           iters)
            total["bound_ms"] += 2 * z.numel() * elem / HBM_BYTES_PER_S * 1e3
    total = dict(total)
    reader_ms = swin_norm_bound_ms()
    if not math.isclose(total["bound_ms"], reader_ms, rel_tol=1e-9):
        raise AssertionError(f"K9's summed bound {total['bound_ms']} ms is "
                             f"not swin_norm_roofline.swin's {reader_ms}")
    total["roofline_pct"] = 100.0 * total["bound_ms"] / total["device_ms"]
    log(timing="layer_norm_volume", **total)
    return rows, total


def swin_norm_bound_ms():
    """``swin_norm_roofline.swin``'s byte bound of a B=8 bf16 forward at
    SWIN_MODEL's widths, in ms."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmark", "metrics", "swin_norm_roofline.swin.py")
    spec = importlib.util.spec_from_file_location("swin_norm_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    model = dict(SWIN_MODEL, compute_dtype="bfloat16")
    return mod.norm_bytes(model) / HBM_BYTES_PER_S * 1e3


def swin_engine(dev, weights, **overrides):
    from dctseg_torch.models import swin_unetr as su
    model = su.build_model(su.SwinUNETRConfig(**overrides), device=dev)
    model.load_state_dict(weights, strict=True)
    return model


def run_swin_forward(dev):
    """Swin UNETR at its published widths: the parameter count; one B=8
    bf16 forward of a volume's 8 crops against the benchmark's f32
    reference (TF32 off) in blocks of 2 crops (largest and 90th-percentile
    probability gap, label agreement by the region rule); the launches a
    forward (K1 by route, K8, K9: K9_LAUNCHES asserted); forward time with
    K8 and K9, with the plain attention, and with K9's plain versions (the
    torch sequence before K9), peak memory; one forward under
    torch.profiler: device time by op family; tiled_probs of a
    240x240x160 volume through the engine."""
    from benchmark.reference import swin_unetr as swref
    from dctseg_torch.models import swin_unetr as su
    weights = swref.make_weights(SWIN_MODEL, SEED + 15, dev)
    model = swin_engine(dev, weights)
    params = profiling.count_params(model)
    g = gen(dev, SEED + 16)
    vol = torch.randn(VOLUME, device=dev, generator=g)
    xs = Predictor.crops(vol)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _build.launch_counts()
    with torch.inference_mode():
        probs = model(xs)[0]
    torch.cuda.synchronize()
    moved = {f"{fn.__name__}{'' if kind is None else '/' + kind}": n
             for (fn, attr, kind), n in _build.launches_since(before).items()}
    peak = torch.cuda.max_memory_allocated()
    k9 = {k: moved.get(k, 0) for k in K9_LAUNCHES}
    if k9 != K9_LAUNCHES:
        raise AssertionError(f"K9 launches a forward {k9}, expected "
                             f"{K9_LAUNCHES}")
    with torch.inference_mode():
        fwd_ms = statistics.median(event_ms(lambda: model(xs)[0])
                                   for _ in range(3))
    plain_norms = {"layer_norm": layernorm.layer_norm_plain,
                   "layer_norm_to_windows":
                       layernorm.layer_norm_to_windows_plain,
                   "windows_residual_layer_norm":
                       layernorm.windows_residual_layer_norm_plain}
    kept = {k: getattr(su, k) for k in plain_norms}
    try:
        for k, fn in plain_norms.items():
            setattr(su, k, fn)
        with torch.inference_mode():
            plain_norms_ms = statistics.median(
                event_ms(lambda: model(xs)[0]) for _ in range(3))
    finally:
        for k, fn in kept.items():
            setattr(su, k, fn)
    plain_model = swin_engine(dev, weights, window_kernel=False)
    try:
        with torch.inference_mode():
            plain_ms = statistics.median(
                event_ms(lambda: plain_model(xs)[0]) for _ in range(2))
    except torch.cuda.OutOfMemoryError:
        plain_ms = None
    del plain_model
    torch.cuda.empty_cache()
    with torch.inference_mode():
        prof, _ = profiled(lambda: model(xs)[0])
    by = collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = (e.time_range.end - e.time_range.start) / 1e3
        name = e.name
        fam = ("k8" if "window_attention_kernel" in name else
               "k9" if re.search(r"dctseg::.*\blayer_norm_kernel\b",
                                 name) else
               "torch_layer_norm" if "layer_norm_kernel" in name else
               "k1" if re.search(r"dctseg::.*\bnorm_kernel\b", name) else
               "conv" if re.search(r"conv|cudnn|sm90_xmma|implicit", name,
                                   re.I) else
               "gemm" if re.search(r"gemm|cutlass|nvjet", name, re.I) else
               "other")
        by[fam] += dur
    swref.strict_float32()
    ref = swref.SwinUNETRRef(SWIN_MODEL, weights)
    gaps = []
    label_agree = 0.0
    with torch.no_grad():
        for i in range(0, 8, 2):
            want = ref.forward(xs[i:i + 2].float())[0]
            gap = (probs[i:i + 2] - want).abs().amax(-1).flatten()
            gaps.append(gap)
            label_agree += (su.region_labels(probs[i:i + 2])
                            == su.region_labels(want)).float().mean().item()
            del want
    torch.backends.cuda.matmul.allow_tf32 = False
    gap = torch.cat(gaps)
    q90 = gap.kthvalue(int(0.9 * gap.numel())).values.item()
    predictor = Predictor(model, device=dev)
    host = vol.cpu()
    with torch.inference_mode():
        tiled = predictor.tiled_probs(host)
        labels = su.region_labels(tiled[0]).cpu()
    row = dict(parameters=params, forward_ms=fwd_ms,
               plain_attention_forward_ms=plain_ms,
               k8_saved_ms=None if plain_ms is None else plain_ms - fwd_ms,
               plain_norms_forward_ms=plain_norms_ms,
               k9_saved_ms=plain_norms_ms - fwd_ms,
               peak_memory_bytes=peak,
               launches=moved, device_ms_by_family=dict(by),
               max_prob_gap=gap.max().item(), prob_gap_q90=q90,
               label_agreement=label_agree / 4,
               tiled_shape=list(tiled.shape),
               labels_counts=torch.bincount(labels.flatten().long(),
                                            minlength=4).tolist())
    log(phase="swin_unetr_forward", **row)
    if not (gap.max().item() < 0.2 and q90 < 0.02):
        raise AssertionError(f"Swin UNETR forward off the reference: {row}")
    del model, predictor, probs, ref
    torch.cuda.empty_cache()
    return row


def run_swin(dev):
    """The Swin UNETR phase: K8, K1's pre route and K9 against their plain
    versions, their timings, the whole forward; the kernel table's rows."""
    attn_err = check_window_attention(dev)
    pre_err = check_norm_pre(dev)
    ln_err = check_layer_norm(dev)
    rows, total = time_window_attention(dev)
    pre = time_norm_pre(dev)
    _, ln_total = time_layer_norm(dev)
    fwd = run_swin_forward(dev)
    return [
        dict(name="window_attention", route="cuda",
             source="dctseg_torch/csrc/attention.cu",
             replaces="monai/networks/nets/swin_unetr.py WindowAttention "
                      "(no TPU kernel)",
             launches=fwd["launches"].get("fused_window_attention"),
             max_abs_err=attn_err, ms=total["ms"],
             device_ms=total["device_ms"], bound_ms=total["bound_ms"],
             roofline_pct=total["roofline_pct"],
             plain_ms=total["plain_ms"],
             library_ms=total.get("library_ms"),
             unit="per B=8 bf16 Swin UNETR forward (8 calls: two blocks "
                  "a stage); library: F.scaled_dot_product_attention with "
                  "the bias and mask as a float mask"),
        dict(name="fusednorm_pre", route="cuda",
             source="dctseg_torch/csrc/fusednorm.cu",
             replaces="MONAI UnetResBlock lrelu(IN(conv2(h)) + r)",
             max_abs_err=pre_err, ms=pre["ms"], device_ms=pre["device_ms"],
             bound_ms=pre["bound_ms"], plain_ms=pre["plain_ms"],
             library_ms=pre["library_ms"], route_taken=pre["route"],
             unit="per call at 8x128^3x48 bf16"),
        dict(name="layer_norm", route="cuda",
             source="dctseg_torch/csrc/layernorm.cu",
             replaces="MONAI SwinTransformerBlock norm1 + pad + roll + "
                      "window partition, window reverse + roll + crop + "
                      "residual + norm2, PatchMerging norm, proj_out (no "
                      "TPU kernel)",
             launches={k: fwd["launches"].get(k) for k in K9_LAUNCHES},
             max_abs_err=ln_err, ms=ln_total["ms"],
             device_ms=ln_total["device_ms"], bound_ms=ln_total["bound_ms"],
             roofline_pct=ln_total["roofline_pct"],
             plain_ms=ln_total["plain_ms"],
             library_ms=ln_total["library_ms"],
             forward_ms=fwd["forward_ms"],
             plain_norms_forward_ms=fwd["plain_norms_forward_ms"],
             unit="per B=8 bf16 Swin UNETR forward (25 launches); "
                  "library: F.layer_norm on the same rows, bf16, the norm "
                  "alone")]


def main(argv=None) -> int:
    only = (argv if argv is not None else sys.argv[1:])[-1:] == ["swin"]
    # ---- 1. the card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    log(phase="device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 2. build
    t0 = time.perf_counter()
    _build.lib()
    log(phase="build", seconds=time.perf_counter() - t0,
        ptxas=[ln.strip() for ln in _build.last_build_log.splitlines()
               if "registers" in ln or "spill" in ln],
        k6_tma_ptxas=k6_ptxas())

    if only:
        print(json.dumps({"kernels": run_swin(dev)}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # ---- 3. kernels vs plain versions
    check_norm_plan()
    norm_err = check_fusednorm(dev, NORM_WIDTHS)
    norm_amax_err = check_fusednorm_amax(dev, NORM_WIDTHS)
    norm_ext_err, norm_ext_amax_err = check_fusednorm_ext(dev, NORM_WIDTHS)
    attn_err = check_attention(dev)
    check_attention_backward(dev)
    relayout_err = check_relayout(dev)
    t0 = time.perf_counter()
    valid_ds = BraTSDataset(mode="valid",
                            cfg=DataConfig(synthetic_num_samples=4))
    label_pairs = [(valid_ds[i + 2].target, valid_ds[i].target)
                   for i in range(2)]
    full_pred, full_tgt = (synthetic_labels(VALID_SEED + 1),
                           synthetic_labels(VALID_SEED))
    log(phase="synthetic_data", volumes=4,
        seconds=time.perf_counter() - t0)
    out_lbl = torch.from_numpy(full_pred).to(dev)
    tgt_lbl = torch.from_numpy(full_tgt).to(dev)
    minplus_err = check_minplus(dev, out_lbl, tgt_lbl)
    o, t = metrics.composite_masks(out_lbl), metrics.composite_masks(tgt_lbl)
    pools = [(f"pooled_{mode}", *metrics.pooled_distances(
                 *metrics.borders(o, t, mode == "reference")))
             for mode in ("reference", "surface")]
    search_err = check_orderstats(dev, pools)
    del out_lbl, tgt_lbl, o, t, pools
    cfg_kw = dict(img_dim=128, base_channels=16, num_heads=8, top_num=128,
                  pe_type="fixed")
    weights = cwf.ClsWiseFormer(ModelConfig(**cfg_kw),
                                torch.Generator().manual_seed(SEED)
                                ).state_dict()
    quantize_err = check_quantize(dev)
    check_graph_replay(dev)
    int8_calls = record_int8_calls(dev, cfg_kw, weights)
    int8_err = check_int8_conv(dev, int8_calls)
    log(phase="kernel_checks", ok=True)

    # ---- 4a. serving path, full width
    check_fp32_paths(dev, cfg_kw, weights)

    model = cwf.build_model(ModelConfig(**cfg_kw), device=dev)
    model.load_state_dict(weights, strict=True)
    predictor = Predictor(model, device=dev)
    g = gen(dev, SEED + 5)
    check_tta(predictor, torch.randn((1, 128, 128, 128, 4), device=dev,
                                     generator=g))
    check_staged_input(dev, model)
    volumes = [torch.randn(VOLUME, device=dev, generator=g)
               for _ in range(N_VOLUMES)]
    serving = {}
    for name, s2d_on in (("direct", False), ("s2d", True)):
        if s2d_on:
            model = cwf.build_model(ModelConfig(**cfg_kw, s2d_fullres=True,
                                                s2d_halfres=True), device=dev)
            model.load_state_dict(weights, strict=True)
            predictor = Predictor(model, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        vol_ms = run_main_path(predictor, volumes)
        wall = time.perf_counter() - t0
        launches = {k: n for k, n in read_launches().items()
                    if k in ("fused_instance_norm_act", "fused_attention",
                             "attention_mma", "space_to_depth")}
        peak = torch.cuda.max_memory_allocated()
        log(phase="main_path", engine="tiled_probs", path=name,
            dtype="bfloat16", volumes=N_VOLUMES, per_volume_ms=vol_ms,
            wall_s=wall, launches=launches, peak_memory_bytes=peak)
        expected = {"fused_instance_norm_act": norm_launches(
                        torch.bfloat16, s2d_on) * N_VOLUMES,
                    "fused_attention": 13 * N_VOLUMES,
                    "attention_mma": 13 * N_VOLUMES,
                    "space_to_depth": (RELAYOUT_PER_FORWARD * N_VOLUMES
                                       if s2d_on else 0)}
        if launches != expected:
            raise AssertionError(f"{name} launch counts {launches}, "
                                 f"expected {expected}")
        serving[name] = vol_ms
        if not s2d_on:
            fwd_row = profile_forward(predictor, volumes[0])
        del predictor, model
    # int8 on both paths, against the float engine in turns
    int8_rows = run_int8_main_path(dev, cfg_kw, weights, volumes, int8_calls)
    run_int8_witness(dev, cfg_kw, weights, volumes[0])
    # fused dispatch: CUDA graphs against the staged engine; A8: where one
    # forward's device time goes; the profiling module at full width
    fused_rows = run_fused_dispatch(dev, cfg_kw, weights, volumes)
    attribute_forward(dev, cfg_kw, weights, volumes[0])
    run_profiling(dev, cfg_kw, weights)
    del volumes

    # ---- 4b. evaluation path, full width
    check_device_metrics(dev, label_pairs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eval_res, eval_launches = run_eval_path()
    log(phase="eval_path_memory",
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    eval_int8_res, eval_int8_launches = run_eval_path("int8", int8_calls)

    # ---- 4c. training path, full width: the checked run, then remat
    # 'full' and the direct path for their step time and memory
    train_rows = {"s2d_remat_none": run_train_path(dev, [], check=True),
                  "s2d_remat_full": run_train_path(
                      dev, ["--remat-policy", "full"], check=False),
                  "direct_remat_none": run_train_path(dev, ["--no-s2d"],
                                                      check=False)}
    log(timing="train_step", unit="ms per B=1 bf16 step (median of steps "
        "3-6)", **{k: r["steady_step_ms"] for k, r in train_rows.items()},
        peak_memory_bytes={k: r["peak_memory_bytes"]
                           for k, r in train_rows.items()})
    # the card's busy time per step, against the unprofiled steady step
    for name, extra in (("s2d_remat_none", []),
                        ("direct_remat_none", ["--no-s2d"])):
        busy = run_train_path(dev, extra, check=False,
                              profile=True)["profiled_device_busy_ms"]
        step = train_rows[name]["steady_step_ms"]
        log(timing="train_step_device", path=name, steady_step_ms=step,
            device_busy_ms=sum(busy) / len(busy),
            idle_share=1 - sum(busy) / len(busy) / step)

    # ---- 4e. multi-GPU (A12): DDP over NCCL, then the space axis on two
    # ranks of the one card; the explicit conv VJP (A10)
    parallel_rows = run_parallel_train(dev)
    space_fwd = run_spatial_forward()
    space_int8 = run_spatial_int8(int8_calls)
    mesh_call_errs = check_mesh_int8_calls(dev, space_int8, int8_calls)
    space_train = run_spatial_train()
    vjp_row = run_conv3_vjp(dev)

    # ---- 4d. serving bundles and the HTTP server, full width
    bundle_row = run_serving_bundles(dev, cfg_kw, weights)
    int8_bundle_row = run_int8_bundle(dev, cfg_kw, weights, int8_calls)

    # ---- 5. timing
    for name, vol_ms in serving.items():
        steady = vol_ms[1:]
        log(timing="tiled_probs", path=name, dtype="bfloat16",
            first_volume_ms=vol_ms[0],
            steady_volume_ms=sum(steady) / len(steady))
    for name, row in fused_rows.items():
        log(timing="tiled_probs_fused_dispatch", path=name,
            dtype="bfloat16", unit="ms per volume, engines in turns",
            **{k: {m: row[k][m] for m in ("median_ms", "spread_ms",
                                          "idle_share",
                                          "peak_allocated_bytes",
                                          "footprint_bytes")}
               for k in ("staged", "fused")},
            fused_vs_staged=row["fused_vs_staged"])
    for name, row in int8_rows.items():
        log(timing="tiled_probs_int8", path=name, dtype="bfloat16",
            unit="ms per volume, float and int8 engines in turns",
            float_ms=row["none_ms"], int8_ms=row["int8_ms"],
            steady_float_ms=statistics.mean(row["none_ms"][1:]),
            steady_int8_ms=statistics.mean(row["int8_ms"][1:]))
    log(timing="validate_softmax", strategy="tiling", hd95="reference",
        dtype="bfloat16", sec_per_volume=eval_res["sec_per_volume"],
        int8_sec_per_volume=eval_int8_res["sec_per_volume"])
    log(timing="serving_bundle_int8", strategy="tiling", quantize="int8",
        export_s=int8_bundle_row["export_s"],
        load_s=int8_bundle_row["load_s"],
        bundle_mb=int8_bundle_row["bundle_mb"],
        request_ms=int8_bundle_row["request"]["latency_ms"],
        request_client_ms=int8_bundle_row["request"]["client_ms"])
    int8_timing = time_int8(dev, int8_calls)
    mesh_int8 = time_mesh_int8(dev, space_int8["data1_space2"])
    norm_rows = time_fusednorm(dev, NORM_WIDTHS)
    ext_row = time_fusednorm_ext(dev, NORM_WIDTHS)
    attn_row = time_attention(dev)
    relayout_rows = time_relayout(dev)
    met = time_metrics(dev, full_pred, full_tgt)
    dispatch = time_dispatch(dev)
    reqs = bundle_row["requests"]
    log(timing="serving_bundle", strategy="tiling", dtype="bfloat16",
        export_s=bundle_row["export_s"], load_s=bundle_row["load_s"],
        bundle_mb=bundle_row["bundle_mb"],
        first_request_ms=reqs[0]["latency_ms"],
        first_request_client_ms=reqs[0]["client_ms"],
        steady_request_ms=statistics.mean(r["latency_ms"]
                                          for r in reqs[1:3]),
        steady_request_client_ms=statistics.mean(r["client_ms"]
                                                 for r in reqs[1:3]),
        probs_request_ms=reqs[3]["latency_ms"],
        probs_request_client_ms=reqs[3]["client_ms"],
        tiled_probs_ms=statistics.median(bundle_row["tiled_probs_ms"]),
        bundle_predict_ms=statistics.median(bundle_row["bundle_predict_ms"]),
        spread_ms={k: [min(bundle_row[k]), max(bundle_row[k])]
                   for k in ("tiled_probs_ms", "bundle_predict_ms")},
        max_abs_dprob=bundle_row["max_abs_dprob"],
        **{f"{k}_{m}": bundle_row[f"{k}_{m}"]
           for k in ("tiled_probs", "bundle_predict")
           for m in ("device_busy_ms", "idle_share")},
        peak_memory_bytes=bundle_row["peak_memory_bytes"])

    def per_forward(key):
        return sum(NORM_CALLS["nores"] * r[f"nores_{key}"]
                   + NORM_CALLS["res"] * r[f"res_{key}"] for r in norm_rows)

    def bound(prefix):
        by_ops = met[f"{prefix}_ops_bound_ms"] > met[f"{prefix}_bytes_bound_ms"]
        return dict(bound_ms=max(met[f"{prefix}_ops_bound_ms"],
                                 met[f"{prefix}_bytes_bound_ms"]),
                    bound_by="operations" if by_ops else "bytes")

    kernels = [
        dict(name="fusednorm", route="cuda",
             source="dctseg_torch/csrc/fusednorm.cu",
             replaces="dctseg/ops/pallas/fusednorm.py:127",
             launches=eval_launches["fused_instance_norm_act"],
             max_abs_err=norm_err,
             ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
             bound_ms=per_forward("bound_ms"), bound_by="bytes",
             library_ms=per_forward("library_ms"),
             device_ms=per_forward("device_ms"),
             in_forward_device_ms=fwd_row["fusednorm_device_ms"],
             two_pass_floor_ms=per_forward("floor_ms"),
             per_width_ms={f"{r['shape'][1]}^3x{r['shape'][4]}": {
                 k: r[k] for k in ("nores_route", "nores_ms",
                                   "nores_device_ms", "res_ms",
                                   "res_device_ms")} for r in norm_rows},
             dispatch_us=dispatch["fusednorm"]["dispatch_us"],
             unit="per B=8 bf16 forward (32 calls)"),
        dict(name="attention", route="cuda",
             source="dctseg_torch/csrc/attention.cu",
             replaces="dctseg/ops/pallas/attention.py:59",
             launches=eval_launches["fused_attention"], max_abs_err=attn_err,
             mesh_calls_max_abs_err=mesh_call_errs["k2"],
             ms=ATTN_CALLS * attn_row["ms"],
             plain_ms=ATTN_CALLS * attn_row["plain_ms"],
             bound_ms=ATTN_CALLS * max(attn_row["bytes_bound_ms"],
                                       attn_row["flops_bound_ms"]),
             bound_by=("bytes" if attn_row["bytes_bound_ms"]
                       >= attn_row["flops_bound_ms"] else "operations"),
             library_ms=ATTN_CALLS * attn_row["library_ms"],
             device_ms=ATTN_CALLS * attn_row["device_ms"],
             library_device_ms=ATTN_CALLS * attn_row["library_device_ms"],
             call_ms=attn_row["ms"], strided_call_ms=attn_row["strided_ms"],
             library_call_ms=attn_row["library_ms"],
             dispatch_us=dispatch["attention"]["dispatch_us"],
             unit="per B=8 bf16 forward (13 calls)"),
        dict(name="relayout", route="cuda",
             source="dctseg_torch/csrc/relayout.cu",
             replaces="dctseg/ops/pallas/relayout.py:90",
             launches=train_rows["s2d_remat_none"]["launches"][
                 "space_to_depth"],
             max_abs_err=relayout_err, bound_by="bytes",
             **relayout_rows["train"], serve_b8=relayout_rows["serve"],
             dispatch_us=dispatch["relayout"]["dispatch_us"],
             unit="per B=1 bf16 train step (both sites, 2 launches; "
                  "medians of the repeats)"),
        dict(name="minplus", route="cuda",
             source="dctseg_torch/csrc/minplus.cu",
             replaces="dctseg/ops/pallas/minplus.py:80",
             launches=eval_launches["minplus_pass"], max_abs_err=minplus_err,
             ms=met["edt_ms"], plain_ms=met["edt_plain_ms"], **bound("edt"),
             library_ms=None, kernel_device_ms=met["edt_kernel_device_ms"],
             device_ms=met["edt_device_ms"],
             pass_floor_ms=met["edt_pass_floor_ms"],
             unit="per 240x240x155 volume (both EDTs, 3 launches)"),
        dict(name="orderstats", route="cuda",
             source="dctseg_torch/csrc/orderstats.cu",
             replaces="dctseg/ops/pallas/orderstats.py:57",
             launches=eval_launches["masked_order_stats"],
             max_abs_err=search_err,
             ms=met["search_ms"], plain_ms=met["search_plain_ms"],
             **bound("search"), library_ms=met["kthvalue_ms"],
             device_ms=met["search_device_ms"],
             pass_floor_ms=met["search_pass_floor_ms"],
             unit="per 240x240x155 volume (the whole search, 7 launches)"),
    ]
    fwd = int8_timing["forward_direct"]
    s2d_fwd = int8_timing["forward_s2d"]
    k7d, k7s = fwd["k7"], s2d_fwd["k7"]
    kernels += [
        dict(name="int8_conv3d", route="cuda",
             source="dctseg_torch/csrc/int8conv.cu",
             replaces="dctseg/ops/quant.py:118",
             launches=eval_int8_launches["int8_conv3d"], max_abs_err=int8_err,
             mesh_calls_max_abs_err=mesh_call_errs["k6"],
             ms=fwd["ms"], plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
             bound_by=fwd["bound_by"], library_ms=fwd["library_ms"],
             device_ms=fwd["device_ms"],
             s2d_forward={k: s2d_fwd[k] for k in (
                 "calls", "ms", "device_ms", "library_ms", "bound_ms")},
             per_call={k: int8_timing[k] for k in ("s2d_fullres_dense",
                                                   "en3")},
             kernel_routes=sorted(int8_timing["en3"]["route"]
                                  + int8_timing["s2d_fullres_dense"]["route"]),
             ptxas=k6_ptxas(),
             unit="per B=8 bf16 int8 forward on the direct path (25 calls); "
                  "library: cuDNN's bf16 conv of each call"),
        dict(name="fusednorm_amax", route="cuda",
             source="dctseg_torch/csrc/fusednorm.cu",
             replaces="dctseg/ops/pallas/fusednorm.py:127",
             launches=eval_int8_launches["fused_instance_norm_act_amax"],
             max_abs_err=norm_amax_err, ms=k7d["k1_amax_ms"],
             plain_ms=k7d["k1_amax_plain_ms"],
             bound_ms=k7d["k1_amax_bound_ms"], bound_by="bytes",
             library_ms=None, device_ms=k7d["k1_amax_device_ms"],
             amax_cost_device_ms=k7d["k1_amax_amax_cost_ms"],
             in_forward_amax_cost_ms={
                 p: r["profile"]["k1_amax_cost_ms"]
                 for p, r in int8_rows.items()},
             s2d_forward={k: k7s[f"k1_amax_{k}"] for k in (
                 "ms", "device_ms", "amax_cost_ms", "bound_ms")},
             unit=f"per B=8 bf16 int8 forward on the direct path "
                  f"({K7_CALLS['direct', 'int8']['from_amax']} calls)"),
    ]
    for name, route in (("quantize_absmax", "grid"),
                        ("quantize_from_amax", "from_amax")):
        kernels.append(dict(
            name=name, route="cuda", source="dctseg_torch/csrc/quantize.cu",
            replaces="dctseg/ops/quant.py:130",
            launches=eval_int8_launches[name], max_abs_err=quantize_err,
            ms=k7d[f"{route}_ms"], plain_ms=k7d[f"{route}_plain_ms"],
            bound_ms=k7d[f"{route}_bound_ms"], bound_by="bytes",
            library_ms=None, device_ms=k7d[f"{route}_device_ms"],
            two_pass_floor_ms=k7d[f"{route}_two_pass_floor_ms"],
            s2d_forward={k: k7s[f"{route}_{k}"] for k in (
                "ms", "device_ms", "bound_ms", "two_pass_floor_ms")},
            unit=f"per B=8 bf16 int8 forward on the direct path "
                 f"({K7_CALLS['direct', 'int8'][route]} calls, one launch "
                 f"each)"))
    kernels[-1]["forward"] = {p: int8_timing[f"forward_{p}"]["k7"]
                              for p in PATHS}
    ext_launches = space_fwd["launches"]
    kernels.append(dict(
        name="fusednorm_ext", route="cuda",
        source="dctseg_torch/csrc/fusednorm.cu",
        replaces="dctseg/ops/pallas/fusednorm.py:127",
        launches=(ext_launches["fused_norm_stats"]
                  + ext_launches["fused_norm_apply"]),
        max_abs_err=norm_ext_err, ms=ext_row["ms"],
        plain_ms=ext_row["plain_ms"], bound_ms=ext_row["bound_ms"],
        bound_by="bytes", library_ms=None, device_ms=ext_row["device_ms"],
        unit="per B=8 bf16 slab forward of a space=2 rank (32 calls, a "
             "statistics and an apply launch each; the all-reduce of the "
             "sums between them not counted); launches: one rank's "
             "tiled_probs in spatial_forward"))
    sp2 = space_int8["data1_space2"]
    am, ea = mesh_int8["quantize_amax"], mesh_int8["fusednorm_ext_amax"]
    kernels += [
        dict(name="quantize_amax", route="cuda",
             source="dctseg_torch/csrc/quantize.cu",
             replaces="dctseg/ops/quant.py:130",
             launches=sp2["launches"]["quantize_amax"],
             max_abs_err=quantize_err, ms=am["ms"], plain_ms=am["plain_ms"],
             bound_ms=am["bound_ms"], bound_by="bytes",
             library_ms=am["library_ms"], device_ms=am["device_ms"],
             reduce_amax=sp2["comm_per_volume"].get("reduce_amax"),
             unit=f"per B=8 bf16 int8 slab forward of a space=2 rank "
                  f"({int(am['calls'])} calls, one launch each; the MAX "
                  f"all-reduce of the slots not counted: reduce_amax, "
                  f"every K7 call's, gloo on one card); library: "
                  f"torch.linalg.vector_norm(x, inf); launches: one rank's "
                  f"int8 tiled_probs in spatial_int8"),
        dict(name="fusednorm_ext_amax", route="cuda",
             source="dctseg_torch/csrc/fusednorm.cu",
             replaces="dctseg/ops/pallas/fusednorm.py:127",
             launches=(sp2["launches"]["fused_norm_stats_amax"]
                       + sp2["launches"]["fused_norm_apply_amax"]),
             max_abs_err=norm_ext_amax_err, ms=ea["ms"],
             mesh_calls_max_abs_err=mesh_call_errs["k1"],
             plain_ms=ea["plain_ms"], bound_ms=ea["bound_ms"],
             bound_by="bytes", library_ms=None, device_ms=ea["device_ms"],
             unit=f"per B=8 bf16 int8 slab forward of a space=2 rank "
                  f"({int(ea['calls'])} calls with absmax slots, a "
                  f"statistics and an apply launch each; the all-reduce of "
                  f"the sums between them not counted); launches: one "
                  f"rank's int8 tiled_probs in spatial_int8"),
    ]
    log(timing="multi_gpu", unit="ms", parallel_train={
        k: {m: r[m] for m in ("steady_step_ms", "all_reduce_calls",
                              "nccl_device_ms")}
        for k, r in parallel_rows.items()},
        spatial_forward_volume_ms=space_fwd["volume_ms"],
        unsharded_volume_ms=space_fwd["unsharded_volume_ms"],
        spatial_int8_volume_ms={k: space_int8[k]["volume_ms"]
                                for k in INT8_MESHES},
        spatial_int8_comm={k: space_int8[k]["comm_per_volume"]
                           for k in INT8_MESHES},
        unsharded_int8_volume_ms=space_int8["unsharded_volume_ms"],
        spatial_train_step_ms={k: r["step_ms"]
                               for k, r in space_train.items()},
        conv3_vjp_ms={k: vjp_row[f"{k}_ms"] for k in ("xla", "explicit")})
    kernels += run_swin(dev)
    # ---- 6. result
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
