"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from dctseg_torch/csrc/ (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it;
  4. main path at full width (img_dim=128, base_channels=16, random seeded
     weights): fp32 seg_probs on the 8 crops of a volume through the
     kernels vs through the plain path, bf16 tta_probs on one 128^3 volume,
     then the main path, bf16 Predictor.tiled_probs on 3 seeded
     240x240x160x4 volumes, with the kernels' launch counters set to 0
     just before and read just after;
  5. time the engine, each kernel, its plain version and a PyTorch library
     call that computes the same function (CUDA events);
  6. print the kernels' JSON line, then the result line.
The last line of stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from dctseg_torch.config import ModelConfig
from dctseg_torch.infer.engine import Predictor
from dctseg_torch.models import clswiseformer as cwf
from dctseg_torch.ops import _build
from dctseg_torch.ops import attention as attn
from dctseg_torch.ops import fusednorm

SEED = 0
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core peak
# UNet widths of the direct path at img_dim=128 (spatial edge, channels)
NORM_WIDTHS = [(128, 16), (64, 32), (32, 64), (16, 128)]
# calls per B=8 forward at each width: encoder 2 blocks x 2 relu norms,
# decoder 2 blocks x (lrelu norm, lrelu norm + residual)
NORM_CALLS = {"nores": 6, "res": 2}
ATTN_SHAPE = (8, 8, 129, 64)     # B, heads, top_num + 1, head dim
ATTN_CALLS = 13                  # 3 couplers x 4 + the fusion coupler
VOLUME = (1, 240, 240, 160, 4)
N_VOLUMES = 3


def log(**kw):
    print(json.dumps(kw), flush=True)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


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


def gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


# ---------------------------------------------------------------- phase 3

def check_fusednorm(dev, widths, batch=8):
    """Kernel vs plain version at the main path's B=8 shapes (the stats
    pass's split of each sample depends on the batch).

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
    # an s2d-style view (8 offsets per fine channel) and two layouts the
    # 16-byte vector path does not take
    cases += [((batch, 16, 16, 16, 128), 16, "lrelu", True),
              ((batch, 8, 8, 8, 24), 3, "none", True),
              ((batch, 8, 8, 8, 12), 12, "relu", False)]
    worst_bf16 = 0.0
    for shape, fine, act, with_res in cases:
        x32 = torch.randn(shape, device=dev, generator=g) * 3 + 1
        r32 = torch.randn(shape, device=dev, generator=g)
        for dt in (torch.float32, torch.bfloat16):
            x, r = x32.to(dt), (r32.to(dt) if with_res else None)
            got = fusednorm.fused_instance_norm_act(x, fine, act=act,
                                                    residual=r)
            want = fusednorm.fused_instance_norm_act_plain(x, fine, act=act,
                                                           residual=r)
            err = (got.float() - want.float()).abs()
            over_ulps = None
            if dt == torch.float32:
                ok, tol = bool(err.max() <= 1e-4), "atol 1e-4"
            else:
                ulps = bf16_ulp(torch.maximum(got.float().abs(),
                                              want.float().abs()))
                tol = "1e-4 + 1 bf16 ulp of the output"
                if with_res:
                    pre = fusednorm.fused_instance_norm_act_plain(x, fine,
                                                                  act=act)
                    ulps = ulps + bf16_ulp(pre.float())
                    tol += " + 1 of the activation"
                ok = bool((err <= 1e-4 + ulps).all())
                # elements that only the absolute term admits
                over_ulps = int((err > ulps).sum())
                if shape[-1] == fine and shape[1:] != (8, 8, 8, 12):
                    worst_bf16 = max(worst_bf16, err.max().item())
            log(check="fusednorm", shape=list(shape), fine=fine, act=act,
                residual=with_res, dtype=str(dt), max_abs_err=err.max().item(),
                differing=(err > 0).float().mean().item(), over_ulps=over_ulps,
                tol=tol, ok=ok)
            if not ok:
                raise AssertionError(f"fusednorm kernel disagrees: {shape} "
                                     f"{fine} {act} {with_res} {dt}")
    torch.cuda.synchronize()
    return worst_bf16


def check_attention(dev, shape=ATTN_SHAPE):
    """Kernel vs plain version: f32 within 1e-5 (TF32 off), bf16 within
    1e-2.  Returns the bf16 error at the main path's shape."""
    g = gen(dev, SEED + 1)
    worst_bf16 = 0.0
    for shp in (shape, (2, 4, 33, 16), (1, 2, 50, 128)):
        q32, k32, v32 = (torch.randn(shp, device=dev, generator=g)
                         for _ in range(3))
        scale = shp[-1] ** -0.5
        for dt, atol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            got = attn.fused_attention(q, k, v, scale)
            want = attn.fused_attention_plain(q, k, v, scale)
            err = (got.float() - want.float()).abs().max().item()
            ok = err <= atol
            if shp == shape and dt == torch.bfloat16:
                worst_bf16 = err
            log(check="attention", shape=list(shp), dtype=str(dt),
                max_abs_err=err, tol=f"atol {atol}", ok=ok)
            if not ok:
                raise AssertionError(f"attention kernel disagrees: {shp} {dt}")
    torch.cuda.synchronize()
    return worst_bf16


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
    """seg_probs on the 8 crops of one volume (the main path's B=8 batch)
    through the kernels vs through the plain path (fused_norms and the
    attention kernel off), fp32 with TF32 off: probs within 1e-3 and the
    same top-k token sets in every routing."""
    vol = torch.randn(VOLUME, device=dev, generator=gen(dev, SEED + 2))
    x = Predictor.crops(vol)
    del vol
    results = {}
    for name, flags in (("kernels", dict(fused_norms=True,
                                         use_pallas_attention=True)),
                        ("plain", dict(fused_norms=False,
                                       use_pallas_attention=False))):
        cfg = ModelConfig(compute_dtype="float32", **cfg_kw, **flags)
        model = cwf.build_model(cfg, device=dev)
        model.load_state_dict(weights, strict=True)
        idx = []
        orig = record_topk(idx)
        try:
            probs = Predictor(model, device=dev).seg_probs(x)
        finally:
            cwf.topk_select = orig
        results[name] = (probs, idx)
        del model
    (pk, ik), (pp, ip) = results["kernels"], results["plain"]
    err = (pk - pp).abs().max().item()
    same_sets = all(torch.equal(a.sort(dim=1).values, b.sort(dim=1).values)
                    for a, b in zip(ik, ip)) and len(ik) == len(ip) == 13
    same_order = all(torch.equal(a, b) for a, b in zip(ik, ip))
    ok = err <= 1e-3 and same_sets and bool(torch.isfinite(pk).all())
    log(check="fp32_seg_probs_kernels_vs_plain", batch=x.shape[0],
        max_abs_err=err,
        tol="atol 1e-3", same_topk_sets=same_sets,
        same_topk_order=same_order, ok=ok)
    if not ok:
        raise AssertionError("fp32 kernel path disagrees with plain path")


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


# ---------------------------------------------------------------- phase 5

def time_fusednorm(dev, widths, batch=8, iters=10):
    """Per-width ms of the kernel, its plain version and the library's
    InstanceNorm + act (+ add), bf16, at the main path's B=8 shapes."""
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
            row[f"{kind}_ms"] = time_ms(
                lambda: fusednorm.fused_instance_norm_act(x, c, act=act,
                                                          residual=res),
                iters)
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


def time_attention(dev, shape=ATTN_SHAPE, iters=50):
    g = gen(dev, SEED + 4)
    q, k, v = (torch.randn(shape, device=dev, generator=g).bfloat16()
               for _ in range(3))
    scale = shape[-1] ** -0.5
    row = dict(shape=list(shape), dtype="bf16")
    row["ms"] = time_ms(lambda: attn.fused_attention(q, k, v, scale), iters)
    row["plain_ms"] = time_ms(
        lambda: attn.fused_attention_plain(q, k, v, scale), iters)
    row["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), iters)
    b, h, n, d = shape
    flops = 4 * b * h * n * n * d
    nbytes = 4 * q.numel() * q.element_size()
    row["bytes_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    row["flops_bound_ms"] = flops / BF16_FLOPS * 1e3
    log(timing="attention", **row)
    return row


def main() -> int:
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
               if "registers" in ln or "spill" in ln])

    # ---- 3. kernels vs plain versions
    norm_err = check_fusednorm(dev, NORM_WIDTHS)
    attn_err = check_attention(dev)
    log(phase="kernel_checks", ok=True)

    # ---- 4. main path, full width
    cfg_kw = dict(img_dim=128, base_channels=16, num_heads=8, top_num=128,
                  pe_type="fixed")
    weights = cwf.ClsWiseFormer(ModelConfig(**cfg_kw),
                                torch.Generator().manual_seed(SEED)
                                ).state_dict()
    check_fp32_paths(dev, cfg_kw, weights)

    model = cwf.build_model(ModelConfig(**cfg_kw), device=dev)
    model.load_state_dict(weights, strict=True)
    predictor = Predictor(model, device=dev)
    g = gen(dev, SEED + 5)
    check_tta(predictor, torch.randn((1, 128, 128, 128, 4), device=dev,
                                     generator=g))
    volumes = [torch.randn(VOLUME, device=dev, generator=g)
               for _ in range(N_VOLUMES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fusednorm.fused_instance_norm_act.launches = 0
    attn.fused_attention.launches = 0
    t0 = time.perf_counter()
    vol_ms = run_main_path(predictor, volumes)
    wall = time.perf_counter() - t0
    launches = {"fusednorm": fusednorm.fused_instance_norm_act.launches,
                "attention": attn.fused_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    log(phase="main_path", engine="tiled_probs", dtype="bfloat16",
        volumes=N_VOLUMES, per_volume_ms=vol_ms, wall_s=wall,
        launches=launches, peak_memory_bytes=peak)
    expected = {"fusednorm": 64 * N_VOLUMES, "attention": 13 * N_VOLUMES}
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    del volumes

    # ---- 5. timing
    steady = vol_ms[1:]
    log(timing="tiled_probs", dtype="bfloat16",
        first_volume_ms=vol_ms[0],
        steady_volume_ms=sum(steady) / len(steady))
    norm_rows = time_fusednorm(dev, NORM_WIDTHS)
    attn_row = time_attention(dev)

    def per_forward(key):
        return sum(NORM_CALLS["nores"] * r[f"nores_{key}"]
                   + NORM_CALLS["res"] * r[f"res_{key}"] for r in norm_rows)

    kernels = [
        dict(name="fusednorm", route="cuda",
             source="dctseg_torch/csrc/fusednorm.cu",
             replaces="dctseg/ops/pallas/fusednorm.py:127",
             launches=launches["fusednorm"], max_abs_err=norm_err,
             ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
             bound_ms=per_forward("bound_ms"), bound_by="bytes",
             library_ms=per_forward("library_ms"),
             two_pass_floor_ms=per_forward("floor_ms"),
             unit="per B=8 bf16 forward (32 calls)"),
        dict(name="attention", route="cuda",
             source="dctseg_torch/csrc/attention.cu",
             replaces="dctseg/ops/pallas/attention.py:59",
             launches=launches["attention"], max_abs_err=attn_err,
             ms=ATTN_CALLS * attn_row["ms"],
             plain_ms=ATTN_CALLS * attn_row["plain_ms"],
             bound_ms=ATTN_CALLS * max(attn_row["bytes_bound_ms"],
                                       attn_row["flops_bound_ms"]),
             bound_by=("bytes" if attn_row["bytes_bound_ms"]
                       >= attn_row["flops_bound_ms"] else "operations"),
             library_ms=ATTN_CALLS * attn_row["library_ms"],
             unit="per B=8 bf16 forward (13 calls)"),
    ]
    # ---- 6. result
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
