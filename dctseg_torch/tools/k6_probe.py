"""Where K6's time goes on the card: its tma route against copies of
itself with one part taken out, timed in turns on one GPU.

    python -m dctseg_torch.tools.k6_probe

The variants are ``csrc/int8conv.cu`` patched into a scratch build under
``dctseg_torch/_build/k6_probe/`` (each patch must match the source
exactly once, so a changed kernel fails here rather than measuring
something else):

  no_loads   the producer issues no TMA load, it only arrives on the full
             barrier: the consumers' wgmma, barriers and epilogue alone;
  no_mma     the consumers issue no wgmma: the loads, the barriers and the
             epilogue;
  no_stores  the epilogue converts but stores nothing;
  pair_stores  the epilogue stores each lane's column pairs, without the
             quad transpose into 16-byte stores.

At each of K6's largest main-path calls (B=8, bf16 out) the kernel, the
kernel with one (tap, chunk) unit a stage, each variant and cuDNN's bf16
conv of the same shape are timed in turns (card time: the calls queued
behind a sleep, CUDA events around them).  Prints the card's name and
power limit, then one JSON line per call.  Needs a GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys

import torch
import torch.nn.functional as F

from dctseg_torch.ops import _build, quant

INT8_TOPS = 1979e12              # H100 SXM dense int8 tensor-core peak
PROBE_DIR = _build.BUILD_DIR / "k6_probe"
VARIANTS = {
    "no_loads": [
        ("mbar_expect_tx(full, n * (a_box + b_box));", "mbar_arrive(full);"),
        ("tma_load_5d(sa + j * a_box,", "if (0) tma_load_5d(sa + j * a_box,"),
        ("tma_load_3d(sa + b_first + j * b_box,",
         "if (0) tma_load_3d(sa + b_first + j * b_box,")],
    "no_mma": [("Wgmma<BN>::mma(acc[i],", "if (0) Wgmma<BN>::mma(acc[i],")],
    "no_stores": [("if (!wide && one && row_at[i][h] >= 0) {",
                   "if (acc[i][e] == INT_MIN) {"),
                  ("if (col < g.co && row_at[i][h] >= 0)",
                   "if (acc[i][0] == INT_MIN)")],
    "pair_stores": [("const bool wide = g.co % 8 == 0;",
                     "const bool wide = false;")],
}
CALLS = {   # name: (input NDHWC, weight (Co, k, k, k, Ci)); stride 1, pad 1
    "s2d_fullres": ((8, 64, 64, 64, 128), (128, 3, 3, 3, 128)),
    "s2d_halfres": ((8, 32, 32, 32, 256), (256, 3, 3, 3, 256)),
    "s2d_in": ((8, 64, 64, 64, 32), (128, 3, 3, 3, 32)),
    "en3": ((8, 32, 32, 32, 64), (64, 3, 3, 3, 64)),
    "fea96": ((8, 32, 32, 32, 96), (32, 3, 3, 3, 96)),
    "de2": ((8, 16, 16, 16, 128), (128, 3, 3, 3, 128)),
}
STRIDE, PADS = (1, 1, 1), ((1, 1),) * 3


def patched(source: str, patches) -> str:
    """``source`` with each (old, new) applied; old must occur once."""
    for old, new in patches:
        if source.count(old) != 1:
            raise ValueError(f"probe patch {old!r} matches "
                             f"{source.count(old)} times")
        source = source.replace(old, new)
    return source


def build_variants() -> dict:
    """{name: loaded library} of the variants, built in parallel."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "int8conv.cu").read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        src = PROBE_DIR / f"int8conv_{name}.cu"
        src.write_text(patched(source, patches))
        lib = PROBE_DIR / f"libk6_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-shared", str(src), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        handle.dctseg_int8_conv3d.argtypes = [ctypes.c_void_p,
                                              ctypes.c_void_p]
        handle.dctseg_int8_conv3d.restype = ctypes.c_int
        libs[name] = handle
    return libs


def card_ms(fn, iters: int = 10) -> float:
    """The card's time per call of ``fn``: the calls queued behind a
    sleep kernel, CUDA events around them."""
    for _ in range(2):
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


def launcher(lib, operands, plan):
    """A call of ``lib``'s K6 entry on ``operands`` with ``plan``."""
    out, args = quant.conv_args(*operands, plan)
    stream = _build.stream_of(out)

    def call():     # holds ``args``: the C entry reads it at each launch
        _build.check(lib.dctseg_int8_conv3d(args.buffer_info()[0], stream),
                     "k6 probe")
        return out
    return call


def probe_call(name, x_shape, w_shape, libs, g) -> dict:
    dev = torch.device("cuda")
    xq = torch.randint(-127, 128, x_shape, dtype=torch.int8, device=dev,
                       generator=g)
    wq = torch.randint(-127, 128, w_shape, dtype=torch.int8, device=dev,
                       generator=g)
    sw = torch.rand(w_shape[0], device=dev, generator=g) * 1e-3 + 1e-4
    stats = torch.tensor([1.27, 0.01], device=dev)
    operands = (xq, stats, wq, sw, None, STRIDE, PADS, torch.bfloat16)
    out = quant.out_shape(x_shape, w_shape, STRIDE, PADS)
    plan = quant.plan_int8_conv(x_shape, w_shape, out[1:4], STRIDE,
                                _build.alignment(xq.data_ptr(),
                                                 wq.data_ptr()))
    one = plan._replace(group=1)
    one = one._replace(stages=min(
        quant.MAX_STAGES, (quant.SMEM_BYTES - quant.SMEM_ALIGN)
        // (one.stage_bytes() + quant.BARRIER_BYTES)))
    calls = {"kernel": launcher(_build.lib(), operands, plan),
             "one_unit_stages": launcher(_build.lib(), operands, one),
             **{v: launcher(lib, operands, plan) for v, lib in libs.items()}}
    if not torch.equal(calls["kernel"]().clone(),
                       calls["one_unit_stages"]()):
        raise AssertionError(f"{name}: one-unit stages disagree")
    xb = torch.randn((x_shape[0], x_shape[4], *x_shape[1:4]), device=dev,
                     generator=g).bfloat16().contiguous(
        memory_format=torch.channels_last_3d)
    wb = torch.randn((w_shape[0], w_shape[4], *w_shape[1:4]), device=dev,
                     generator=g).bfloat16().contiguous(
        memory_format=torch.channels_last_3d)
    calls["cudnn_bf16"] = lambda: F.conv3d(xb, wb, None, STRIDE, 1)
    order = list(calls)
    times = {k: [] for k in order}
    for key in order + order[::-1]:
        times[key].append(card_ms(calls[key]))
    ops = 2 * math.prod(out[:4]) * w_shape[0] * math.prod(w_shape[1:])
    row = dict(call=name, x=list(x_shape), w=list(w_shape),
               plan=plan._asdict(), bound_ms=ops / INT8_TOPS * 1e3,
               unit="card ms per call, two readings in turns",
               **{f"{k}_ms": v for k, v in times.items()})
    row["kernel_tops"] = ops / min(times["kernel"]) / 1e12 * 1e3
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_probe: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libs = build_variants()
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, (x_shape, w_shape) in CALLS.items():
        print(json.dumps(probe_call(name, x_shape, w_shape, libs, g)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
