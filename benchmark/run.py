"""Run one cell of the port's benchmark once and print its result line:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``dctseg_torch`` (the PyTorch and
CUDA port), on a machine with the NVIDIA cards the cell asks for.  With
``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a profiled stretch after the
measured window, and the stretch's busy and window seconds.  Both check
what the window produced against the plain reference (``correct``) and
print each compared number beside its limit, last on standard error and
last in the result line.  The last line of standard output is the result.

Exits non-zero, printing no result, where there is no CUDA card (or fewer
than the cell asks for), where the port cannot be imported, or where JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_env(root) -> None:
    """Kernel caches inside the checkout, at fixed paths."""
    work = root / ".bench_work"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(work / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(work / "triton")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def result(ctx, bench, per_layer: bool) -> dict:
    """The result line of a finished run."""
    import torch

    from benchmark import harness
    e2e, layer = harness.cell_metrics(bench, ctx.name)
    metrics = {}
    if per_layer:
        for m in layer:
            value = harness.reader(m["name"])(ctx)
            if value is None:
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] not in ctx.metrics:
                raise RuntimeError(f"the traffic kind reported no "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": ctx.metrics[m["name"]],
                                  "unit": m["unit"]}
    cuda = torch.device(ctx.device).type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": ctx.cell["chips"],
              "memory_peak_bytes": int(ctx.memory_peak),
              "power_limit": power_limit() if cuda else "none"}
    out = {"correct": ctx.correct, "attempted": ctx.attempted,
           "failed": ctx.failed, "metrics": metrics, "device": device}
    if per_layer:
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.trace.window_s
        out["breakdown"] = {"device_ops": ctx.trace.top_device_ops(),
                            "idle_gaps": ctx.trace.idle_gaps()}
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, v, lim in ctx.checks}
    return out


def main(argv=None) -> int:
    a = parse_args(argv)
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    cache_env(root)
    import torch

    from benchmark import harness
    bench = harness.spec()
    cell = harness.cell(a.workload)
    entry = [w for w in bench["workloads"] if w["name"] == a.workload]
    if not entry or any(entry[0][k] != cell[k]
                        for k in ("config", "traffic", "chips")):
        harness.log(f"{a.workload}: BENCHMARK.json and the cell's file "
                    "disagree or the cell is not listed: no result")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        harness.log(f"{a.workload} needs {cell['chips']} CUDA card(s); "
                    f"found {torch.cuda.device_count()}: no result")
        return 2
    harness.log(f"device: {torch.cuda.get_device_name(0)}, count "
                f"{torch.cuda.device_count()}, power limit {power_limit()}")
    ctx = harness.Ctx(a.workload, a.seed, a.seconds, bool(a.trace), T_START,
                      cell_spec=cell)
    line = execute(ctx, bench)
    if line is None:
        return 3
    print(json.dumps(line), flush=True)
    return 0


def execute(ctx, bench):
    """Run the cell's traffic kind and read its metrics: the result line,
    or None where JAX or the JAX package was loaded.  The notes and the
    checks go to standard error, the checks last."""
    from benchmark import harness
    harness.traffic(ctx.cell["traffic"]).run(ctx)
    found = harness.foreign_modules()
    if found:
        harness.log(f"loaded in the run: {', '.join(found)}; no result")
        return None
    line = result(ctx, bench, ctx.trace_on)
    for note in ctx.notes:
        harness.log(note)
    for name, value, limit in ctx.checks:
        harness.log(f"check {name} {value!r} limit {limit!r}")
    return line


if __name__ == "__main__":
    try:
        code = main()
    except Exception:   # a failed run prints its traceback and no result
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.exit(code)
