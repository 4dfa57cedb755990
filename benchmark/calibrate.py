"""Readings that the limits of a cell's checks are set from:

    python -m benchmark.calibrate --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process, the traffic kind's ``calibrate`` gives the
numbers ``correct`` compares for the program and for its control (a
lower precision in the program's place), without a measured window.  One
JSON line a seed on standard output, and a summary: per number the
largest program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    from benchmark.run import cache_env
    from benchmark import harness
    cache_env(harness.ROOT)
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    rows = []
    for seed in a.seeds:
        t0 = time.perf_counter()
        ctx = harness.Ctx(a.workload, seed, 0.0, False, t0)
        got = harness.traffic(ctx.cell["traffic"]).calibrate(ctx)
        row = {"seed": seed, "seconds": time.perf_counter() - t0, **got}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for kind, pick in (("program", max), ("control", min)):
        for name in rows[0][kind]:
            summary[f"{kind}.{name}"] = pick(r[kind][name] for r in rows)
    print(json.dumps({"summary": summary,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
