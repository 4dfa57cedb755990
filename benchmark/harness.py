"""The harness's shared parts: finding cells, configurations, traffic kinds
and per-layer readers by name; seeds; spans; the profiled stretch; the
checks that decide ``correct``; and the result line.

Everything of one cell, configuration, traffic kind or per-layer metric
lives in a file of its own, found by the name ``BENCHMARK.json`` gives it:

  benchmark/workloads/<cell>.json     config, traffic, params, chips, why,
                                      limits of the checks
  benchmark/configs/<config>.json     the configuration as it is run
  benchmark/traffic/<traffic>.py      ``run(ctx)``: set-up, window, stretch,
                                      checks
  benchmark/metrics/<metric>.py       ``read(ctx)``: one per-layer number,
                                      or None where it has nothing to read
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# top-level modules that may not be loaded in a run: JAX and the JAX package
FOREIGN = ("jax", "jaxlib", "flax", "optax", "dctseg")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(kind: str):
    return importlib.import_module(f"benchmark.traffic.{kind}")


def reader(metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    sp = importlib.util.spec_from_file_location(
        f"benchmark_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, name: str):
    """(end-to-end metric entries, per-layer metric entries) this cell
    reports."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


def sub_seed(seed: int, purpose: str) -> int:
    """A seed under 2**31 for one use of the run's seed."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + list(
        purpose.encode())
    state = np.random.SeedSequence(words).generate_state(1)[0]
    return int(state) >> 1


def foreign_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``dctseg_torch`` is not ``dctseg``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FOREIGN)


def synchronize(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def free(device) -> None:
    """Hand the freed memory of the program's state back."""
    import gc

    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Spans:
    """The benchmark's own spans (host clock) around its calls into the
    program; inside a profiled stretch each is also a profiler range."""

    def __init__(self):
        self.records: List[tuple] = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.profiling:
            import torch
            rf = torch.profiler.record_function(f"bench.{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((name, t0, time.perf_counter()))
            if rf is not None:
                rf.__exit__(None, None, None)

    def durations(self, name: str, since: float = -math.inf,
                  until: float = math.inf) -> List[float]:
        return [b - a for n, a, b in self.records
                if n == name and since <= a and b <= until]


class Ctx:
    """One run of one cell: what the traffic kind gets and fills in, and
    what the per-layer readers read."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 t_start: float, device: str = "cuda",
                 cell_spec: Optional[dict] = None,
                 config_spec: Optional[dict] = None):
        self.name, self.seed, self.seconds = name, seed, seconds
        self.trace_on, self.t_start, self.device = trace, t_start, device
        self.cell = cell_spec if cell_spec is not None else cell(name)
        self.config = (config_spec if config_spec is not None
                       else config(self.cell["config"]))
        self.params = self.cell["params"]
        self.spans = Spans()
        self.work = ROOT / ".bench_work"
        # filled by the traffic kind
        self.metrics: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.window: Dict[str, float] = {}
        self.checks: List[tuple] = []
        self.memory_peak = 0
        self.trace = None            # a benchmark.trace.Trace
        self.counts: Dict[tuple, dict] = {}
        self.notes: List[str] = []

    def seed_for(self, purpose: str) -> int:
        return sub_seed(self.seed, purpose)

    def setup_done(self) -> None:
        self.metrics["setup_s"] = time.perf_counter() - self.t_start

    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared with its limit; above it the run is not
        correct."""
        self.checks.append((name, float(value), float(limit)))

    def reference_counts(self, batch: int, train: bool) -> dict:
        """The reference's counts of this configuration's forward at
        ``batch`` (``train``: with the loss and the backward)."""
        key = (batch, train)
        if key not in self.counts:
            from benchmark.reference.counts import count
            self.counts[key] = count(self.config["model"], batch, train)
        return self.counts[key]

    def per_item_s(self) -> float:
        """Seconds of the measured window per request or step."""
        return self.window["seconds"] / self.window["items"]

    def missing(self, metric: str, reason: str) -> None:
        self.notes.append(f"{metric}: not read: {reason}")

    @contextlib.contextmanager
    def stretch(self, items: int):
        """Profile the enclosed ``items`` requests or steps; the reduced
        profile becomes ``self.trace``."""
        import torch

        from benchmark import trace as tr
        synchronize(self.device)
        before = tr.read_counters()
        self.spans.profiling = True
        with tr.profiled_stretch(self.device) as prof:
            with torch.profiler.record_function(tr.STRETCH):
                yield
                synchronize(self.device)
        self.spans.profiling = False
        after = tr.read_counters()
        self.trace = tr.Trace(prof, items,
                              {k: after[k] - before[k] for k in after})

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)
