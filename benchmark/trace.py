"""Reduction of a profiled stretch to what the per-layer readers read.

The stretch is a bounded run of requests or steps after the measured
window, under ``torch.profiler`` (CPU and CUDA activities), inside one
``record_function`` range: busy time and the window both come from this
one trace.  Busy time is the union of the device's kernel, copy and fill
intervals inside the range; the idle gaps are what is left, each named by
the innermost host event that spans its middle.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

STRETCH = "bench.stretch"
# the port's launch counters (``<module>.<op>.launches``) and the device
# kernels their launches run, by the kernels' function names
COUNTERS = {
    "fusednorm": (("dctseg_torch.ops.fusednorm",
                   ("fused_instance_norm_act", "fused_instance_norm_act_amax",
                    "fused_norm_stats", "fused_norm_apply",
                    "fused_norm_stats_amax", "fused_norm_apply_amax")),
                  r"\bnorm_kernel\b"),
}


def read_counters() -> Dict[str, int]:
    """The port's launch counters, summed by kernel family."""
    import importlib
    out = {}
    for family, ((module, ops), _) in COUNTERS.items():
        mod = importlib.import_module(module)
        out[family] = sum(getattr(mod, op).launches for op in ops)
    return out


def _annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False))


class Trace:
    """What one profiled stretch holds: ``items`` requests or steps,
    ``window_s``, ``busy_s``, the device events and the host events."""

    def __init__(self, prof, items: int, launches: Dict[str, int]):
        self.items, self.launches = items, launches
        events = prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        window = [e for e in events if e.name == STRETCH
                  and e.device_type != cuda]
        if not window:
            raise RuntimeError(f"the profile holds no {STRETCH!r} range")
        self.t0 = window[0].time_range.start
        self.t1 = window[0].time_range.end
        self.window_s = (self.t1 - self.t0) / 1e6
        # ranges of record_function (the benchmark's spans, the
        # optimizer's step) show on the device's timeline too: no work
        marks = {e.name for e in events if _annotation(e)} | {STRETCH}
        self.device = sorted(
            ((e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == cuda and not _annotation(e)
             and e.name not in marks
             and e.time_range.end > self.t0 and e.time_range.start < self.t1),
            key=lambda s: s[0])
        self.host = [e for e in events if e.device_type != cuda
                     and e.name != STRETCH]
        self.busy, self.gaps = self._merge()
        self.busy_s = self.busy / 1e6

    def _merge(self) -> Tuple[float, List[Tuple[float, float]]]:
        busy, end, gaps = 0.0, self.t0, []
        for s, e, _ in self.device:
            e = min(e, self.t1)
            if e <= end:
                continue
            if s > end:
                gaps.append((end, s))
                busy += e - s
            else:
                busy += e - end
            end = e
        if self.t1 > end:
            gaps.append((end, self.t1))
        return busy, gaps

    def kernels(self, pattern: str) -> List[float]:
        """Durations (s) of the device events whose name matches."""
        rx = re.compile(pattern)
        return [(e - s) / 1e6 for s, e, n in self.device if rx.search(n)]

    def op_device_s(self, names: Iterable[str]) -> Tuple[float, int, int]:
        """(device seconds, calls, calls with no device time) of the host
        ops named ``names``, each with the kernels of its children, an op
        nested inside another of ``names`` counted with its parent."""
        names = set(names)
        total, calls, empty = 0.0, 0, 0
        for e in self.host:
            if e.name not in names or not self.t0 <= e.time_range.start \
                    <= self.t1:
                continue
            parent, nested = e.cpu_parent, False
            while parent is not None:
                if parent.name in names:
                    nested = True
                    break
                parent = parent.cpu_parent
            if nested:
                continue
            calls += 1
            t = e.device_time_total
            empty += t <= 0
            total += t / 1e6
        return total, calls, empty

    def top_device_ops(self, n: int = 10) -> List[list]:
        total = collections.Counter()
        for s, e, name in self.device:
            total[name[:120]] += (e - s) / 1e6
        return [[k, v] for k, v in total.most_common(n)]

    def idle_gaps(self, n: int = 10, labelled: int = 400) -> List[list]:
        """The idle time by what the host was doing: the ``labelled``
        longest gaps, each named by the innermost host event spanning its
        middle, summed by name."""
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:labelled]
        if not gaps:
            return []
        starts = np.array([e.time_range.start for e in self.host] or [0.0])
        ends = np.array([e.time_range.end for e in self.host] or [0.0])
        names = [e.name for e in self.host] or ["(none)"]
        total = collections.Counter()
        for s, e in gaps:
            mid = (s + e) / 2
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if inside.size:
                best = inside[np.argmin(ends[inside] - starts[inside])]
                label = names[best][:120]
            else:
                label = "(no host event)"
            total[label] += (e - s) / 1e6
        return [[k, v] for k, v in total.most_common(n)]


def profiled_stretch(device):
    """A ``torch.profiler.profile`` over the CPU and, on a card, the
    card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)

