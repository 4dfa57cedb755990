"""Model profiling: parameter count, FLOPs, bytes, and runtime tracing (the
JAX package's ``dctseg/utils/profiling.py``).

The JAX package reads XLA's cost analysis of the compiled program; the
port counts what its eager forward dispatches:

  * flops: ``torch.utils.flop_counter.FlopCounterMode``, which counts the
    convolutions (transposed ones on their input grid), the matrix products
    and attention, plus the port's own operators by the formulas
    ``ops/library.py`` registers; elementwise work counts 0;
  * bytes: the operand and result bytes of every aten op (and port
    operator) as the forward dispatches it (under inference mode a
    composite op such as ``linear`` counts once, as one op), each counted
    where it is read or written.  This is an UNFUSED count, an upper bound
    on the traffic: XLA's estimate counts a fused program's inputs and
    outputs once.  Views, casts that return their input, and bare
    allocations move no data and count 0.

:func:`profile_model` traces the forward on fake tensors, so a full-width
model costs no compute and no device memory.  :func:`trace` records a
``torch.profiler`` trace of the enclosed work and writes it for Chrome's or
Perfetto's trace viewer.

:func:`span` marks a phase of the port's own work (``dctseg.<name>``) in
that trace: a ``record_function`` range, opened only while a profiler runs,
so the phases share the profile's clock with the kernels, copies and aten
ops under them.  The engine (``infer/engine.py``) and the Trainer
(``train/trainer.py``) open them; each ``tiled_probs`` call or train step
is a root span whose children are its phases.  With no profiler running a
span is one flag check and records nothing: the profiler is the only
recorder.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

TRACE_FILE = "trace.json"
# ops that allocate without reading or writing data
_NO_DATA = frozenset({torch.ops.aten.empty.memory_format,
                      torch.ops.aten.empty_strided.default,
                      torch.ops.aten.empty_like.default,
                      torch.ops.aten.new_empty.default,
                      torch.ops.aten.new_empty_strided.default})


SPAN_PREFIX = "dctseg."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager over one phase ``name`` of the port's work: while
    a ``torch.profiler`` profile runs, ``record_function("dctseg." + name)``;
    otherwise a shared no-op, at the cost of one flag check."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(SPAN_PREFIX + name)


def moves_data(func, args, out) -> bool:
    """Whether an op reads or writes tensor data: an in-place op does; an
    allocation does not, nor an op whose every result shares an input's
    storage (a view, a reshape of a contiguous tensor, a cast to its own
    dtype).  Read from the results: ops such as ``to`` and ``reshape`` may
    alias their input by their schema and still copy."""
    if func in _NO_DATA:
        return False
    if func._schema.is_mutable:
        return True
    inputs = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    return not all(any(torch._C._is_alias_of(t, i) for i in inputs)
                   for t in tree_leaves(out) if isinstance(t, torch.Tensor))


def count_params(model: torch.nn.Module) -> int:
    """Trainable parameters (the JAX package counts its params tree)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every dispatched op's tensor operands and
    results."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if moves_data(func, (args, kwargs), out):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def flops_of(fn: Callable, *example_args) -> Dict[str, float]:
    """Run ``fn(*example_args)`` once and count its flops and the bytes its
    ops read and write (unfused; see the module docstring)."""
    counter = _ByteCounter()
    with FlopCounterMode(display=False) as flops, counter:
        fn(*example_args)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(counter.bytes)}


def profile_model(model: torch.nn.Module, x: torch.Tensor
                  ) -> Dict[str, float]:
    """FLOPs, bytes and parameters of one eval forward of ``model`` on
    inputs shaped like ``x``: the keys of the JAX package's profile_model,
    counted on fake tensors (nothing runs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True) as fake, \
            torch.inference_mode():
        stats = flops_of(lambda t: model(t)[0], fake.from_tensor(x))
    stats["params"] = count_params(model)
    return stats


def clever_format(value: float) -> str:
    """thop.clever_format-style human units."""
    for unit, div in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(value) >= div:
            return f"{value / div:.3f}{unit}"
    return f"{value:.3f}"


@contextlib.contextmanager
def trace(log_dir: str = "dctseg_trace"):
    """Profile the enclosed work with ``torch.profiler`` (the CPU, and the
    GPU where there is one) and yield the profiler; on exit the Chrome trace
    is written to ``log_dir``/trace.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                record_shapes=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
