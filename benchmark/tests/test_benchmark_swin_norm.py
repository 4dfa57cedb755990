"""``swin_norm_roofline.swin`` on synthetic profiles: the value from a fake
trace, and no value where the profile and K9's counters disagree or no K9
kernel ran (the parent of the program that added K9 runs none); the bound
at the published widths."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.reference.counts import HBM_BYTES_PER_S
from benchmark.trace import Trace

NAME = "swin_norm_roofline.swin"
K9 = "void dctseg::(anonymous namespace)::layer_norm_kernel<__nv_bfloat16, 3>"
TORCH_LN = ("void at::native::(anonymous namespace)::"
            "vectorized_layer_norm_kernel<float, float, false>")


def fake_ctx(device, launches, items=2):
    t = object.__new__(Trace)
    t.device, t.host = list(device), []
    t.t0, t.t1, t.items = 0.0, 1e9, items
    ctx = SimpleNamespace(notes=[], trace=t, counts={},
                          config=harness.config("swin_unetr_serve"),
                          program_launches=launches)
    ctx.missing = lambda metric, reason: ctx.notes.append(
        f"{metric}: not read: {reason}")
    return ctx


def kernels(name, n, us):
    return [(1000.0 * i, 1000.0 * i + us, name) for i in range(n)]


def reader():
    return harness.reader(NAME)


def test_bound_at_the_published_widths():
    """4.49 GB a volume: 1.34 ms at HBM's rate (8 crops of 128^3)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "swin_norm", harness.HERE / "metrics" / f"{NAME}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    nbytes = mod.norm_bytes(harness.config("swin_unetr_serve")["model"])
    assert nbytes == 4_494_167_040
    assert nbytes / HBM_BYTES_PER_S == pytest.approx(1.3415e-3, rel=1e-4)


def test_reads_k9_time_a_volume():
    """50 K9 launches over 2 volumes, 80 us each: 2 ms a volume."""
    dev = kernels(K9, 50, 80.0) + kernels(TORCH_LN, 4, 500.0)
    ctx = fake_ctx(dev, {"layer_norm_to_windows": 16,
                         "windows_residual_layer_norm": 16,
                         "layer_norm": 18, "fused_window_attention": 16})
    assert reader()(ctx) == pytest.approx(
        100 * 4_494_167_040 / HBM_BYTES_PER_S / 0.002)
    assert ctx.notes == []


@pytest.mark.parametrize("launches", [
    {},                                          # the parent: no K9
    {"layer_norm_to_windows": 0, "windows_residual_layer_norm": 0,
     "layer_norm": 0},
    {"layer_norm_to_windows": 16, "windows_residual_layer_norm": 16,
     "layer_norm": 19}])                         # one launch not profiled
def test_missing_where_counters_and_kernels_disagree(launches):
    ctx = fake_ctx(kernels(K9, 50, 80.0), launches)
    assert reader()(ctx) is None
    assert len(ctx.notes) == 1 and ctx.notes[0].startswith(
        f"{NAME}: not read: ")


def test_torch_layer_norm_is_not_k9():
    ctx = fake_ctx(kernels(TORCH_LN, 50, 80.0),
                   {"layer_norm_to_windows": 16,
                    "windows_residual_layer_norm": 16, "layer_norm": 18})
    assert reader()(ctx) is None
