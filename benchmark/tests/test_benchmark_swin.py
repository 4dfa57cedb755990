"""The Swin UNETR cell's pieces on the CPU: its five per-layer readers on
synthetic profiles, the reference's copy against the tests' reference, the
counts against the port's own FLOP count, and the ``serve_regions`` kind at
a narrow width (correct, and not correct where an answer is altered)."""

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.reference import swin_unetr as bench_ref
from benchmark.reference import swin_unetr_counts
from benchmark.run import execute
from benchmark.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "tests"))
import swin_unetr_reference as tests_ref  # noqa: E402

SEED = 2 ** 31 + 777
CELL = "serve_swinunetr_bf16"
COUNTS = dict(flops=12e12, conv_bound_s=0.015, k1_bound_s=0.008,
              window_bound_s=0.0009)
TINY = dict(in_channels=4, out_channels=3, feature_size=24,
            depths=[2, 2, 2, 2], num_heads=[3, 6, 12, 24], window_size=7,
            mlp_ratio=4.0, qkv_bias=True, norm_eps=1e-5,
            compute_dtype="float32", fused_norms=True, window_kernel=True)


def host(name, device_us, start=10.0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=start, end=start + 1), cpu_parent=None,
        device_time_total=device_us)


def fake_ctx(device=(), host_events=(), items=2, k1_launches=0,
             k8_launches=0, per_item_s=0.1):
    t = object.__new__(Trace)
    t.device, t.host = list(device), list(host_events)
    t.t0, t.t1, t.items = 0.0, 1e9, items
    t.launches = {"fusednorm": k1_launches}
    ctx = SimpleNamespace(notes=[], trace=t,
                          counts={("swin_unetr", 8): COUNTS},
                          program_launches={"fused_window_attention":
                                            k8_launches},
                          per_item_s=lambda: per_item_s)
    ctx.missing = lambda metric, reason: ctx.notes.append(
        f"{metric}: not read: {reason}")
    return ctx


def kernels(name, n, us):
    return [(1000.0 * i, 1000.0 * i + us, name) for i in range(n)]


def test_mfu_swin():
    ctx = fake_ctx(per_item_s=0.1)
    assert harness.reader("mfu.swin")(ctx) == pytest.approx(
        100 * 12e12 / 0.1 / 989e12)


def test_swin_vit_ms_reads_one_span_a_volume():
    ctx = fake_ctx(host_events=[host("dctseg.swin.vit", 40000.0),
                                host("dctseg.swin.vit", 60000.0),
                                host("aten::add", 5.0)])
    assert harness.reader("swin_vit_ms.swin")(ctx) == pytest.approx(50.0)
    ctx = fake_ctx(host_events=[host("dctseg.swin.vit", 40000.0)])
    assert harness.reader("swin_vit_ms.swin")(ctx) is None
    assert ctx.notes[0].startswith("swin_vit_ms.swin: not read: 1 ")


def test_window_attn_roofline_needs_every_launch():
    name = "void dctseg::window_attention_kernel<__nv_bfloat16, 1, true>"
    dev = kernels(name, 16, 500.0) + kernels("norm_kernel", 3, 9.0)
    ctx = fake_ctx(device=dev, k8_launches=16)
    # 16 calls of 0.5 ms over 2 volumes: 4 ms a volume
    assert harness.reader("window_attn_roofline.swin")(ctx) == \
        pytest.approx(100 * 0.0009 / 0.004)
    for launched in (0, 15):
        ctx = fake_ctx(device=dev, k8_launches=launched)
        assert harness.reader("window_attn_roofline.swin")(ctx) is None
        assert len(ctx.notes) == 1


def test_k1_roofline_swin_needs_every_launch():
    name = "void dctseg::norm_kernel<__nv_bfloat16, 8, 1, 2, false>"
    dev = kernels(name, 10, 1600.0)
    ctx = fake_ctx(device=dev, k1_launches=10)
    assert harness.reader("k1_roofline.swin")(ctx) == pytest.approx(
        100 * 0.008 / 0.008)
    ctx = fake_ctx(device=dev, k1_launches=12)
    assert harness.reader("k1_roofline.swin")(ctx) is None


def test_conv_roofline_swin():
    convs = [host("aten::convolution", 25000.0) for _ in range(4)]
    ctx = fake_ctx(host_events=convs)
    assert harness.reader("conv_roofline.swin")(ctx) == pytest.approx(
        100 * 0.015 / 0.05)
    ctx = fake_ctx(host_events=convs + [host("aten::convolution", 0.0)])
    assert harness.reader("conv_roofline.swin")(ctx) is None


def test_reference_copy_matches_the_tests_reference():
    """The benchmark's copy has the tests' functions, and gives the same
    probabilities on the same weights, in float32 and in fp8."""
    names = {n for n in dir(tests_ref) if not n.startswith("__")}
    assert names <= {n for n in dir(bench_ref)}
    weights = bench_ref.make_weights(TINY, 5, "cpu")
    x = torch.randn(1, 32, 32, 32, 4, generator=torch.Generator()
                    .manual_seed(6))
    for precision in ("float32", "fp8"):
        with torch.no_grad():
            a = bench_ref.SwinUNETRRef(TINY, weights, precision).forward(x)
            b = tests_ref.SwinUNETRRef(TINY, weights, precision).forward(x)
        assert torch.equal(a[0], b[0])


def test_weights_are_seeded_and_load_into_the_port():
    from dctseg_torch.models import swin_unetr
    w1 = bench_ref.make_weights(TINY, 5, "cpu")
    assert all(torch.equal(w1[k], v)
               for k, v in bench_ref.make_weights(TINY, 5, "cpu").items())
    assert not torch.equal(
        w1["out.conv.conv.weight"],
        bench_ref.make_weights(TINY, 6, "cpu")["out.conv.conv.weight"])
    model = swin_unetr.SwinUNETR(swin_unetr.SwinUNETRConfig.from_dict(TINY))
    model.load_state_dict(w1, strict=True)
    table = w1["swinViT.layers1.0.blocks.0.attn.relative_position_bias_table"]
    assert 0.01 < float(table.std()) < 0.03


def test_counts_match_the_ports_flop_count():
    """The reference's FLOPs equal the port's own count of its forward
    (``profiling.profile_model`` on fake tensors: the convs, the linear
    layers and K8's formula)."""
    from dctseg_torch.models import swin_unetr
    from dctseg_torch.utils.profiling import profile_model
    got = swin_unetr_counts.count(TINY, 2, img=32)
    model = swin_unetr.SwinUNETR(swin_unetr.SwinUNETRConfig.from_dict(TINY))
    port = profile_model(model, torch.zeros(2, 32, 32, 32, 4))
    assert got["flops"] == port["flops"]
    assert got["convs"] == 33 and got["k1_sites"] == 26
    assert got["window_calls"] == 8


def tiny_config():
    cfg = harness.config("swin_unetr_serve")
    cfg["model"].update(feature_size=2, num_heads=[1, 1, 1, 1],
                        window_size=2, compute_dtype="float32")
    return cfg


@pytest.mark.parametrize("fault", ["none", "regions_swapped", "traced"])
def test_serve_regions_answer(tmp_path, monkeypatch, fault):
    """Served labels held to the reference.  Not correct: TC and ET swapped
    in one crop's region of the engine's probabilities.  Traced: the
    stretch runs and the line carries ``mfu.swin``; the readers of device
    time note that the CPU profile has none."""
    from dctseg_torch.infer.engine import Predictor
    if fault == "regions_swapped":
        real = Predictor.tiled_probs

        def altered(self, x, *a, **kw):
            p = real(self, x, *a, **kw).clone()
            p[:, :64, :64, :64] = p[:, :64, :64, :64][..., [2, 1, 0]]
            return p
        monkeypatch.setattr(Predictor, "tiled_probs", altered)
    cell = harness.cell(CELL)
    cell["params"].update(pool=1, warmup=1, sampled=1, reference_block=8)
    traced = fault == "traced"
    if traced:
        cell["params"].update(stretch=1)
    ctx = harness.Ctx(CELL, SEED, 0.05, traced, time.perf_counter(),
                      device="cpu", cell_spec=cell,
                      config_spec=tiny_config())
    ctx.work = tmp_path
    line = execute(ctx, harness.spec())
    assert line["correct"] is (fault != "regions_swapped")
    if traced:
        assert "mfu.swin" in line["metrics"]
        assert ctx.program_launches == {}    # no kernel on the CPU
        assert any(n.startswith("window_attn_roofline.swin: not read")
                   for n in ctx.notes)
    else:
        assert set(line["metrics"]) == {"volumes_per_s", "volume_p95_ms",
                                        "setup_s"}
