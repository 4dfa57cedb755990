"""The reference against the port's plain path at a tiny size on the CPU,
its operation count against the port's own, and its imports."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark.reference import adam, counts, loader, loss
from benchmark.reference.model import ClsWiseFormerRef, param_specs
from benchmark.traffic import train_steps
from benchmark.weights import make_weights

BENCH = Path(__file__).resolve().parents[1]
FOREIGN = {"jax", "jaxlib", "flax", "optax", "dctseg"}
FULL_FLOPS = 4_257_332_019_200      # the port's flops_of, B=8, direct path


def tiny(**kw):
    from dctseg_torch.config import tiny_model_config
    return tiny_model_config(dropout_rate=0.1, attn_dropout_rate=0.1,
                             init_conv_dropout=0.2, **kw)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    p for p in BENCH.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    """Nothing the benchmark runs imports JAX or the JAX package (top-level
    names compared whole); the reference imports nothing of the port."""
    found = top_level_imports(path)
    assert not found & FOREIGN
    if "reference" in path.parts:
        assert "dctseg_torch" not in found


def test_reference_loads_nothing_of_the_port():
    code = ("import sys, benchmark.reference.model, benchmark.reference."
            "loss, benchmark.reference.adam, benchmark.reference.loader, "
            "benchmark.reference.counts, benchmark.weights\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=BENCH.parent, check=True).stdout
    loaded = set(ast.literal_eval(out.strip()))
    assert not loaded & (FOREIGN | {"dctseg_torch"})


def test_state_dict_names_and_shapes():
    from dctseg_torch.models.clswiseformer import ClsWiseFormer
    cfg = tiny()
    sd = ClsWiseFormer(cfg).state_dict()
    specs = param_specs(dataclasses.asdict(cfg))
    assert [n for n, *_ in specs] == list(sd)
    assert all(tuple(sd[n].shape) == s for n, s, *_ in specs)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_equals_port(train):
    from dctseg_torch.models.clswiseformer import ClsWiseFormer
    cfg = tiny()
    mcfg = dataclasses.asdict(cfg)
    w = make_weights(mcfg, 5, "cpu")
    port = ClsWiseFormer(cfg)
    port.load_state_dict(w, strict=True)
    x = torch.randn(2, 32, 32, 32, 4, generator=torch.Generator()
                    .manual_seed(1))
    gen = (lambda: torch.Generator().manual_seed(3)) if train else (
        lambda: None)
    with torch.no_grad():
        got = port(x, train=train, generator=gen())
        want = ClsWiseFormerRef(mcfg, w).forward(x, gen())
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-4)
    for a, b in zip(got[1:], want[1:]):
        for r in a:
            torch.testing.assert_close(a[r], b[r], atol=1e-5, rtol=1e-4)


def test_training_step_equals_port():
    """One float32 step of the port's train_step (space-to-depth at both
    resolutions, Adam with amsgrad) against the reference's direct path."""
    from dctseg_torch.models.clswiseformer import ClsWiseFormer
    from dctseg_torch.train.optim import make_optimizer
    from dctseg_torch.train.trainer import train_step
    from dctseg_torch.config import TrainConfig
    cfg = tiny(s2d_fullres=True, s2d_halfres=True, fused_norms=False,
               use_pallas_attention=False)
    mcfg = dataclasses.asdict(cfg)
    w = make_weights(mcfg, 11, "cpu")
    port = ClsWiseFormer(cfg)
    port.load_state_dict(w, strict=True)
    tc = TrainConfig()
    opt = make_optimizer(port.parameters(), tc)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 32, 32, 32, 4, generator=g)
    target = torch.randint(0, 4, (1, 32, 32, 32), generator=g,
                           dtype=torch.uint8)
    edge = torch.from_numpy(loader.edge_map(target[0].numpy()))[None]
    got = train_step(port, opt, 2e-4, x, target, edge,
                     generator=torch.Generator().manual_seed(9))
    params = {n: t.clone().requires_grad_(True) for n, t in w.items()
              if not n.endswith(".pe")}
    ref = ClsWiseFormerRef(mcfg, {**w, **params})
    want = loss.total_loss(ref.forward(x, torch.Generator().manual_seed(9)),
                           target, edge)
    want.backward()
    raw = {n: q.grad.norm().item() for n, q in params.items()}
    median = float(np.median(list(raw.values())))
    step = adam.Adam(tc.weight_decay)
    step.step(params, 2e-4)
    assert abs(got["loss"].item() - want.item()) <= 1e-5 * abs(want.item())
    for n, q in port.named_parameters():
        exp_avg = opt.state[q]["exp_avg"] / (1 - train_steps.BETA1)
        torch.testing.assert_close(exp_avg, step.first_grad[n], atol=1e-6,
                                   rtol=1e-3)
        # the first step moves each element by about lr * sign(g): where
        # g is near zero its rounding decides the sign, and a leaf whose
        # whole gradient is rounding (a conv bias under InstanceNorm) moves
        # at random
        if raw[n] < 1e-3 * median:
            continue
        firm = step.first_grad[n].abs() > 1e-3 * step.first_grad[n].abs(
        ).max()
        torch.testing.assert_close(q.detach()[firm], params[n].detach()[firm],
                                   atol=1e-6, rtol=1e-5)


def test_loader_arithmetic_equals_port(tmp_path):
    """The reference's batch, worked out from the files, equals the port's
    loader's bit for bit."""
    from dctseg_torch.config import DataConfig
    from dctseg_torch.data.brats import BraTSDataset
    shape = (48, 44, 40)
    data.write_dataset(str(tmp_path), 3, 2, 5, shape, "cpu")
    cfg = DataConfig(root=str(tmp_path), input_shape=shape, pad_depth=40,
                     crop_size=(32, 32, 32))
    ds = BraTSDataset(str(tmp_path / "train.txt"), str(tmp_path), "train",
                      cfg=cfg)
    names = data.case_names(2)
    for index in range(5):
        got = ds.get(index, np.random.default_rng((77, 1, index)))
        chans, label = loader.load_case(str(tmp_path), names[index % 2],
                                        data.MODALITIES)
        x, t, e = loader.train_item(chans, label, (32, 32, 32), 40, 77, 1,
                                    index)
        assert torch.equal(got.x, torch.from_numpy(x))
        assert np.array_equal(got.target, t) and np.array_equal(got.edge, e)
    assert list(loader.epoch_order(5, 77, 3)) == __import__(
        "dctseg_torch.data.pipeline", fromlist=["x"]).shard_indices(
            5, 3, 77, 0, 1, True)


def test_poly_lr_equals_port():
    from dctseg_torch.train.optim import poly_schedule
    sched = poly_schedule(2e-4, 1000, 369, 0.9, 249)
    for step in (0, 1, 368, 369, 5000, 91000):
        assert adam.poly_lr(2e-4, 1000, 369, 0.9, step) == sched(step)


def test_operation_count_equals_ports_flops_of():
    """The reference's count of the full-width B=8 forward, on its direct
    path, equals the port's own FlopCounterMode count (4.257 TFLOP); the
    two differ in no operation."""
    from dctseg_torch.config import ModelConfig
    from dctseg_torch.models.clswiseformer import ClsWiseFormer
    from dctseg_torch.utils.profiling import profile_model
    model = dataclasses.asdict(ModelConfig())
    c = counts.count(model, 8, False)
    assert c["flops"] == FULL_FLOPS
    assert profile_model(ClsWiseFormer(ModelConfig()),
                         torch.zeros(8, 128, 128, 128, 4))["flops"] == \
        c["flops"]
    assert c["convs"] == 80 and c["k1_sites"] == 32
    # K1's byte bound: 12.8 GB a forward, 3.83 ms at 3.35 TB/s
    assert c["k1_bytes"] == 12_834_570_240


def test_weights_are_seeded():
    model = dataclasses.asdict(tiny())
    a, b = make_weights(model, 4, "cpu"), make_weights(model, 4, "cpu")
    c = make_weights(model, 5, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["Unet_list.InitConv.conv.weight"],
                           c["Unet_list.InitConv.conv.weight"])


def test_relative_gaps_leave_out_the_median_floor():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    got = {"a": 1.1, "b": 2.0, "c": 0.0}
    assert train_steps.relative_gaps(got, ref, ref) == pytest.approx(0.1)
