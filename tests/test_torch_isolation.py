"""The port stands alone: no module of dctseg_torch/ and not chip_smoke.py
imports JAX, the JAX package, or a package the GPU machine lacks (pandas,
imageio, ml_dtypes, nibabel), and its entry points never fall back to the
CPU on their own."""

import ast
from pathlib import Path

import pytest
import torch

from dctseg_torch.cli import evaluate, train
from dctseg_torch.config import Config, tiny_model_config
from dctseg_torch.infer.engine import Predictor
from dctseg_torch.metrics import DeviceMetrics
from dctseg_torch.models.clswiseformer import build_model
from dctseg_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dctseg", "pandas",
             "imageio", "ml_dtypes", "nibabel"}
PORT_FILES = sorted((ROOT / "dctseg_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_sees_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import numpy\nfrom dctseg.config import ModelConfig\n"
                 "def g():\n    import jax.numpy as jnp\n")
    assert {"dctseg", "jax"} <= set(_imported_roots(f))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_model_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(model, device="cuda")
    assert Predictor(model, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceMetrics()
    assert DeviceMetrics(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--random-params", "--img-dim", "32",
                       "--base-channels", "4", "--num-samples", "1"])
    for extra in (["--strategy", "sweep"], ["--multimodel"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.main(extra + ["--img-dim", "32", "--base-channels", "4",
                                   "--num-samples", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config(model=tiny_model_config(fused_norms=False)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--img-dim", "16", "--base-channels", "4",
                    "--num-samples", "1", "--end-epoch", "1"])
