"""The port's evaluate driver restores the train driver's checkpoints as the
JAX driver does (``scripts/evaluate.py``; ``tests/test_driver_e2e.py``
asserts "loaded checkpoint epoch 2"): epoch ``--epoch``, or else the newest
of ``--checkpoint-dir``, unless ``--random-params``; an empty directory
leaves the seeded random weights and says so.  Two epochs of distinct
seeded weights are written with ``Checkpointer.save`` at the tiny config,
and each run's metrics show which weights it scored.  ``--quantize int8``
reaches the model on every strategy, the sweep and the ensemble included.
"""

import logging
import os

import numpy as np
import pytest
import torch

from dctseg_torch.cli import evaluate
from dctseg_torch.config import ModelConfig
from dctseg_torch.models.clswiseformer import build_model
from dctseg_torch.ops import quant
from dctseg_torch.train.checkpoint import Checkpointer
from dctseg_torch.utils.logging_utils import LOGGER

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

# the tiny config of tests/test_torch_trainer.py (TINY_ARGS), one volume
ARGS = ["--device", "cpu", "--strategy", "single", "--img-dim", "16",
        "--base-channels", "4", "--num-samples", "1", "--input-shape", "24",
        "24", "20", "--no-hd95"]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """Epochs 1 and 2, the weights of two seeded tiny models (the driver's
    own model is seed 0)."""
    path = tmp_path_factory.mktemp("ckpt")
    cfg = ModelConfig(img_dim=16, base_channels=4, top_num=1)
    for epoch in (1, 2):
        model = build_model(cfg, device="cpu", generator=torch.Generator()
                            .manual_seed(100 + epoch))
        Checkpointer(str(path)).save(epoch, model.state_dict(), {}, epoch)
    return str(path)


def _run(tmp_path, *extra):
    handler = _Lines()
    logger = logging.getLogger(LOGGER)
    logger.addHandler(handler)
    try:
        out = evaluate.main([*ARGS, "--output-dir", str(tmp_path / "out"),
                             *extra])
    finally:
        logger.removeHandler(handler)
    out.pop("sec_per_volume")
    return out, handler.lines


@pytest.fixture(scope="module")
def runs(ckpt_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    return {name: _run(tmp, *extra) for name, extra in (
        ("latest", ["--checkpoint-dir", ckpt_dir]),
        ("epoch2", ["--checkpoint-dir", ckpt_dir, "--epoch", "2"]),
        ("epoch1", ["--checkpoint-dir", ckpt_dir, "--epoch", "1"]),
        ("random", ["--checkpoint-dir", ckpt_dir, "--random-params"]))}


def test_evaluate_restores_the_newest_epoch_of_checkpoint_dir(runs):
    metrics, lines = runs["latest"]
    assert "loaded checkpoint epoch 2" in lines
    assert metrics == runs["epoch2"][0]


@pytest.mark.parametrize("other", ["epoch1", "random"])
def test_evaluate_scores_other_weights_with_epoch_or_random_params(runs,
                                                                   other):
    metrics, lines = runs[other]
    assert metrics != runs["latest"][0]
    want = ("loaded checkpoint epoch 1" if other == "epoch1"
            else "using random params (seed 0)")
    assert want in lines


def test_evaluate_without_checkpoints_keeps_random_params(tmp_path, runs):
    empty = tmp_path / "empty"
    metrics, lines = _run(tmp_path, "--checkpoint-dir", str(empty))
    assert f"no checkpoint found in {empty}; using random params" in lines
    assert metrics == runs["random"][0]


@pytest.mark.parametrize("extra", [[], ["--strategy", "sweep"],
                                   ["--multimodel"]],
                         ids=["single", "sweep", "multimodel"])
def test_evaluate_quantize_int8_reaches_the_model(tmp_path, ckpt_dir,
                                                  monkeypatch, extra):
    """At the tiny config the int8 rule quantizes the three conv_semantic
    convs (64 input channels): each forward runs them through the int8
    conv, and every score is finite."""
    calls = []
    orig = quant.int8_conv3d

    def counting(*args):
        calls.append(args[0].shape[0])
        return orig(*args)
    monkeypatch.setattr(quant, "int8_conv3d", counting)
    out = evaluate.main([*ARGS, "--output-dir", str(tmp_path / "out"),
                         "--checkpoint-dir", ckpt_dir, "--quantize", "int8",
                         *extra])
    assert calls and len(calls) % 3 == 0
    # the sweep's result is a dict of each epoch's metrics
    rows = out.values() if extra == ["--strategy", "sweep"] else [out]
    assert all(np.isfinite(v) for row in rows for v in row.values())
