"""Training over the port's multi-GPU mesh on the CPU: one DDP step and a
Trainer epoch over gloo groups of 2 or 4 processes
(``tests/torch_dist_worker.py``, which imports no JAX) against one
process over the same global batch and against the JAX package's Trainer
on the same mesh shape (conftest's 8 virtual CPU devices); the agreed stop
and the primary's checkpoint.

fp32, the tiny training model (img_dim 16, s2d, plain norms).
Tolerances:
  * one step's gradients against one process over the same global batch:
    rtol 1e-5, with an atol of 1e-5 of the model's largest gradient for
    the entries that are rounding noise (the conv biases ahead of an
    InstanceNorm, whose gradient is exactly zero);
  * the epoch loss against JAX's Trainer on the same mesh shape: rtol
    1e-4.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dctseg.config import Config as JaxConfig
from dctseg.config import DataConfig as JaxDataConfig
from dctseg.config import TrainConfig as JaxTrainConfig
from dctseg.config import tiny_model_config as jax_tiny_config
from dctseg.parallel.mesh import replicated
from dctseg.train.trainer import Trainer as JaxTrainer
from dctseg.train.trainer import TrainState
from dctseg.utils.torch_convert import convert_state_dict

from dctseg_torch.config import TrainConfig, tiny_model_config
from dctseg_torch.models.clswiseformer import ClsWiseFormer
from dctseg_torch.train import optim
from dctseg_torch.train.trainer import train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_worker import (CASES, TRAIN_MODEL,  # noqa: E402
                               finish_case, start_case)

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

TRAIN_CASES = ("train_data2", "train_data2_space2")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(12)
    train = ClsWiseFormer(tiny_model_config(**TRAIN_MODEL),
                          torch.Generator().manual_seed(1))
    return {
        "train_weights": train.state_dict(),
        "train_x": _t(rng.normal(size=(2, 16, 16, 16, 4)).astype(
            np.float32)),
        "train_target": _t(rng.integers(0, 4, size=(2, 16, 16, 16)).astype(
            np.uint8)),
        "train_edge": _t(rng.choice([0, 1, 2, 4, 5, 6, 7, 8],
                                    size=(2, 16, 16, 16)).astype(np.uint8)),
    }


@pytest.fixture(scope="module")
def started(inputs, tmp_path_factory):
    """Every case's ranks, started together: (processes, output dir).  The
    JAX oracles' fixtures take it, so that the ranks run while they
    compute."""
    dirs = {case: str(tmp_path_factory.mktemp(case)) for case in TRAIN_CASES}
    return {case: (start_case(case, inputs, out), out)
            for case, out in dirs.items()}


@pytest.fixture(scope="module")
def jax_epoch(started, inputs, tmp_path_factory):
    """JAX's Trainer on a (data=2, space=2) mesh from the same weights and
    samples: its global batch, steps and one epoch's logged metrics."""
    cfg = JaxConfig(
        model=jax_tiny_config(**TRAIN_MODEL),
        data=JaxDataConfig(synthetic_num_samples=2, input_shape=(24, 24, 20),
                           pad_depth=20, crop_size=(16, 16, 16),
                           num_workers=1),
        train=JaxTrainConfig(end_epoch=1, save_freq=1000, lr=1e-3,
                             checkpoint_dir=str(
                                 tmp_path_factory.mktemp("jax") / "ckpt"),
                             num_devices=4, spatial_shards=2))
    jt = JaxTrainer(cfg)
    assert dict(jt.mesh.shape) == {"data": 2, "space": 2}
    rep = replicated(jt.mesh)
    params = jax.device_put({"params": convert_state_dict(
        {k: v.numpy() for k, v in inputs["train_weights"].items()})}, rep)
    jt.state = TrainState(params, jax.jit(jt.tx.init, out_shardings=rep)(
        params), jnp.asarray(0, jnp.int32))
    return jt.global_batch, jt.train_epoch(0)


@pytest.fixture(scope="module")
def results(started, jax_epoch):
    """Every case's per-rank results, each case run once; collected after
    JAX's epoch, which runs while the ranks do."""
    return {case: finish_case(*started[case]) for case in TRAIN_CASES}


def test_data_mesh_shape_and_groups(results):
    """Two processes, no space axis: a data group of both, no space
    group, the mesh's group of both."""
    assert CASES["train_data2"][:2] == (2, 1)
    for r, res in enumerate(results["train_data2"]):
        assert res["mesh"] == {"shape": {"data": 2, "space": 1},
                               "data_index": r, "space_index": 0,
                               "data_group": [0, 1], "space_group": None,
                               "group": [0, 1]}


# ---- training ----

@pytest.fixture(scope="module")
def one_process(inputs):
    """The loss and every gradient of one process's step over both rows."""
    model = ClsWiseFormer(tiny_model_config(**TRAIN_MODEL))
    model.load_state_dict(inputs["train_weights"], strict=True)
    opt = optim.make_optimizer(model.parameters(),
                               TrainConfig(lr=1e-3, end_epoch=10))
    m = train_step(model, opt, 1e-3, inputs["train_x"],
                   inputs["train_target"], inputs["train_edge"])
    return m["loss"].item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_step_gradients_match_one_process(results, one_process, case):
    """One DDP step over (data=2) and (data=2, space=2), each data shard on
    its row of the global batch of 2, gives the loss and every gradient of
    one process's step over both rows."""
    loss, grads = one_process
    top = max(float(g.abs().max()) for g in grads.values())
    for res in results[case]:
        got = res["grads"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert set(got["grads"]) == set(grads)
        for name, g in grads.items():
            np.testing.assert_allclose(
                got["grads"][name].numpy(), g.numpy(), rtol=1e-5,
                atol=1e-5 * top, err_msg=name)


def test_epoch_loss_matches_jax_trainer(results, jax_epoch):
    """A Trainer epoch over a (data=2, space=2) mesh (global batch 2, one
    step) logs the loss JAX's Trainer logs on a (data=2, space=2) mesh
    from the same weights and samples."""
    global_batch, want = jax_epoch
    for res in results["train_data2_space2"]:
        got = res["epoch"]
        assert (got["global_batch"], got["steps"]) == (global_batch, 1)
        for k in ("loss", "end_loss", "s_loss", "edge_loss", "mid_s_loss",
                  "mid_edge_loss", "dice_wt"):
            np.testing.assert_allclose(got["metrics"][k], want[k],
                                       rtol=1e-4, err_msg=k)
        assert got["metrics"]["pred_counts"] == list(want["pred_counts"])


def test_agreed_stop_and_primary_checkpoint_resume(results):
    """Rank 1 alone asks to stop after its first step: both ranks stop at
    step 1, the primary writes the partial epoch-0 checkpoint, and a full
    resume from it on both ranks re-runs the epoch and ends with the same
    parameters on both."""
    r0, r1 = (res["stop"] for res in results["train_data2"])
    for res in (r0, r1):
        assert res["stopped"] == {"step": 1, "preempted": True,
                                  "files": ["model_epoch_0.pth"]}
        # the partial epoch 0 again (2 steps), then epoch 1 (2 steps)
        assert res["resumed_step"] == 5
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
