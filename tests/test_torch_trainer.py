"""The port's Trainer, checkpoints and drivers on the CPU, at img_dim 16 on
synthetic volumes.

No test waits on a real signal or an unbounded join: preemption goes
through ``request_stop``, and the batch feeder is joined with a timeout.
A checkpoint the port writes is held against the JAX package: its own
``load_torch_checkpoint`` reads it and the JAX forward equals the port's at
atol 1e-4 (fp32).
"""

import dataclasses
import json
import os
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dctseg.config import tiny_model_config as jax_tiny_config
from dctseg.models.clswiseformer import build_model as jax_build_model
from dctseg.utils.torch_convert import load_torch_checkpoint

from dctseg_torch.cli import evaluate, train
from dctseg_torch.config import (Config, DataConfig, TrainConfig,
                                 tiny_model_config)
from dctseg_torch.models.clswiseformer import build_model
from dctseg_torch.train.checkpoint import Checkpointer
from dctseg_torch.train.trainer import Trainer

# The suite runs in several xdist workers on one machine: one intra-op
# thread per worker keeps torch from oversubscribing the cores.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

MODEL = dict(img_dim=16, top_num=2, s2d_fullres=True, s2d_halfres=True,
             fused_norms=False, use_pallas_attention=False)


def _cfg(tmp_path, **train_kw):
    kw = dict(end_epoch=1, save_freq=1000, lr=1e-3,
              checkpoint_dir=str(tmp_path / "ckpt"))
    kw.update(train_kw)
    return Config(
        model=tiny_model_config(**MODEL),
        data=DataConfig(synthetic_num_samples=2, input_shape=(24, 24, 20),
                        pad_depth=20, crop_size=(16, 16, 16), num_workers=2),
        train=TrainConfig(**kw))


def test_fit_one_epoch_saves_and_changes_params(tmp_path):
    tr = Trainer(_cfg(tmp_path), device="cpu")
    assert tr.steps_per_epoch == 2
    tr.init_state()
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    last = tr.fit()
    assert np.isfinite(last["loss"]) and len(last["pred_counts"]) == 4
    assert tr.step == 2 and not tr.preempted
    assert Checkpointer(tr.cfg.train.checkpoint_dir).all_epochs() == [1]
    after = tr.model.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
    # the feeder thread is gone
    assert not any(t.name == "dctseg-batch-feeder"
                   for t in threading.enumerate())


def test_params_only_resume_seeds_the_schedule(tmp_path):
    tr = Trainer(_cfg(tmp_path, end_epoch=2, save_freq=1), device="cpu")
    tr.fit()
    saved = Checkpointer(tr.cfg.train.checkpoint_dir)
    assert saved.all_epochs() == [0, 1, 2] and saved.latest_epoch() == 2

    cfg = _cfg(tmp_path, start_epoch=1, end_epoch=3)
    tr2 = Trainer(cfg, device="cpu")
    assert tr2.resume() == 1
    assert tr2.step == 1 * tr2.steps_per_epoch
    assert tr2.schedule(tr2.step) == tr2.schedule(2)      # epoch 1's LR
    assert tr2.schedule(tr2.step) < tr2.schedule(0)
    for k, v in saved.restore_params(2).items():
        torch.testing.assert_close(tr2.model.state_dict()[k], v, rtol=0,
                                   atol=0)
    assert not tr2.optimizer.state        # fresh moments, as the reference


def test_full_resume_restores_optimizer_and_step(tmp_path):
    tr = Trainer(_cfg(tmp_path, end_epoch=1), device="cpu")
    tr.fit()
    tr2 = Trainer(_cfg(tmp_path, end_epoch=2), device="cpu")
    assert tr2.resume(restore_opt=True) == 2      # the final save, epoch 1
    assert tr2.step == 2
    for a, b in zip(tr.optimizer.state.values(),
                    tr2.optimizer.state.values()):
        for key in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


def test_request_stop_saves_partial_and_resume_reruns_the_epoch(tmp_path):
    tr = Trainer(_cfg(tmp_path, end_epoch=3), device="cpu")
    tr.init_state()
    orig = tr.train_step

    def stop_after_first(*a):
        out = orig(*a)
        tr.request_stop()
        return out
    tr.train_step = stop_after_first
    tr.fit()
    assert tr.preempted and tr.step == 1
    ckpt = Checkpointer(tr.cfg.train.checkpoint_dir)
    assert ckpt.all_epochs() == [0]
    _, _, meta = ckpt.restore_full(0)
    assert meta == {"epoch": 0, "step": 1, "partial": True}

    cfg = _cfg(tmp_path, end_epoch=1, resume=str(tmp_path / "ckpt"),
               restore_opt=True)
    tr2 = Trainer(cfg, device="cpu")
    tr2.fit()
    assert tr2.step == 3       # the interrupted epoch ran again: 1 + 2
    # a save to an epoch that has a file replaces it
    tr2.save(0)
    assert Checkpointer(cfg.train.checkpoint_dir).restore_full(0)[2] == {
        "epoch": 0, "step": 3, "partial": False}


def test_prefetch_off_and_grad_accum_train(tmp_path):
    cfg = _cfg(tmp_path, device_prefetch=0, batch_size=2, grad_accum=2)
    tr = Trainer(cfg, device="cpu")
    last = tr.fit()
    assert tr.step == 1 and np.isfinite(last["loss"])


def test_checkpoint_loads_into_the_jax_package(tmp_path):
    tr = Trainer(_cfg(tmp_path), device="cpu")
    tr.fit()
    path = Checkpointer(tr.cfg.train.checkpoint_dir).path(1)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert set(raw) == {"epoch", "state_dict", "optim_dict", "step",
                        "partial"}
    params = load_torch_checkpoint(path)
    x = np.random.default_rng(0).normal(size=(1, 16, 16, 16, 4)).astype(
        np.float32)
    jmodel = jax_build_model(jax_tiny_config(**MODEL))
    want = jax.jit(lambda p, v: jmodel.apply(p, v, train=False)[0])(
        params, jnp.asarray(x))
    with torch.inference_mode():
        got = tr.model(torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_trainer_rejects_inference_only_settings(tmp_path):
    cfg = _cfg(tmp_path)
    with pytest.raises(ValueError, match="fused_norms"):
        Trainer(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, fused_norms=True)),
            device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        Trainer(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, quantize="int8")),
            device="cpu")
    with pytest.raises(ValueError, match="grad_accum"):
        Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, grad_accum=2)), device="cpu")


TINY_ARGS = ["--img-dim", "16", "--base-channels", "4", "--num-samples",
             "2", "--input-shape", "24", "24", "20"]


def test_train_and_evaluate_drivers_run_on_cpu(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    tr, last = train.main(["--device", "cpu", *TINY_ARGS, "--end-epoch", "2",
                           "--save-freq", "1", "--num-workers", "2",
                           "--checkpoint-dir", ckpt,
                           "--log-dir", str(tmp_path / "logs"),
                           "--eval-at-save"])
    assert np.isfinite(last["loss"]) and tr.step == 4
    assert tr.cfg.model.s2d_fullres and tr.cfg.model.s2d_halfres
    # fp32 keeps the JAX driver's full remat
    assert not tr.cfg.model.fused_norms and tr.cfg.model.remat
    assert tr.cfg.model.remat_policy == "full"
    assert Checkpointer(ckpt).all_epochs() == [0, 1, 2]

    out = tmp_path / "eval"
    sweep = evaluate.main(["--device", "cpu", "--strategy", "sweep",
                           *TINY_ARGS[:4], "--num-samples", "1",
                           "--input-shape", "24", "24", "20", "--no-hd95",
                           "--checkpoint-dir", ckpt, "--output-dir",
                           str(out)])
    assert sorted(sweep) == [0, 1, 2]
    assert (out / "save_pth.csv").read_text().splitlines() == [
        "name,wt,tc,et"] + [f"epoch_{e},{sweep[e]['wt']},{sweep[e]['tc']},"
                            f"{sweep[e]['et']}" for e in (0, 1, 2)]
    ens = evaluate.main(["--device", "cpu", "--strategy", "single",
                         "--multimodel", *TINY_ARGS[:4], "--num-samples",
                         "1", "--input-shape", "24", "24", "20",
                         "--checkpoint-dir", ckpt, "--output-dir", str(out)])
    assert all(np.isfinite(v) for v in ens.values())
    json.dumps(ens)
    with pytest.raises(ValueError, match="random-params"):
        evaluate.main(["--device", "cpu", "--strategy", "sweep",
                       "--random-params"])


def test_build_model_loads_a_trainer_checkpoint_in_every_layout(tmp_path):
    """The checkpoint of the s2d-trained model loads strictly into the
    serving configuration (direct path, fused norms)."""
    tr = Trainer(_cfg(tmp_path), device="cpu")
    tr.fit()
    sd = Checkpointer(tr.cfg.train.checkpoint_dir).restore_params(1)
    serving = build_model(tiny_model_config(img_dim=16, top_num=2),
                          device="cpu")
    serving.load_state_dict(sd, strict=True)
    x = torch.randn(1, 16, 16, 16, 4)
    with torch.inference_mode():
        torch.testing.assert_close(serving(x)[0], tr.model(x)[0], rtol=0,
                                   atol=1e-4)
