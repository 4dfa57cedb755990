"""The port's fused dispatch (``Predictor(fuse_dispatch=True)``) against the
staged engine and the JAX package's fused engine, on the CPU; the evaluate
driver's ``--pallas-attention``; and the launch arguments of K1's fused
route and K7's grid route, which a CUDA graph replays unchanged.

On the CPU the fused stage runs eagerly (the counterpart of JAX's jit on
the CPU), so fused and staged agree bit for bit; the card's replays are held
to the eager forward by ``chip_smoke.py``.  The tiny model runs in fp32 with
the same weights on both sides (atol 1e-4, the port's parity tolerance);
tiled_probs needs a 128^3 model, so both engines drive a pass-through
stand-in there, as ``tests/test_infer.py`` does.
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctseg.config import tiny_model_config as jax_tiny_config
from dctseg.infer.engine import Predictor as JaxPredictor
from dctseg.models.clswiseformer import build_model as jax_build_model
from dctseg.utils.torch_convert import convert_state_dict

from dctseg_torch.cli import evaluate
from dctseg_torch.config import tiny_model_config
from dctseg_torch.convert import state_dict_from_jax
from dctseg_torch.infer.engine import Predictor
from dctseg_torch.models import clswiseformer
from dctseg_torch.models.clswiseformer import ClsWiseFormer, build_model
from dctseg_torch.ops import _build, fusednorm, quant

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

FLAGS = dict(s2d_fullres=False, s2d_halfres=False)


@pytest.fixture(scope="module")
def tiny():
    """The JAX and port tiny models on one set of weights (the JAX params
    from a seeded port state_dict by the JAX package's converter), a
    (1, 32^3, 4) volume and a second weight set."""
    cfg = tiny_model_config(fused_norms=True, use_pallas_attention=True,
                            **FLAGS)
    sds = [ClsWiseFormer(cfg, torch.Generator().manual_seed(s)).state_dict()
           for s in (1, 2)]
    params = {"params": convert_state_dict(
        {k: v.numpy() for k, v in sds[0].items()})}
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    x = np.random.default_rng(0).normal(size=(1, 32, 32, 32, 4)).astype(
        np.float32)
    return (jax_build_model(jax_tiny_config(**FLAGS)), params, model, cfg, x,
            sds[1])


def _fresh(cfg, sd):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


# ---- tests/test_infer.py:79-120 ----


class _StandIn(torch.nn.Module):
    def forward(self, x):
        return (x * 2.0 + 1.0,)


class _JaxStandIn:
    def apply(self, params, x, train=False):
        return (x * 2.0 + 1.0,)


@pytest.fixture(scope="module")
def volume():
    return np.random.default_rng(2).normal(size=(1, 240, 240, 160, 2)).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["reference", "aligned"])
def test_fused_tiled_probs_bit_exact(volume, mode):
    """Crops and forward as one stage equal the staged engine and the JAX
    package's fused engine bit for bit."""
    fused = Predictor(_StandIn(), device="cpu", fuse_dispatch=True)
    staged = Predictor(_StandIn(), device="cpu")
    assert fused.fuse_dispatch and not staged.fuse_dispatch
    got = fused.tiled_probs(volume, stitch_mode=mode)
    np.testing.assert_array_equal(got.numpy(),
                                  staged.tiled_probs(volume, mode).numpy())
    jp = JaxPredictor(_JaxStandIn(), None, fuse_dispatch=True)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jp.tiled_probs(jnp.asarray(volume), mode)))


def test_fuse_dispatch_off_under_microbatch():
    assert not Predictor(_StandIn(), device="cpu", microbatch=4,
                         fuse_dispatch=True).fuse_dispatch
    assert not Predictor(_StandIn(), device="cpu").fuse_dispatch


@pytest.fixture(scope="module")
def staged_tta(tiny):
    """The staged, unfolded engine's flip TTA of the tiny volume, which
    the fused and the folded engines are held to."""
    _, _, model, _, x, _ = tiny
    return Predictor(model, device="cpu").tta_probs(x)


def test_fused_tta_matches_staged_and_jax(tiny, staged_tta):
    """Fused flip TTA equals the staged engine bit for bit and the JAX
    package's fused engine at 1e-4."""
    jmodel, params, model, _, x, _ = tiny
    got = Predictor(model, device="cpu", fuse_dispatch=True).tta_probs(x)
    np.testing.assert_array_equal(got.numpy(), staged_tta.numpy())
    jp = JaxPredictor(jmodel, params, fuse_dispatch=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jp.tta_probs(x)),
                               atol=1e-4)


def test_fold_params_with_fuse_dispatch(tiny, staged_tta):
    """fold_params and fuse_dispatch together equal the unfolded staged
    engine (bit for bit: the folded tensors are the ones a call computes)."""
    _, _, model, _, x, _ = tiny
    both = Predictor(model, device="cpu", fuse_dispatch=True,
                     fold_params=True)
    np.testing.assert_array_equal(both.tta_probs(x).numpy(),
                                  staged_tta.numpy())


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
def test_update_params_reaches_fused_answer(tiny, fold):
    """After update_params the fused engine answers with the new weights,
    folded or not; the folded tensors are rewritten in place, where a
    captured graph reads them."""
    _, _, model, cfg, x, sd2 = tiny
    engine = Predictor(_fresh(cfg, model.state_dict()), device="cpu",
                       fuse_dispatch=True, fold_params=fold)
    before = engine.tta_probs(x)
    held = {k: [t.data_ptr() for t in v]
            for k, v in (engine._folded or {}).items()}
    engine.update_params(sd2)
    after = engine.tta_probs(x)
    want = Predictor(_fresh(cfg, sd2), device="cpu").tta_probs(x)
    np.testing.assert_array_equal(after.numpy(), want.numpy())
    assert not torch.equal(before, after)
    assert held == {k: [t.data_ptr() for t in v]
                    for k, v in (engine._folded or {}).items()}


# ---- F5: the evaluate driver's --pallas-attention ----


class _Built(Exception):
    pass


@pytest.mark.parametrize("flags, want", [
    ([], True), (["--pallas-attention"], True),
    (["--no-pallas-attention"], False)], ids=["default", "on", "off"])
def test_evaluate_pallas_attention_reaches_config(monkeypatch, tmp_path,
                                                  flags, want):
    """The flag reaches ModelConfig.use_pallas_attention; the port's
    default stays on (the JAX driver's is off)."""
    seen = []

    def build(cfg, **kw):
        seen.append(cfg)
        raise _Built

    monkeypatch.setattr(clswiseformer, "build_model", build)
    with pytest.raises(_Built):
        evaluate.main(["--device", "cpu", "--random-params",
                       "--output-dir", str(tmp_path), *flags])
    assert seen[0].use_pallas_attention is want
    assert evaluate.parse_args(flags).pallas_attention is want


# ---- K1's fused route and K7's grid route under replay ----


def _norm_args(plan, x_ptr=4096):
    return fusednorm.launch_args(plan, x_ptr, 0, 8192, 16384, 32768, 8,
                                 (8, 32, 32, 32, 64), 64, "relu",
                                 torch.bfloat16, 8, 0)


@pytest.mark.parametrize("route", ["fused", "split"])
def test_fusednorm_args_hold_no_epoch(route):
    """Two calls on the same tensors pack the same arguments (a graph
    replays them unchanged): no per-call epoch; the fused route's barrier
    takes its generation from the workspace."""
    fused_blocks = 1056 if route == "fused" else 1
    plan = fusednorm.plan_launch(8, 32 ** 3, 64, 2, 8, fused_blocks, 1056,
                                 49152)
    assert plan.route == route
    args = _norm_args(plan)
    assert args == _norm_args(plan)
    assert len(args) == len(fusednorm.LAUNCH_ARGS)
    assert "epoch" not in " ".join(fusednorm.LAUNCH_ARGS)
    named = dict(zip(fusednorm.LAUNCH_ARGS, args))
    assert named["generations"] == named["tickets"] + 4 * 8
    assert named["fused"] == (route == "fused")


@pytest.mark.parametrize("route", quant.QUANT_ROUTES)
def test_quantize_args_hold_no_epoch(route):
    plan = quant.plan_quantize(8 * 32 ** 3 * 64, torch.bfloat16, 32, route,
                               1056)
    args = [quant.quantize_args(plan, 4096, 8192, 16384,
                                8 * 32 ** 3 * 64, torch.bfloat16,
                                *((32768, 8, 0) if route == "from_amax"
                                  else (0, 0, 65536))) for _ in range(2)]
    assert args[0] == args[1]
    assert len(args[0]) == len(quant.QUANT_ARGS)
    assert "epoch" not in " ".join(quant.QUANT_ARGS)


def _barrier(blocks: int, replays: int, rng, frozen_epoch: bool) -> bool:
    """The grid barrier of K1's fused route and K7's grid route, rehearsed
    in Python with its steps interleaved at random: each block reads the
    generation word, takes a ticket; the last ticket's block publishes the
    call's result and bumps the word (or, with ``frozen_epoch``, sets it to
    the epoch a captured graph froze); the others wait for it.  ``replays``
    calls with the same arguments.  True if every block passed its wait
    only after this call's result was published."""
    state = {"word": 0, "ticket": 0}
    for _ in range(replays):
        state["published"] = False
        step = [0] * blocks
        seen = [0] * blocks
        while any(s < 3 for s in step):
            b = rng.choice([i for i in range(blocks) if step[i] < 3])
            if step[b] == 0:
                seen[b] = state["word"]
            elif step[b] == 1:
                state["ticket"] += 1
                if state["ticket"] == blocks:
                    state["published"], state["ticket"] = True, 0
                    state["word"] = 1 if frozen_epoch else seen[b] + 1
            else:
                opened = (state["word"] == 1 if frozen_epoch
                          else state["word"] != seen[b])
                if not opened:
                    continue   # still waiting
                if not state["published"]:
                    return False
            step[b] += 1
    return True


def test_barrier_generation_rehearsal():
    """The generation word keeps every replay's barrier closed until its
    own result is out; a frozen epoch opens it early on the second
    replay."""
    rng = random.Random(0)
    assert all(_barrier(4, 3, rng, False) for _ in range(300))
    assert not all(_barrier(4, 3, rng, True) for _ in range(300))


class _Recorder:
    def __getattr__(self, name):
        def entry(*args):
            if name.endswith("coresident"):
                refs = [a for a in args if hasattr(a, "_obj")]
                for ref, value in zip(refs, (1056, 49152)):
                    ref._obj.value = value
            return 0
        return entry


def test_owned_workspaces_keep_graph_workspaces_apart(monkeypatch):
    """Inside owned_workspaces the kernels make their workspaces in the
    owner's store and leave the shared caches alone."""
    monkeypatch.setattr(_build, "lib", lambda: _Recorder())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    for mod, name in ((fusednorm, "_workspaces"), (fusednorm, "_coresident"),
                      (quant, "_quant_workspaces"),
                      (quant, "_quant_coresident")):
        monkeypatch.setattr(mod, name, {})
    fusednorm.plan_for.cache_clear()
    x = torch.zeros(2, 8, 8, 8, 16, dtype=torch.bfloat16)
    owned = {}
    with _build.owned_workspaces(owned):
        fusednorm._launch(fusednorm.VARIANTS["fused_instance_norm_act"], x,
                          None, 16, 1e-5, "relu", 0.01)
        quant._quantize_launch(x)
    fusednorm.plan_for.cache_clear()
    assert not fusednorm._workspaces and not quant._quant_workspaces
    assert set(owned) == {id(fusednorm._workspaces),
                          id(quant._quant_workspaces)}
    assert owned[id(fusednorm._workspaces)][-1, 0].counters.numel() >= 4
    assert owned[id(quant._quant_workspaces)][-1, 0].numel() == 3
