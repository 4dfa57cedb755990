"""The port's Predictor against the JAX package's, on the CPU.

seg_probs and tta_probs run the tiny model in fp32 with the same weights on
both sides (atol 1e-4).  The JAX side runs its XLA path (kernels off) under
jit; the port runs its slice configuration, whose kernel wrappers take the
plain versions on the CPU -- the same f32 function, rounding-close.

Crops and stitch of tiled_probs are pure data movement and must be
bit-exact.  tiled_probs needs a 128^3 model and a full-size forward is too
slow here, so both engines drive the same cheap stand-in forward.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dctseg.config import tiny_model_config as jax_tiny_config
from dctseg.infer.engine import Predictor as JaxPredictor
from dctseg.models.clswiseformer import build_model as jax_build_model
from dctseg.utils.torch_convert import convert_state_dict

from dctseg_torch.config import tiny_model_config
from dctseg_torch.convert import state_dict_from_jax
from dctseg_torch.infer.engine import Predictor, ensemble_probs
from dctseg_torch.models.clswiseformer import ClsWiseFormer, build_model

FLAGS = dict(s2d_fullres=False, s2d_halfres=False)


@pytest.fixture(scope="module")
def engines():
    """JAX params made from a seeded port model's state_dict by the JAX
    package's own converter (no flax init)."""
    jmodel = jax_build_model(jax_tiny_config(**FLAGS))
    x = np.random.default_rng(0).normal(size=(1, 32, 32, 32, 4)).astype(
        np.float32)
    cfg = tiny_model_config(fused_norms=True, use_pallas_attention=True,
                            **FLAGS)
    seeded = ClsWiseFormer(cfg, torch.Generator().manual_seed(1))
    params = {"params": convert_state_dict(
        {k: v.numpy() for k, v in seeded.state_dict().items()})}
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    return JaxPredictor(jmodel, params), Predictor(model, device="cpu"), x


def test_seg_probs_matches_jax(engines):
    jp, tp, x = engines
    got = tp.seg_probs(x)
    assert got.shape == (1, 32, 32, 32, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jp.seg_probs(x)),
                               atol=1e-4)


def test_tta_probs_matches_jax(engines):
    jp, tp, x = engines
    got = tp.tta_probs(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jp.tta_probs(x)),
                               atol=1e-4)
    # microbatching splits the B=8 forward without changing the result
    tp_mb = Predictor(tp.model, device="cpu", microbatch=3)
    np.testing.assert_allclose(tp_mb.tta_probs(x).numpy(), got.numpy(),
                               atol=1e-6)


def test_flip_batch_matches_jax(engines):
    jp, _, x = engines
    np.testing.assert_array_equal(
        Predictor.flip_batch(torch.from_numpy(x)).numpy(),
        np.asarray(jp._flip_batch_fn(jnp.asarray(x))))


class _StandIn(torch.nn.Module):
    """A cheap forward with the model's interface: (B, 128^3, M) ->
    ((B, 128^3, M) 'probs', ...)."""

    def forward(self, x):
        return (x * 2.0 + 1.0,)


class _JaxStandIn:
    def apply(self, params, x, train=False):
        return (x * 2.0 + 1.0,)


@pytest.fixture(scope="module")
def volume():
    rng = np.random.default_rng(2)
    return rng.normal(size=(1, 240, 240, 160, 2)).astype(np.float32)


def test_crops_bit_exact(volume):
    jp = JaxPredictor(_JaxStandIn(), None)
    np.testing.assert_array_equal(
        Predictor.crops(torch.from_numpy(volume)).numpy(),
        np.asarray(jp._crops_fn(jnp.asarray(volume))))


@pytest.mark.parametrize("stitch_ref", [True, False],
                         ids=["reference", "aligned"])
def test_stitch_bit_exact(stitch_ref):
    t = np.random.default_rng(3).normal(size=(8, 128, 128, 128, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(
        Predictor.stitch_volume(torch.from_numpy(t), stitch_ref).numpy(),
        np.asarray(JaxPredictor._stitch_volume(jnp.asarray(t), stitch_ref)))


@pytest.mark.parametrize("mode", ["reference", "aligned"])
def test_tiled_probs_bit_exact(volume, mode):
    jp = JaxPredictor(_JaxStandIn(), None)
    tp = Predictor(_StandIn(), device="cpu")
    got = tp.tiled_probs(volume, stitch_mode=mode)
    assert got.shape == (1, 240, 240, 155, 2)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jp.tiled_probs(jnp.asarray(volume), mode)))


def test_engines_reject_bad_input(engines):
    _, tp, x = engines
    with pytest.raises(ValueError, match="per volume"):
        tp.tta_probs(np.concatenate([x, x]))
    with pytest.raises(ValueError, match="stitch_mode"):
        tp.tiled_probs(x, stitch_mode="overlap")


class _Offset(torch.nn.Module):
    """A stand-in with one weight: (B, ..., M) -> ((B, ..., M) + offset,)."""

    def __init__(self, offset=0.0):
        super().__init__()
        self.register_buffer("offset", torch.tensor(float(offset)))

    def forward(self, x):
        return (x.float() + self.offset,)


class _JaxOffset:
    def apply(self, params, x, train=False):
        return (x + params,)


def _volumes(v, channels, seed, shape=(240, 240, 160)):
    return np.random.default_rng(seed).normal(
        size=(v, *shape, channels)).astype(np.float32)


@pytest.mark.parametrize("v", [1, 3])
def test_tta_probs_batch_matches_jax(v):
    x = _volumes(v, 4, 4, shape=(16, 16, 16))
    got = Predictor(_Offset(), device="cpu").tta_probs_batch(x)
    assert got.shape == (v, 16, 16, 16, 4)
    want = JaxPredictor(_JaxOffset(), jnp.asarray(0.0)).tta_probs_batch(
        jnp.asarray(x))
    # both average softmaxes; torch's and XLA's exp round differently
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    per_volume = Predictor(_Offset(), device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.concatenate([per_volume.tta_probs(x[i:i + 1]).numpy()
                                     for i in range(v)]))


@pytest.fixture(scope="module")
def volumes3():
    return _volumes(3, 1, 5)


@pytest.mark.parametrize("mode", ["reference", "aligned"])
def test_tiled_probs_batch_bit_exact(volumes3, mode):
    jp = JaxPredictor(_JaxOffset(), jnp.asarray(0.0))
    tp = Predictor(_Offset(), device="cpu")
    got = tp.tiled_probs_batch(volumes3, mode)
    assert got.shape == (3, 240, 240, 155, 1)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jp.tiled_probs_batch(jnp.asarray(volumes3),
                                                     mode)))
    np.testing.assert_array_equal(
        tp.tiled_probs_batch(volumes3[:1], mode).numpy(),
        tp.tiled_probs(volumes3[:1], mode).numpy())
    # microbatch splits the B=24 forward without changing the result
    np.testing.assert_array_equal(
        Predictor(_Offset(), device="cpu", microbatch=8).tiled_probs_batch(
            volumes3, mode).numpy(), got.numpy())


def test_tiled_tta_probs_batch_matches_per_volume_and_jax(volumes3):
    x2 = volumes3[:2]
    tp = Predictor(_Offset(), device="cpu")
    got = tp.tiled_tta_probs(x2)
    np.testing.assert_array_equal(
        got.numpy(), np.concatenate([tp.tiled_tta_probs(x2[v:v + 1]).numpy()
                                     for v in range(2)]))
    want = JaxPredictor(_JaxOffset(), jnp.asarray(0.0)).tiled_tta_probs(
        jnp.asarray(x2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_ensemble_probs_and_update_params():
    x = np.ones((1, 240, 240, 160, 1), np.float32)
    pred = Predictor(_Offset(), device="cpu")
    sets = [{"offset": torch.tensor(0.0)}, {"offset": torch.tensor(2.0)}]
    out = ensemble_probs(lambda: pred.tiled_probs(x, "aligned"), pred, sets)
    np.testing.assert_array_equal(out.numpy(), 2.0)     # (1 + 3) / 2
    out4 = ensemble_probs(lambda: pred.tiled_probs(x, "aligned"), pred, sets,
                          divisor=4.0)
    np.testing.assert_array_equal(out4.numpy(), 1.0)
    assert pred.model.offset.item() == 2.0              # the last set stays
    with pytest.raises(RuntimeError, match="Unexpected key"):
        pred.update_params({"offset": torch.tensor(1.0), "bias": 1.0})


# ---- the volume's way to the device (Predictor._input)

@pytest.mark.parametrize("kind", ["tensor", "array"])
def test_cpu_input_takes_the_host_route(kind):
    x = np.random.default_rng(4).normal(size=(1, 6, 5, 4, 4)).astype(
        np.float32)
    pred = Predictor(_StandIn(), device="cpu")
    got = pred._input(torch.from_numpy(x) if kind == "tensor" else x)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), x)
    assert pred.input_routes == {"staged": 0, "pinned": 0, "device": 0,
                                 "host": 1}


def test_device_input_is_returned_as_is():
    pred = Predictor(_StandIn(), device="meta")
    x = torch.empty((1, 6, 5, 4, 4), device="meta")
    assert pred._input(x) is x
    assert pred.input_routes == {"staged": 0, "pinned": 0, "device": 1,
                                 "host": 0}


def test_non_contiguous_host_input_takes_the_host_route():
    pred = Predictor(_StandIn(), device="meta")
    x = torch.zeros((1, 6, 5, 8, 4))[:, :, :, :5]
    got = pred._input(x)
    assert got.device.type == "meta" and got.shape == x.shape
    assert pred.input_routes == {"staged": 0, "pinned": 0, "device": 0,
                                 "host": 1}
