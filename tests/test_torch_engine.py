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
import jax
import jax.numpy as jnp
import pytest
import torch

from dctseg.config import tiny_model_config as jax_tiny_config
from dctseg.infer.engine import Predictor as JaxPredictor
from dctseg.models.clswiseformer import build_model as jax_build_model

from dctseg_torch.config import tiny_model_config
from dctseg_torch.convert import state_dict_from_jax
from dctseg_torch.infer.engine import Predictor
from dctseg_torch.models.clswiseformer import build_model

FLAGS = dict(s2d_fullres=False, s2d_halfres=False)


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_tiny_config(**FLAGS)
    jmodel = jax_build_model(jcfg)
    x = np.random.default_rng(0).normal(size=(1, 32, 32, 32, 4)).astype(
        np.float32)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    params = jax.tree.map(np.asarray, params)
    cfg = tiny_model_config(fused_norms=True, use_pallas_attention=True,
                            **FLAGS)
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
