"""The port's serving bundles against the JAX package's, on the CPU.

Tiling bundles (both stitch modes, paired V=2, tiling_tta) move data around
one stand-in forward, the same on both sides, and must equal the port's live
engine and the JAX bundles bit for bit: crops, stitch and the flips are
pure data movement.  tiling_tta's softmax mean runs in the live engine's
order, but torch's and XLA's exp round differently: against the JAX bundle
it holds to 1e-6 (the tolerance of test_torch_engine.py's tiled TTA).

The tiny model's ``single`` and ``tta`` bundles run in fp32 with the same
weights as the JAX live engine and hold to it at the tolerance of
test_torch_engine.py (atol 1e-4: the same f32 function, reduced in other
orders); against the port's live engine they are bit-exact, after a save
and load.  The forward program holds the kernels as ``dctseg.*`` nodes.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dctseg.config import tiny_model_config as jax_tiny_config
from dctseg.infer import serving as jax_serving
from dctseg.infer.engine import Predictor as JaxPredictor
from dctseg.models.clswiseformer import build_model as jax_build_model
from dctseg.utils.torch_convert import convert_state_dict

from dctseg_torch.config import tiny_model_config
from dctseg_torch.convert import state_dict_from_jax
from dctseg_torch.infer.engine import Predictor
from dctseg_torch.infer.serving import (MANIFEST_NAME, ServingBundle,
                                        export_bundle)
from dctseg_torch.models.clswiseformer import ClsWiseFormer, build_model

FLAGS = dict(s2d_fullres=False, s2d_halfres=False)


class _Offset(torch.nn.Module):
    """A stand-in with one weight: (B, ..., M) -> ((B, ..., M) + offset,)."""

    def __init__(self, offset=0.5):
        super().__init__()
        self.register_buffer("offset", torch.tensor(float(offset)))

    def forward(self, x):
        return (x.float() + self.offset,)


class _JaxOffset:
    def apply(self, params, x, train=False):
        return (x + params,)


def _volumes(v, seed, shape=(240, 240, 160), channels=2):
    return np.random.default_rng(seed).normal(
        size=(v, *shape, channels)).astype(np.float32)


def _jax_bundle_probs(tmp_path, x, **kw):
    out = str(tmp_path / "jax")
    jax_serving.export_bundle(JaxPredictor(_JaxOffset(), jnp.asarray(0.5)),
                              out, in_channels=x.shape[-1], **kw)
    return np.asarray(jax_serving.ServingBundle.load(out).predict(
        jnp.asarray(x)))


def _port_bundle(tmp_path, **kw):
    out = str(tmp_path / "port")
    manifest = export_bundle(Predictor(_Offset(), device="cpu"), out, **kw)
    return manifest, ServingBundle.load(out, device="cpu")


@pytest.fixture(scope="module")
def volume():
    return _volumes(1, 0)


@pytest.mark.parametrize("stitch_mode", ["reference", "aligned"])
def test_tiling_bundle_matches_jax_bundle(volume, tmp_path, stitch_mode):
    manifest, bundle = _port_bundle(tmp_path, in_channels=2,
                                    stitch_mode=stitch_mode)
    assert set(manifest["programs"]) == {"crops", "forward", "stitch"}
    assert manifest["stitch_mode"] == stitch_mode
    assert manifest["output_shape"] == [1, 240, 240, 155, 2]
    got = bundle.predict(volume)
    np.testing.assert_array_equal(
        got.numpy(), _jax_bundle_probs(tmp_path, volume,
                                       stitch_mode=stitch_mode))
    live = Predictor(_Offset(), device="cpu").tiled_probs(volume,
                                                          stitch_mode)
    assert torch.equal(got, live)


def test_paired_tiling_bundle_matches_jax_bundle(tmp_path):
    x = _volumes(2, 5)
    manifest, bundle = _port_bundle(tmp_path, in_channels=2,
                                    batch_volumes=2)
    assert manifest["batch_volumes"] == 2
    assert manifest["output_shape"] == [2, 240, 240, 155, 2]
    got = bundle.predict(x)
    np.testing.assert_array_equal(
        got.numpy(), _jax_bundle_probs(tmp_path, x, batch_volumes=2))
    assert torch.equal(
        got, Predictor(_Offset(), device="cpu").tiled_probs_batch(x))
    # exactly V volumes a request; flip TTA stays per volume
    with pytest.raises(ValueError, match="shape"):
        bundle.predict(x[:1])
    with pytest.raises(ValueError, match="batch_volumes"):
        export_bundle(Predictor(_Offset(), device="cpu"),
                      str(tmp_path / "x"), strategy="tiling_tta",
                      batch_volumes=2)


def test_tiling_tta_bundle_matches_jax_bundle(volume, tmp_path):
    manifest, bundle = _port_bundle(tmp_path, strategy="tiling_tta",
                                    in_channels=2)
    assert set(manifest["programs"]) == (
        {f"crops_flip{i}" for i in range(8)}
        | {"forward", "stitch", "unflip_mean"})
    got = bundle.predict(volume)
    # the softmax mean: torch's and XLA's exp round differently
    np.testing.assert_allclose(
        got.numpy(), _jax_bundle_probs(tmp_path, volume,
                                       strategy="tiling_tta"), atol=1e-6)
    assert torch.equal(
        got, Predictor(_Offset(), device="cpu").tiled_tta_probs(volume))


def test_f16_wire_bundle_casts_its_input(tmp_path):
    x = _volumes(1, 6, shape=(8, 8, 8), channels=4)
    manifest, bundle = _port_bundle(tmp_path, strategy="single",
                                    input_shape=(8, 8, 8),
                                    input_dtype=torch.float16)
    assert manifest["input_dtype"] == "float16"
    want = torch.from_numpy(x).half().float() + 0.5
    assert torch.equal(bundle.predict(x), want)
    assert torch.equal(bundle.predict(torch.from_numpy(x)), want)


def test_bundle_from_another_device_is_moved(tmp_path):
    """A manifest that names another device sends the programs through
    torch.export's move_to_device_pass at load."""
    x = _volumes(1, 7, shape=(8, 8, 8), channels=4)
    _port_bundle(tmp_path, strategy="single", input_shape=(8, 8, 8))
    path = tmp_path / "port" / MANIFEST_NAME
    manifest = json.loads(path.read_text())
    path.write_text(json.dumps(dict(manifest, device="cuda")))
    bundle = ServingBundle.load(str(tmp_path / "port"), device="cpu")
    assert torch.equal(bundle.predict(x), torch.from_numpy(x) + 0.5)


def test_export_validates_strategy_and_shape(tmp_path):
    pred = Predictor(_Offset(), device="cpu")
    out = str(tmp_path / "x")
    with pytest.raises(ValueError, match="strategy"):
        export_bundle(pred, out, strategy="ensemble")
    with pytest.raises(ValueError, match="input_shape"):
        export_bundle(pred, out, strategy="tta")
    with pytest.raises(ValueError, match="geometry"):
        export_bundle(pred, out, strategy="tiling",
                      input_shape=(128, 128, 128))
    with pytest.raises(ValueError, match="geometry"):
        export_bundle(pred, out, strategy="tiling_tta",
                      input_shape=(240, 240, 150))
    with pytest.raises(ValueError, match="batch_volumes"):
        export_bundle(pred, out, batch_volumes=0)
    with pytest.raises(ValueError, match="stitch_mode"):
        export_bundle(pred, out, stitch_mode="overlap")
    assert not os.path.exists(out)


def test_load_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    _port_bundle(tmp_path, strategy="single", input_shape=(8, 8, 8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingBundle.load(str(tmp_path / "port"))


# ---- the tiny model ----


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The port's seeded tiny model and the JAX engine with the same weights
    (JAX params from the port state_dict by the JAX package's converter),
    and the port's ``single`` bundle of it, saved and loaded."""
    cfg = tiny_model_config(fused_norms=True, use_pallas_attention=True,
                            **FLAGS)
    seeded = ClsWiseFormer(cfg, torch.Generator().manual_seed(1))
    params = {"params": convert_state_dict(
        {k: v.numpy() for k, v in seeded.state_dict().items()})}
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    pred = Predictor(model, device="cpu")
    jp = JaxPredictor(jax_build_model(jax_tiny_config(**FLAGS)), params)
    out = str(tmp_path_factory.mktemp("tiny") / "single")
    export_bundle(pred, out, strategy="single", input_shape=(32, 32, 32))
    x = _volumes(1, 8, shape=(32, 32, 32), channels=4)
    return jp, pred, ServingBundle.load(out, device="cpu"), x


def test_single_bundle_matches_jax_and_live_engine(tiny):
    jp, pred, bundle, x = tiny
    got = bundle.predict(x)
    assert got.shape == (1, 32, 32, 32, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jp.seg_probs(x)),
                               atol=1e-4)
    # saved, loaded and run: the live engine's result, bit for bit
    assert torch.equal(got, pred.seg_probs(x))
    labels = bundle.labels(x)
    assert labels.dtype == torch.uint8 and labels.shape == x.shape[:4]
    assert bundle.manifest["output_shape"] == [1, 32, 32, 32, 4]
    assert bundle.manifest["device"] == "cpu"


def test_forward_program_holds_the_kernel_operators(tiny):
    """32 fused norms and 13 attentions a forward, as graph nodes: the
    trace kept the operators and not their plain versions."""
    forward = tiny[2]._p["forward"]
    targets = [n.target for n in forward.graph.nodes
               if n.op == "call_function"]
    ops = torch.ops.dctseg
    assert targets.count(ops.fused_instance_norm_act.default) == 32
    assert targets.count(ops.fused_attention.default) == 13
    assert ops.space_to_depth.default not in targets   # the direct path
    # export's dtype assertions and the f32 model's no-op casts are gone
    aten = torch.ops.aten
    assert aten._assert_tensor_metadata.default not in targets
    assert aten.to.dtype not in targets


def test_tta_bundle_matches_jax_and_live_engine(tiny, tmp_path):
    jp, pred, _, x = tiny
    out = str(tmp_path / "tta")
    manifest = export_bundle(pred, out, strategy="tta",
                             input_shape=(32, 32, 32))
    assert set(manifest["programs"]) == {"flips", "forward", "unflip_mean"}
    got = ServingBundle.load(out, device="cpu").predict(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(jp.tta_probs(x)),
                               atol=1e-4)
    assert torch.equal(got, pred.tta_probs(x))


def test_bundle_rejects_wrong_shape_and_format(tiny, tmp_path):
    bundle = tiny[2]
    with pytest.raises(ValueError, match="shape"):
        bundle.predict(np.zeros((1, 8, 8, 8, 4), np.float32))
    # a future format is refused, not misread
    manifest = dict(bundle.manifest, format=999)
    (tmp_path / MANIFEST_NAME).write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="format"):
        ServingBundle.load(str(tmp_path), device="cpu")


def test_folded_int8_bundle_carries_its_weights(tmp_path):
    """A folded int8 predictor on the s2d path exports its folded int8
    weights and scales as the program's constants (no weight is quantized
    or transformed while it runs), and the loaded bundle equals the live
    folded engine bit for bit."""
    cfg = tiny_model_config(img_dim=16, top_num=2, quantize="int8_all",
                            s2d_fullres=True, s2d_halfres=True)
    pred = Predictor(ClsWiseFormer(cfg, torch.Generator().manual_seed(3)),
                     device="cpu", fold_params=True)
    out = str(tmp_path / "int8")
    export_bundle(pred, out, strategy="single", input_shape=(16, 16, 16))
    bundle = ServingBundle.load(out, device="cpu")
    x = _volumes(1, 9, shape=(16, 16, 16), channels=4)
    assert torch.equal(bundle.predict(x), pred.seg_probs(x))
    ep = torch.export.load(os.path.join(out, "forward.pt2"))
    int8_consts = [t for t in ep.constants.values()
                   if isinstance(t, torch.Tensor) and t.dtype == torch.int8]
    targets = {n.target for n in ep.graph.nodes if n.op == "call_function"}
    calls = [n for n in ep.graph.nodes
             if n.target == torch.ops.dctseg.int8_conv3d.default]
    assert len(int8_consts) == len(calls) == 27
    assert torch.ops.aten.round.default not in targets
    assert torch.ops.aten.index_put.default not in targets
