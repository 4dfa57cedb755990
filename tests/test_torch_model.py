"""The port's ClsWiseFormer against the JAX package's, on the CPU in fp32 at
the tiny config, with the same weights (JAX params converted by
dctseg_torch.convert) and the same input.

The JAX side runs its Pallas kernels in interpret mode where the config
turns them on (as tests/test_pallas.py does); the port's wrappers take the
kernels' plain versions on CPU tensors.  Tolerance: atol 1e-4 on all five
outputs (probabilities), the f32 reduction orders differing.  Top-k routing
is discontinuous, so every routing's indices must be equal first.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dctseg.models.clswiseformer as jax_cwf
from dctseg.config import tiny_model_config as jax_tiny_config
from dctseg.ops.pallas import attention as jax_attention
from dctseg.ops.pallas import fusednorm as jax_fusednorm
from dctseg.utils.torch_convert import (convert_state_dict,
                                        reference_state_dict_names,
                                        to_torch_state_dict)

import dctseg_torch.models.clswiseformer as cwf
from dctseg_torch.config import ModelConfig, tiny_model_config
from dctseg_torch.convert import (load_reference_checkpoint, pe_buffer,
                                  state_dict_from_jax)
from dctseg_torch.models.clswiseformer import build_model

SLICE_FLAGS = dict(fused_norms=True, use_pallas_attention=True,
                   s2d_fullres=False, s2d_halfres=False)
PLAIN_FLAGS = dict(fused_norms=False, use_pallas_attention=False,
                   s2d_fullres=False, s2d_halfres=False)


def _input():
    return np.random.default_rng(0).normal(size=(1, 32, 32, 32, 4)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_tiny():
    """Tiny JAX params, made from a seeded port model's state_dict by the
    JAX package's own converter (no flax init), and one input volume."""
    model = cwf.ClsWiseFormer(tiny_model_config(**PLAIN_FLAGS),
                              torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return {"params": convert_state_dict(sd)}, _input()


@pytest.fixture(scope="module")
def jax_init_params():
    """Tiny JAX params from flax's own init (jitted): what the converter
    test needs.  Both converters read the same values, so the init is
    compiled at XLA's lowest backend optimization level (a quarter of the
    compile time; its values may differ from the default's in the last
    bits)."""
    x = jnp.asarray(_input())
    model = jax_cwf.build_model(jax_tiny_config(**PLAIN_FLAGS))
    key = jax.random.PRNGKey(0)
    init = jax.jit(lambda k: model.init(k, x, train=False)).lower(key).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return jax.tree.map(np.asarray, init(key))


def _record_topk(monkeypatch, module, store):
    orig = module.topk_select

    def recording(tokens, query, k):
        selected, idx = orig(tokens, query, k)
        store.append(idx)
        return selected, idx
    monkeypatch.setattr(module, "topk_select", recording)


def _interpret_kernels(monkeypatch):
    orig_attn = jax_attention.fused_attention
    monkeypatch.setattr(
        jax_attention, "fused_attention",
        lambda q, k, v, scale: orig_attn(q, k, v, scale, interpret=True))
    orig_norm = jax_fusednorm.fused_instance_norm_act
    monkeypatch.setattr(
        jax_fusednorm, "fused_instance_norm_act",
        lambda *a, **kw: orig_norm(*a, **{**kw, "impl": "interpret"}))


@pytest.mark.parametrize("flags", [SLICE_FLAGS, PLAIN_FLAGS],
                         ids=["kernels", "plain"])
def test_forward_matches_jax(jax_tiny, monkeypatch, flags):
    """B=1 (the interpret-mode kernels are slow on the JAX side); the
    batched routing is held to JAX at B=8 by test_torch_engine's TTA.
    JAX's forward runs under jax.jit (the comparison needs no eager op
    order), the routings it traces returned beside its outputs."""
    params, x = jax_tiny
    _interpret_kernels(monkeypatch)
    traced, port_idx = [], []
    _record_topk(monkeypatch, jax_cwf, traced)
    _record_topk(monkeypatch, cwf, port_idx)

    jmodel = jax_cwf.build_model(jax_tiny_config(**flags))

    def forward(p, v):
        return jmodel.apply(p, v, train=False), list(traced)
    want, jax_idx = jax.jit(forward)(params, jnp.asarray(x))
    cfg = tiny_model_config(**flags)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))

    assert len(port_idx) == len(jax_idx) == 13
    for i, (a, b) in enumerate(zip(port_idx, jax_idx)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"routing {i}")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    for j in range(1, 5):
        assert set(got[j]) == set(want[j]) == {"01", "02", "04"}
        for r in got[j]:
            np.testing.assert_allclose(got[j][r].numpy(),
                                       np.asarray(want[j][r]), atol=1e-4,
                                       err_msg=f"output {j} region {r}")


def test_converted_params_match_reference_converter(jax_init_params,
                                                   tmp_path):
    """Keys are the reference's 222 names; every tensor but the four PE
    buffers equals the JAX package's own converter output; the PE buffers
    are the config-sized sinusoid table.  A reference-format .pth loads
    strictly."""
    params = jax_init_params
    cfg = tiny_model_config(**SLICE_FLAGS)
    sd = state_dict_from_jax(params, cfg)
    names = reference_state_dict_names()
    assert list(sd) == names and len(names) == 222
    ref = to_torch_state_dict(params)
    pe_names = [n for n in names if n.endswith(".pe")]
    assert len(pe_names) == 4
    for name in names:
        if name in pe_names:
            assert sd[name].shape == (1024, 1, 128)
            np.testing.assert_array_equal(sd[name].numpy(), pe_buffer(cfg))
        else:
            np.testing.assert_array_equal(sd[name].numpy(), ref[name],
                                          err_msg=name)

    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    path = tmp_path / "ref.pth"
    ckpt = {f"module.{k}": torch.tensor(v) for k, v in ref.items()}
    for name in pe_names:
        ckpt[f"module.{name}"] = sd[name]
    torch.save({"epoch": 0, "state_dict": ckpt, "optim_dict": {}}, path)
    fresh = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    load_reference_checkpoint(fresh, str(path))
    for name, value in fresh.state_dict().items():
        torch.testing.assert_close(value, sd[name], rtol=0, atol=0)


def test_full_size_model_matches_reference_layout():
    """Full width: 16,824,556 parameters, the reference's 222 state_dict
    keys, and PE buffers equal to the reference's (1024, 1, 512) table."""
    from dctseg.utils.torch_convert import _pe_buffer
    cfg = ModelConfig()
    model = cwf.ClsWiseFormer(cfg, torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == 16_824_556
    sd = model.state_dict()
    assert sorted(sd) == sorted(reference_state_dict_names())
    np.testing.assert_array_equal(sd["fusion_label_pos.pe"].numpy(),
                                  _pe_buffer())


@pytest.mark.parametrize("pe_type", ["sinusoidal", "learned"])
def test_other_positional_encodings_match_jax(pe_type):
    from dctseg.models.positional import PositionalEncoding as JaxPE
    from dctseg_torch.models.positional import PositionalEncoding
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    jpe = JaxPE(pe_type, 16)
    jparams = jpe.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if pe_type == "learned":
        table = rng.normal(size=(1, 4096, 16)).astype(np.float32)
        jparams = {"params": {"pos_embedding": jnp.asarray(table)}}
    want = jpe.apply(jparams, jnp.asarray(x))
    pe = PositionalEncoding(pe_type, 16)
    if pe_type == "learned":
        pe.pos_embedding.data = torch.from_numpy(table)
    with torch.no_grad():
        got = pe(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got,
                               np.asarray(want), rtol=0, atol=0)


def test_unported_settings_raise():
    """Every setting is ported now (s2d, remat, the training forward, int8
    quantization); a misspelt one raises at config time."""
    assert tiny_model_config(quantize="int8+pw").quantize == "int8+pw"
    with pytest.raises(ValueError, match="unknown quantize spec"):
        tiny_model_config(quantize="int4")
    with pytest.raises(ValueError, match="remat_policy"):
        tiny_model_config(remat=True, remat_policy="none")
    cfg = tiny_model_config(s2d_fullres=True, s2d_halfres=True, remat=True,
                            remat_policy="save_convs")
    model = build_model(cfg, device="cpu")
    seg = model(torch.zeros(1, 32, 32, 32, 4), train=True)[0]
    assert seg.shape == (1, 32, 32, 32, 4) and seg.requires_grad


def test_slice_defaults():
    """The serving defaults; DataConfig and TrainConfig carry the JAX
    package's fields and defaults (the multi-device ones too)."""
    from dctseg import config as jax_config
    from dctseg_torch import config as port_config
    cfg = ModelConfig()
    assert (cfg.fused_norms, cfg.use_pallas_attention, cfg.s2d_fullres,
            cfg.s2d_halfres, cfg.quantize, cfg.compute_dtype) == (
        True, True, False, False, "none", "bfloat16")
    assert dataclasses.asdict(cfg).keys() == {
        f.name for f in dataclasses.fields(jax_tiny_config())}
    for name in ("DataConfig", "TrainConfig"):
        want = dataclasses.asdict(getattr(jax_config, name)())
        got = dataclasses.asdict(getattr(port_config, name)())
        assert got == want
