"""The port's profiling module and PlainUnet against the JAX package, on the
CPU.

``count_params`` and ``clever_format`` equal the JAX package's.  ``flops_of``
equals an analytic count of every conv, transpose conv, linear, matrix
product and attention the forward runs (``_analytic`` below, written out
from the model's geometry): on the tiny ClsWiseFormer with and without the
attention kernel, on the tiny PlainUnet, and at full width at B=8 on fake
tensors, where the figure is also held term by term to ``bench.py``
``logical_flops(8)``.  PlainUnet loads converted JAX weights strictly and
matches the JAX module at 1e-4 in fp32.
"""

import os

import jax
import numpy as np
import pytest
import torch

import bench
from dctseg.models.unet import PlainUnet as JaxPlainUnet
from dctseg.utils import profiling as jax_profiling
from dctseg.utils.torch_convert import convert_state_dict

from dctseg_torch.cli import profile_model as profile_cli
from dctseg_torch.config import ModelConfig, tiny_model_config
from dctseg_torch.convert import (plain_unet_state_dict_from_jax,
                                  plain_unet_state_dict_names)
from dctseg_torch.models.clswiseformer import ClsWiseFormer
from dctseg_torch.models.unet import PlainUnet
from dctseg_torch.utils import profiling

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

DIRECT = dict(s2d_fullres=False, s2d_halfres=False)
FULL = dict(img_dim=128, base_channels=16, num_heads=8, top_num=128,
            pe_type="fixed")
FULL_PARAMS = 16_824_556


def _analytic(d: int, b0: int, batch: int, top_num: int = 0,
              cls: bool = True) -> dict:
    """Flops (2 per multiply-accumulate) of one direct-path eval forward at
    img_dim ``d``, base_channels ``b0``, by term: FlopCounterMode's rules,
    a transpose conv counted on its input grid."""
    def conv(sp, k, ci, co):        # output sp^3
        return 2 * k ** 3 * ci * co * sp ** 3 * batch

    def deconv(sp_in, c):           # k=2, s=2, from sp_in^3
        return 2 * 8 * c * c * sp_in ** 3 * batch

    e = 16 * b0                     # the bottleneck channels
    t = {"encoder": (
        conv(d, 3, 4, b0) + 4 * conv(d, 3, b0, b0)
        + conv(d // 2, 3, b0, 2 * b0) + 4 * conv(d // 2, 3, 2 * b0, 2 * b0)
        + conv(d // 4, 3, 2 * b0, 4 * b0)
        + 4 * conv(d // 4, 3, 4 * b0, 4 * b0)
        + conv(d // 8, 3, 4 * b0, 8 * b0)
        + 4 * conv(d // 8, 3, 8 * b0, 8 * b0)
        + conv(d // 8, 3, 8 * b0, 16 * b0))}
    # down_channel, Enblock8 x2, then per DeUp: 1x1, deconv, 1x1 on the
    # concat with the skip, DeBlock x2; endconv
    t["decoder"] = (
        conv(d // 8, 1, e, e // 2) + 4 * conv(d // 8, 3, e // 2, e // 2)
        + conv(d // 8, 1, e // 2, e // 4)
        + conv(d // 4, 1, 4 * b0 + e // 4, e // 4)
        + 4 * conv(d // 4, 3, e // 4, e // 4)
        + conv(d // 4, 1, e // 4, e // 8)
        + conv(d // 2, 1, 2 * b0 + e // 8, e // 8)
        + 4 * conv(d // 2, 3, e // 8, e // 8)
        + conv(d // 2, 1, e // 8, e // 16)
        + conv(d, 1, b0 + e // 16, e // 16) + 4 * conv(d, 3, e // 16, e // 16)
        + conv(d, 1, e // 16, 4))
    t["deconvs"] = (deconv(d // 8, e // 4) + deconv(d // 4, e // 8)
                    + deconv(d // 2, e // 16))
    if not cls:
        return t
    # conv_64_to_32, conv_mid_fea_* x3, conv_semantic_* x3, sum_fusion
    t["decouple"] = (conv(d // 4, 3, 2 * b0, 2 * b0)
                     + 3 * conv(d // 4, 3, 6 * b0, 2 * b0)
                     + 3 * conv(d // 8, 3, 16 * b0, 8 * b0)
                     + conv(d // 8, 3, 8 * b0, 16 * b0))
    # final and mid supervision heads, 3 regions each: semantic and edge
    t["heads"] = (6 * (conv(d // 8, 3, 8 * b0, 32) + conv(d // 8, 3, 32, 2))
                  + 6 * (conv(d // 4, 3, 2 * b0, 8) + conv(d // 4, 3, 8, 2)))

    def upsample(s, f):             # three einsums, 2 channels, s -> f*s
        return 4 * batch * f * s ** 4 * (1 + f + f * f)

    t["upsample"] = 6 * upsample(d // 8, 8) + 6 * upsample(d // 4, 4)
    p = 32 * b0                     # token_dim
    n_sem = (d // 16) ** 2 * (d // 8)
    n_edge = (d // 16) * (d // 8) ** 2
    # per region 2 routings over each token set; the fusion's over the
    # semantic tokens: one score per token
    t["routing"] = (3 * (4 * batch * n_edge * p + 4 * batch * n_sem * p)
                    + 2 * batch * n_sem * p)
    # an attention block on L tokens: q 2LP^2, kv 4LP^2, out 2LP^2,
    # attention 4L^2P; an FFN (hidden P) on M tokens 4MP^2.  Per region 4
    # blocks and an FFN on 2L tokens; the fusion 1 block and an FFN on L
    length = top_num + 1
    block = 8 * batch * length * p * p + 4 * batch * length ** 2 * p
    t["transformers"] = (3 * (4 * block + 8 * batch * length * p * p)
                         + block + 4 * batch * length * p * p)
    return t


@pytest.fixture(scope="module")
def tiny_cls():
    cfg = tiny_model_config(**DIRECT)
    model = ClsWiseFormer(cfg, torch.Generator().manual_seed(1)).eval()
    return cfg, model


def test_count_params_matches_jax(tiny_cls):
    """The port's trainable parameters equal the JAX package's count of
    the same weights' params tree (the fixed PE is a buffer on both
    sides)."""
    _, model = tiny_cls
    params = convert_state_dict({k: v.numpy()
                                 for k, v in model.state_dict().items()})
    assert (profiling.count_params(model)
            == jax_profiling.count_params(params) == 1_201_180)


@pytest.mark.parametrize("value", [
    0.0, 0.5, 999.9994, 1000.0, -1234.5, 374_452, 16_824_556, 2.5e9,
    -5e6, 4.232e12, 1e15, 999_999.9996])
def test_clever_format_matches_jax(value):
    assert (profiling.clever_format(value)
            == jax_profiling.clever_format(value))


@pytest.mark.parametrize("kernel", [True, False],
                         ids=["attention_kernel", "einsum_attention"])
def test_flops_of_tiny_clswiseformer(kernel):
    """Both attention routes count 4*B*H*N*N2*D: the operator by its
    registered formula, the einsums as two products."""
    cfg = tiny_model_config(use_pallas_attention=kernel, **DIRECT)
    model = ClsWiseFormer(cfg).eval()
    x = torch.zeros(1, 32, 32, 32, 4)
    with torch.inference_mode():
        stats = profiling.flops_of(lambda t: model(t), x)
    assert stats["flops"] == sum(_analytic(32, 4, 1, cfg.top_num).values())
    assert stats["bytes_accessed"] > x.numel() * 4


def test_flops_of_tiny_plain_unet():
    model = PlainUnet(base_channels=4, s2d=False, s2d_half=False).eval()
    x = torch.zeros(2, 32, 32, 32, 4)
    with torch.inference_mode():
        stats = profiling.flops_of(model, x)
    assert stats["flops"] == sum(_analytic(32, 4, 2, cls=False).values())


def test_bytes_accessed_counts_operands_and_results():
    """Each op's inputs and outputs, views free: a matmul reads a and b
    and writes c, the relu reads c and writes its result, and the
    transpose moves nothing."""
    a, b = torch.ones(4, 8), torch.ones(8, 16)
    stats = profiling.flops_of(lambda: torch.relu(a @ b.t().t()))
    assert stats["flops"] == 2 * 4 * 8 * 16
    assert stats["bytes_accessed"] == 4 * (32 + 128 + 64) + 4 * (64 + 64)


def test_full_width_profile_against_bench():
    """One B=8 full-width forward on fake tensors: 16,824,556 parameters and
    the analytic count, which is bench.logical_flops(8) term by term:
    logical_flops counts the encoder, decouple and decoder convs as here
    but each k=2 s=2 transpose conv on its OUTPUT grid, 8x its
    multiply-accumulates, and leaves out the supervision heads, their
    trilinear upsampling, the routing scores and the transformers."""
    model = ClsWiseFormer(ModelConfig(**FULL)).eval()
    stats = profiling.profile_model(model, torch.zeros(8, 128, 128, 128, 4))
    terms = _analytic(128, 16, 8, 128)
    assert stats["params"] == FULL_PARAMS
    assert stats["flops"] == sum(terms.values()) == 4_257_332_019_200
    logical = bench.logical_flops(8)
    assert logical == (terms["encoder"] + terms["decouple"]
                       + terms["decoder"] + 8 * terms["deconvs"])
    assert stats["flops"] == (logical - 7 * terms["deconvs"] + terms["heads"]
                              + terms["upsample"] + terms["routing"]
                              + terms["transformers"])


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.relu(torch.ones(64) - 0.5)
    path = tmp_path / "t" / profiling.TRACE_FILE
    assert path.stat().st_size > 0
    assert any(r.key == "aten::relu" for r in prof.key_averages())


@pytest.mark.parametrize("s2d", [False, True], ids=["direct", "s2d"])
def test_plain_unet_matches_jax(s2d):
    """Converted JAX weights load strictly (the port's names:
    ``plain_unet_state_dict_names``) and the fp32 forward matches JAX's
    PlainUnet at 1e-4; the port runs its fused-norm wrapper, which takes
    the plain version on the CPU."""
    seeded = PlainUnet(base_channels=4, s2d=s2d, s2d_half=s2d,
                       generator=torch.Generator().manual_seed(3))
    tree = convert_state_dict({
        ("Unet_list." + k[5:] if k.startswith("unet.") else k): v.numpy()
        for k, v in seeded.state_dict().items()})
    assert set(tree) == {"unet", "decoder"}
    model = PlainUnet(base_channels=4, init_dropout=0.0, s2d=s2d,
                      s2d_half=s2d, fused_norms=True).eval()
    assert sorted(model.state_dict()) == sorted(plain_unet_state_dict_names())
    model.load_state_dict(plain_unet_state_dict_from_jax({"params": tree}),
                          strict=True)
    x = np.random.default_rng(4).normal(size=(1, 32, 32, 32, 4)).astype(
        np.float32)
    jmodel = JaxPlainUnet(base_channels=4, init_dropout=0.0, remat=False,
                          s2d=s2d, s2d_half=s2d)
    want = jax.jit(lambda p, t: jmodel.apply(p, t, train=False))(
        {"params": tree}, x)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.shape == (1, 32, 32, 32, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert (profiling.count_params(model)
            == jax_profiling.count_params(tree) == 374_452)


@pytest.mark.parametrize("model", ["clswiseformer", "unet"])
def test_profile_driver_on_cpu(tmp_path, capsys, model):
    stats = profile_cli.main(["--device", "cpu", "--img-dim", "32",
                              "--base-channels", "4", "--model", model,
                              "--trace", str(tmp_path)])
    out = capsys.readouterr().out
    assert "FLOPS:" in out and "Self CPU time by op" in out
    assert stats["params"] == {"clswiseformer": 1_201_180,
                               "unet": 374_452}[model]
    assert (tmp_path / profiling.TRACE_FILE).exists()
