"""Swin UNETR in the port (``dctseg_torch/models/swin_unetr.py``) on the CPU,
held to the plain float32 reference (``tests/swin_unetr_reference.py``,
MONAI's forward), and the pieces it brought: K8's plain version
(``ops/attention.py`` ``fused_window_attention``), K1's pre-activation
residual route (``ops/fusednorm.py`` ``fused_norm_residual_act``), the
bias-free convs, BRATS21's region rule and the engine on a region head.

At 32^3 the four stages run on 16^3 (padded to 21^3, shifted), 8^3 (padded
to 14^3, shifted), 4^3 and 2^3 (each window clamped to the stage, no
shift).
"""

import os
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from dctseg_torch.cli import evaluate
from dctseg_torch.infer import validate
from dctseg_torch.infer.engine import Predictor
from dctseg_torch.models import layers
from dctseg_torch.models import swin_unetr as su
from dctseg_torch.models.clswiseformer import build_model as build_cwf
from dctseg_torch.config import ModelConfig
from dctseg_torch.convert import state_dict_names
from dctseg_torch.ops import attention, fusednorm
from dctseg_torch.utils.profiling import count_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
import swin_unetr_reference as ref  # noqa: E402

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

TINY = dict(feature_size=24, depths=[2, 2, 2, 2], num_heads=[3, 6, 12, 24],
            window_size=7, in_channels=4, out_channels=3, norm_eps=1e-5)


def tiny_model(**kw):
    cfg = su.SwinUNETRConfig(feature_size=TINY["feature_size"],
                             compute_dtype="float32", **kw)
    return su.build_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(7))


@pytest.fixture(scope="module")
def tiny():
    """The tiny model, its weights, a 32^3 batch of 2 and the reference's
    output on it."""
    model = tiny_model()
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.randn(2, 32, 32, 32, 4, generator=torch.Generator()
                    .manual_seed(8))
    with torch.no_grad():
        want = ref.SwinUNETRRef(TINY, weights).forward(x)[0]
    return model, weights, x, want


@pytest.mark.parametrize("kernels", [True, False], ids=["ops", "plain"])
def test_port_matches_the_reference(tiny, kernels):
    """The port in float32 against MONAI's forward on the same weights: K1
    and K8 (on the CPU their plain versions), or the plain norms and
    attention."""
    model, weights, x, want = tiny
    if not kernels:
        model = tiny_model(fused_norms=False, window_kernel=False)
        model.load_state_dict(weights, strict=True)
    with torch.no_grad():
        got = model(x)[0]
    assert got.shape == (2, 32, 32, 32, 3) and got.dtype == torch.float32
    assert (got - want).abs().max() < 1e-5


def test_published_widths_and_names():
    """62,191,941 parameters at the published widths, in MONAI's tree."""
    model = su.SwinUNETR(su.SwinUNETRConfig())
    assert count_params(model) == 62_191_941
    names = list(model.state_dict())
    assert names[:5] == ["swinViT.patch_embed.proj.weight",
                         "swinViT.patch_embed.proj.bias",
                         "swinViT.layers1.0.blocks.0.norm1.weight",
                         "swinViT.layers1.0.blocks.0.norm1.bias",
                         "swinViT.layers1.0.blocks.0.attn."
                         "relative_position_bias_table"]
    for name in ("swinViT.layers4.0.downsample.reduction.weight",
                 "encoder1.layer.conv3.conv.weight",
                 "decoder5.transp_conv.conv.weight",
                 "decoder1.conv_block.conv2.conv.weight",
                 "out.conv.conv.weight", "out.conv.conv.bias"):
        assert name in names
    # MONAI's block convs and transposed convs carry no bias
    assert "encoder1.layer.conv1.conv.bias" not in names
    assert "decoder5.transp_conv.conv.bias" not in names
    assert model.swinViT.layers1[0].blocks[0].attn \
        .relative_position_bias_table.shape == (13 ** 3, 3)


def _bias_and_mask(table, ids, n, ws):
    """The gathered bias (H, N, N) and compute_mask's mask for ``ids``."""
    index = ref.relative_position_index(ws)[:n, :n].reshape(-1)
    bias = table[index].reshape(n, n, -1).permute(2, 0, 1)
    return bias


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("n", [343, 64])
def test_window_attention_plain(shifted, n):
    """K8's plain version against an einsum with the gathered bias and
    MONAI's mask, on strided views of one projection; n = 64 takes the
    first 64 tokens of the 7^3 index (a window clamped to 4^3)."""
    g = torch.Generator().manual_seed(3)
    side = 14 if n == 343 else 8
    window = (7,) * 3 if n == 343 else (4,) * 3
    nw = (side // window[0]) ** 3
    b, h, d = 2, 3, 16
    qkv = torch.randn(b * nw, n, 3, h, d, generator=g)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    table = torch.randn(13 ** 3, h, generator=g) * 0.02
    shift = tuple(w // 2 for w in window)
    ids = su.region_ids((side,) * 3, window, shift, "cpu") if shifted \
        else None
    got = attention.fused_window_attention(q, k, v, table, ids, 0.25, 7)
    s = torch.einsum("bhnd,bhmd->bhnm", q * 0.25, k)
    s = s + _bias_and_mask(table, ids, n, 7)[None]
    if shifted:
        mask = ref.compute_mask((side,) * 3, window, shift, "cpu")
        s = (s.view(b, nw, h, n, n) + mask[None, :, None]).view(-1, h, n, n)
    want = torch.einsum("bhnm,bhmd->bnhd", torch.softmax(s, -1), v)
    assert got.shape == (b * nw, n, h, d) and got.is_contiguous()
    assert (got - want).abs().max() < 1e-5


def test_region_ids_give_monai_mask():
    """Tokens' region ids of one window differ exactly where MONAI's
    compute_mask puts -100, at the stages' padded grids."""
    for side, window, shift in ((35, (7,) * 3, (3,) * 3),
                                (21, (7,) * 3, (3,) * 3),
                                (4, (4,) * 3, (0,) * 3)):
        ids = su.region_ids((side,) * 3, window, shift, "cpu").long()
        mask = ref.compute_mask((side,) * 3, window, shift, "cpu")
        assert ids.shape == mask.shape[:2]
        differ = ids[:, :, None] != ids[:, None, :]
        assert torch.equal(differ, mask != 0)


def test_relative_position_index_is_monai():
    assert torch.equal(attention.relative_position_index(7),
                       ref.relative_position_index(7))
    assert torch.equal(attention.relative_position_index(7, 64),
                       ref.relative_position_index(7)[:64, :64])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_residual_route_plain(dtype):
    """K1's pre-activation residual route: lrelu(IN(x) + r) in f32, cast
    once (bf16: equal to the f32 composition cast, to its last bit); the
    existing route adds r after the activation and the cast."""
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(2, 6, 6, 6, 16, generator=g) * 3 + 1).to(dtype)
    r = torch.randn(2, 6, 6, 6, 16, generator=g).to(dtype)
    got = fusednorm.fused_norm_residual_act(x, r, 16, act="lrelu")
    norm = fusednorm.fused_instance_norm_act_plain(x.float(), 16)
    want = F.leaky_relu(norm + r.float(), 0.01).to(dtype)
    if dtype == torch.float32:
        assert (got - want).abs().max() < 1e-5
    else:
        assert (got.float() - want.float()).abs().max() <= \
            2.0 ** -7 * want.float().abs().max()
    after = fusednorm.fused_instance_norm_act(x, 16, act="lrelu", residual=r)
    assert not torch.equal(after, got)
    with pytest.raises(ValueError):
        fusednorm.fused_norm_residual_act(x, None, 16)


def test_region_rule_overwrite_order():
    """BRATS21 test.py: WT -> 2, then TC -> 1, then ET -> 3 (BraTS 4), each
    overwriting the last; 0.5 itself is off."""
    probs = torch.tensor([[0.1, 0.1, 0.1],     # background
                          [0.1, 0.9, 0.1],     # WT only: edema
                          [0.9, 0.9, 0.1],     # TC in WT: 1
                          [0.9, 0.1, 0.1],     # TC without WT: 1
                          [0.9, 0.9, 0.9],     # ET over all: 3
                          [0.1, 0.1, 0.9],     # ET alone: 3
                          [0.5, 0.5, 0.5],     # at the threshold: 0
                          [0.1, 0.51, 0.49]])
    assert su.region_labels(probs).tolist() == [0, 2, 1, 1, 3, 3, 0, 2]
    assert validate.labels_of(probs, "regions").tolist() == \
        [0, 2, 1, 1, 3, 3, 0, 2]
    soft = torch.tensor([[0.1, 0.2, 0.6, 0.1]])
    assert validate.labels_of(soft).tolist() == [2]


def test_patch_merging_legacy_order():
    """MONAI's legacy order: neighbours (0,0,0), (1,0,0), (0,1,0), (0,0,1),
    (1,0,1), (0,1,0), (0,0,1), (1,1,1) of each 2x2x2 cell."""
    d = torch.arange(4.0)
    x = (100 * d[:, None, None] + 10 * d[None, :, None]
         + d[None, None, :])[None, ..., None]
    got = su.PatchMerging.gather(x)[0, 0, 0, 0]
    order = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1),
             (0, 1, 0), (0, 0, 1), (1, 1, 1)]
    assert got.tolist() == [100.0 * a + 10 * b + c for a, b, c in order]


def test_convs_without_bias():
    """bias=False: no bias parameter, the conv without one; the default
    keeps a zero-initialised bias."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 6, 6, 6, 4, generator=g)
    conv = layers.Conv3d(4, 8, 3, bias=False, generator=g)
    assert conv.bias is None and "bias" not in conv.state_dict()
    want = F.conv3d(x.permute(0, 4, 1, 2, 3), conv.weight, None, 1, 1)
    assert torch.allclose(conv(x), want.permute(0, 2, 3, 4, 1), atol=1e-6)
    assert conv.prepare("float")[1] is None
    up = layers.ConvTranspose3d(4, 8, bias=False, generator=g)
    assert up.bias is None and up.prepare("float")[1] is None
    want = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), up.weight, None, 2)
    assert torch.allclose(up(x), want.permute(0, 2, 3, 4, 1), atol=1e-6)
    with_bias = layers.Conv3d(4, 8, 3, generator=g)
    assert with_bias.bias is not None and not with_bias.bias.any()
    assert isinstance(layers.ConvTranspose3d(4, 8).bias, torch.nn.Parameter)


def test_clswiseformer_names_and_outputs_unchanged():
    """ClsWiseFormer keeps the reference's 222 names, each conv its bias,
    and its folded forward (the convs' prepared tensors) its unfolded
    one's bits."""
    cfg = ModelConfig(img_dim=16, base_channels=4, top_num=1)
    model = build_cwf(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(9))
    assert sorted(model.state_dict()) == sorted(state_dict_names(cfg))
    assert all(m.bias is not None for m in model.modules()
               if isinstance(m, (layers.Conv3d, layers.ConvTranspose3d)))
    x = torch.randn(2, 16, 16, 16, 4, generator=torch.Generator()
                    .manual_seed(10))
    with torch.no_grad():
        plain = model(x)[0]
        with layers.folded(layers.fold(model)):
            folded = model(x)[0]
    assert torch.equal(plain, folded)


def test_tiled_probs_on_a_region_head():
    """``Predictor.tiled_probs`` (crops, the B=8 forward, the stitch) on a
    narrow model (feature size 2, one head a stage, window 2) against the
    reference's probabilities of the first and last crops where the stitch
    puts them (the last through the published stitch's 96:123 slices);
    labels by the region rule."""
    cfg = su.SwinUNETRConfig(feature_size=2, num_heads=(1, 1, 1, 1),
                             window_size=2, compute_dtype="float32")
    model = su.build_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(11))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    vol = torch.randn(1, 240, 240, 160, 4, generator=torch.Generator()
                      .manual_seed(12))
    got = Predictor(model, device="cpu").tiled_probs(vol)
    assert got.shape == (1, 240, 240, 155, 3)
    r = ref.SwinUNETRRef(dict(TINY, feature_size=2, num_heads=[1] * 4,
                              window_size=2), weights)
    crops = Predictor.crops(vol)
    with torch.no_grad():
        want = r.forward(crops[[0, 7]])[0]
    first = got[0, :128, :128, :128]
    last = got[0, 128:, 128:, 128:]
    assert (first - want[0]).abs().max() < 1e-5
    assert (last - want[1, 16:, 16:, 96:123]).abs().max() < 1e-5
    assert torch.equal(validate.labels_of(first, su.HEAD),
                       su.region_labels(want[0]))


def test_tta_refuses_a_region_head():
    model = su.SwinUNETR(su.SwinUNETRConfig(feature_size=3,
                                            compute_dtype="float32"))
    assert validate.head_of(model) == "regions"
    predictor = Predictor(model, device="cpu")
    for strategy in ("tta", "tiling_tta"):
        with pytest.raises(ValueError, match="region head"):
            validate.validate_softmax([], predictor, strategy)


def test_evaluate_builds_swin_unetr(tmp_path):
    """``--arch swin_unetr`` builds Swin UNETR (here narrowed) and scores
    its region labels on the single strategy."""
    out = evaluate.main(["--device", "cpu", "--arch", "swin_unetr",
                         "--feature-size", "3", "--strategy", "single",
                         "--img-dim", "32", "--num-samples", "1",
                         "--input-shape", "40", "40", "36", "--no-hd95",
                         "--random-params", "--fp32", "--output-dir",
                         str(tmp_path)])
    assert set(out) >= {"wt", "tc", "et"}
    with pytest.raises(ValueError, match="swin_unetr"):
        evaluate.main(["--device", "cpu", "--arch", "swin_unetr",
                       "--quantize", "int8", "--random-params"])
