"""ClsWiseFormer: the decouple-and-couple 3D segmentation network (the JAX
package's ``dctseg/models/clswiseformer.py``): the eval forward and, with
``train=True``, the training forward with dropout.

Dataflow:
  UNet encoder -> skips + bottleneck
  edge decouple: downsample skip2, concat skip3, conv+IN+LReLU per region
  semantic decouple: conv+IN+LReLU on the bottleneck per region
  mid supervision heads
  per region {01,02,04}: patchify; 4 top-k routings against learned class
    tokens; edge-supported intra-region coupler; scatter-back + class-token
    gating; unpatchify
  final supervision heads
  mutual cross-region coupler over the summed class streams
  sum_fusion conv -> decoder -> softmax seg probs

Activations are NDHWC, as in the JAX package.

Under ``parallel.spatial.sharded`` (a space group) the forward takes the
whole volume, as every rank of the group holds it, and runs the UNet and
the decouple convs on this rank's slab of D (halo-exchanged convs, norms
with statistics reduced over the group).  It gathers the decouple features
before ``patchify``: the tokens, the top-k routing and the scatter need the
whole grid, and the couplers and supervision heads run on it, replicated.
``sum_fusion``'s output is split into slabs again for the decoder, whose
probabilities are gathered at the end.  Submodule and parameter names
are the reference's 222 state_dict keys (``dctseg_torch/convert.py``), for
every combination of the s2d flags.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from dctseg_torch.config import ModelConfig
from dctseg_torch.device import resolve_device
from dctseg_torch.models.attention import (FusionClsWiseTransformer,
                                           TwoClsWiseTransformer)
from dctseg_torch.models.layers import (NO_DROPOUT, Conv3d, Dropout,
                                        InstanceNormAct, shared_input)
from dctseg_torch.models.positional import PositionalEncoding
from dctseg_torch.models.supervise import REGIONS, SuperviseHead
from dctseg_torch.models.unet import Decoder, S2DConv3d, UnetEncoder
from dctseg_torch.ops.patchify import patchify, unpatchify
from dctseg_torch.ops.routing import scatter_update, topk_select
from dctseg_torch.parallel import spatial


class ClsWiseFormer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        g = self.geom = cfg.geometry
        dt = self.dtype = getattr(torch, cfg.compute_dtype)
        b0, eps, gen = cfg.base_channels, cfg.norm_eps, generator
        p = g["token_dim"]

        remat = cfg.remat_policy if cfg.remat else None
        unet_kw = dict(conv3=cfg.conv3_strategy, remat=remat,
                       quantize=cfg.quantize)
        self.Unet_list = UnetEncoder(cfg.in_channels, b0, dt, eps,
                                     cfg.fused_norms, gen, cfg.s2d_fullres,
                                     cfg.s2d_halfres,
                                     init_dropout=cfg.init_conv_dropout,
                                     **unet_kw)
        # edge decouple; with s2d_halfres the half-res skip arrives in the
        # s2d view, and the stride-2 conv runs there (same parameters)
        self.conv_64_to_32 = (S2DConv3d if cfg.s2d_halfres else Conv3d)(
            2 * b0, 2 * b0, stride=2, dtype=dt, generator=gen)
        for r in REGIONS:
            i = r[1]
            self.add_module(f"conv_mid_fea_{i}", Conv3d(
                6 * b0, g["edge_ch"], dtype=dt, generator=gen,
                quantize=cfg.quantize))
            self.add_module(f"conv_semantic_{i}", Conv3d(
                g["bottleneck_ch"], g["sem_ch"], dtype=dt, generator=gen,
                quantize=cfg.quantize))
        self.act = InstanceNormAct(eps=eps)

        for r in REGIONS:
            for kind in ("e", "s"):
                t = nn.Parameter(torch.empty(1, 1, p))
                with torch.no_grad():
                    nn.init.trunc_normal_(t, std=0.02, a=-2.0, b=2.0,
                                          generator=gen)
                self.register_parameter(f"{kind}_token_{r}", t)
            self.add_module(f"label_{r}_position_encoding",
                            PositionalEncoding(cfg.pe_type, p))
            self.add_module(f"transformer_{r}", TwoClsWiseTransformer(
                p, cfg.num_heads, dt, cfg.use_pallas_attention, gen,
                cfg.dropout_rate, cfg.attn_dropout_rate))
        self.fusion_label_pos = PositionalEncoding(cfg.pe_type, p)
        self.fusion_transformer_1_2_4 = FusionClsWiseTransformer(
            p, cfg.num_heads, dt, cfg.use_pallas_attention, gen,
            cfg.dropout_rate, cfg.attn_dropout_rate)

        sem, edge = g["sem_ch"], g["edge_ch"]
        self.supervise_label = SuperviseHead(sem, 32, 8, False, dt, gen)
        self.edge_supervise_label = SuperviseHead(edge, 8, 4, True, dt, gen)
        self.mid_supervise_label = SuperviseHead(sem, 32, 8, False, dt, gen)
        self.mid_edge_supervise_label = SuperviseHead(edge, 8, 4, True, dt,
                                                      gen)
        self.sum_fusion = Conv3d(sem, g["bottleneck_ch"], dtype=dt,
                                 generator=gen, quantize=cfg.quantize)
        self.decoder = Decoder(g["bottleneck_ch"], cfg.num_classes, b0, dt,
                               eps, cfg.fused_norms, gen, cfg.s2d_fullres,
                               cfg.s2d_halfres, **unet_kw)

    def _route(self, tokens, query, class_token, pe, drop):
        """One routing: top-k select against ``query``, PE, dropout, prepend
        ``class_token``."""
        selected, idx = topk_select(tokens, query, self.cfg.top_num)
        selected = drop(pe(selected), self.cfg.dropout_rate)
        ct = class_token.to(selected.dtype).expand(tokens.shape[0], 1, -1)
        return torch.cat([ct, selected], dim=1), idx

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None
                ) -> Tuple[torch.Tensor, Dict, Dict, Dict, Dict]:
        """x (B, D, H, W, in_channels) -> the reference's 5-tuple: softmax
        seg probs (B, D, H, W, num_classes) and four {'01','02','04'} dicts
        of 2-class prob maps (final semantic, final edge, mid semantic, mid
        edge), all NDHWC, f32.  ``train`` turns dropout on, with masks drawn
        from ``generator`` (on x's device)."""
        cfg, d = self.cfg, self.cfg.img_dim
        if tuple(x.shape[1:]) != (d, d, d, cfg.in_channels):
            raise ValueError(
                f"ClsWiseFormer(img_dim={d}) expects input (B, {d}, {d}, "
                f"{d}, {cfg.in_channels}); got {tuple(x.shape)}")
        shard = spatial.active()
        if shard is not None and d % (8 * shard.size):
            raise ValueError(
                f"img_dim {d} does not cut into {shard.size} D slabs that "
                f"are multiples of the UNet's total stride 8")
        drop = Dropout(generator) if train else NO_DROPOUT
        x = spatial.split(x, shard)
        if not cfg.s2d_fullres:
            # on the s2d path the relayout kernel does the cast
            x = x.to(self.dtype)
        skips, edge_fea, sem_fea = self._encode(x, drop)
        # the whole grid from here to sum_fusion, replicated over the group
        with spatial.sharded(None):
            (final_sup, final_edge_sup, mid_sup, mid_edge_sup,
             fused) = self._couple(
                {r: spatial.gather(v, shard) for r, v in edge_fea.items()},
                {r: spatial.gather(v, shard) for r, v in sem_fea.items()},
                drop)
        seg = self.decoder(*skips, spatial.split(fused, shard))
        return (spatial.gather(seg, shard), final_sup, final_edge_sup,
                mid_sup, mid_edge_sup)

    def _encode(self, x, drop):
        """The UNet encoder and the decouple convs: the skips, and the edge
        and semantic features per region."""
        x1_1, x2_1, x3_1, bottleneck = self.Unet_list(x, drop)

        # ---- decouple ----
        x_2_3 = torch.cat([self.conv_64_to_32(x2_1), x3_1], dim=-1)
        # the three regions' convs of each kind read one input: int8, they
        # share its quantization
        edge_fea = dict(zip(REGIONS, map(self.act, shared_input(
            [getattr(self, f"conv_mid_fea_{r[1]}") for r in REGIONS],
            x_2_3))))
        sem_fea = dict(zip(REGIONS, map(self.act, shared_input(
            [getattr(self, f"conv_semantic_{r[1]}") for r in REGIONS],
            bottleneck))))
        return (x1_1, x2_1, x3_1), edge_fea, sem_fea

    def _couple(self, edge_fea, sem_fea, drop):
        """The couplers and the supervision heads on the whole grid:
        (final_sup, final_edge_sup, mid_sup, mid_edge_sup, sum_fusion's
        output)."""
        g, k = self.geom, self.cfg.top_num
        mid_sup = self.mid_supervise_label(*[sem_fea[r] for r in REGIONS])
        mid_edge_sup = self.mid_edge_supervise_label(
            *[edge_fea[r] for r in REGIONS])

        # ---- per-class intra-region coupling ----
        sem_grids, sem_class_tokens, sup_sem, sup_edge = {}, {}, {}, {}
        for r in REGIONS:
            edge_tokens = patchify(edge_fea[r], g["edge_patch"])
            sem_tokens = patchify(sem_fea[r], g["sem_patch"])
            e_tok = getattr(self, f"e_token_{r}")
            s_tok = getattr(self, f"s_token_{r}")
            pe = getattr(self, f"label_{r}_position_encoding")

            edge_seq, idx_edge = self._route(edge_tokens, e_tok, e_tok, pe,
                                             drop)
            se_supple, _ = self._route(sem_tokens, e_tok, s_tok, pe, drop)
            sem_seq, idx_sem = self._route(sem_tokens, s_tok, s_tok, pe, drop)
            edge_supple, _ = self._route(edge_tokens, s_tok, e_tok, pe, drop)

            result = getattr(self, f"transformer_{r}")(
                edge_seq, se_supple, sem_seq, edge_supple, drop)
            # result (B, 2(k+1), P): edge stream, then semantic stream
            edge_grid = scatter_update(edge_tokens, idx_edge,
                                       result[:, 1:k + 1])
            sem_grid = scatter_update(sem_tokens, idx_sem,
                                      result[:, k + 2:2 * (k + 1)])
            sem_token_out = result[:, k + 1:k + 2]
            # class-token gating
            sup_edge[r] = unpatchify(result[:, 0:1] * edge_grid, g["edge_ch"],
                                     (g["edge_size"],) * 3, g["edge_patch"])
            sup_sem[r] = unpatchify(sem_token_out * sem_grid, g["sem_ch"],
                                    (g["sem_size"],) * 3, g["sem_patch"])
            # the fusion consumes the scattered but ungated semantic grid
            sem_grids[r] = sem_grid
            sem_class_tokens[r] = sem_token_out

        final_sup = self.supervise_label(*[sup_sem[r] for r in REGIONS])
        final_edge_sup = self.edge_supervise_label(
            *[sup_edge[r] for r in REGIONS])

        # ---- mutual cross-region coupling ----
        fusion_token = sum(sem_class_tokens[r] for r in REGIONS)
        fusion_feature = sum(sem_grids[r] for r in REGIONS)
        selected, fusion_idx = topk_select(fusion_feature, fusion_token, k)
        selected = drop(self.fusion_label_pos(selected),
                        self.cfg.dropout_rate)
        result = self.fusion_transformer_1_2_4(
            torch.cat([fusion_token, selected], dim=1), drop)
        fused = scatter_update(fusion_feature, fusion_idx, result[:, 1:k + 1])
        fused = result[:, 0:1] * fused
        enc = unpatchify(fused, g["sem_ch"], (g["sem_size"],) * 3,
                         g["sem_patch"])
        return (final_sup, final_edge_sup, mid_sup, mid_edge_sup,
                self.sum_fusion(enc))


def build_model(cfg: ModelConfig | None = None, device=None,
                generator: torch.Generator | None = None) -> ClsWiseFormer:
    """ClsWiseFormer in eval mode on ``device`` (default: the GPU; raises
    if there is none unless ``device='cpu'``).  Weights are drawn on the CPU
    from ``generator`` (torch's default generator if None)."""
    dev = resolve_device(device)
    model = ClsWiseFormer(cfg or ModelConfig(), generator)
    return model.to(dev).eval()
