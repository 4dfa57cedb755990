"""Weight bridge: the JAX package's flax params -> the port's state_dict.

The port's modules carry the reference's 222 state_dict names, so
``state_dict_from_jax`` output and a reference-format ``.pth`` both load
with ``load_state_dict(strict=True)``.  Layout rules (the inverse of the
JAX package's converter, kept here as a copy):

  conv kernel            (k, k, k, I, O) -> (O, I, k, k, k)
  transpose-conv kernel  (k, k, k, I, O) -> (I, O, k, k, k), spatially
                         flipped (flax cross-correlates the dilated input)
  dense kernel           (I, O)          -> (O, I)
  LayerNorm scale / bias                 -> weight / bias

The four positional-encoding buffers (``label_0X_position_encoding.pe``,
``fusion_label_pos.pe``) are constants: they are rebuilt from the config
as (1024, 1, token_dim) sinusoid tables -- the reference's (1024, 1, 512)
at full width.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from dctseg_torch.config import ModelConfig
from dctseg_torch.models.positional import reference_pe_buffer

_UNET = {
    "InitConv.conv": "init_conv",
    "EnBlock1": "en1_a", "EnBlock1_1": "en1_b",
    "EnBlock2_1": "en2_a", "EnBlock2_2": "en2_b",
    "EnBlock3_1": "en3_a", "EnBlock3_2": "en3_b",
    "EnBlock4_1": "en4_a", "EnBlock4_2": "en4_b",
    "EnDown1.conv": "down1", "EnDown2.conv": "down2",
    "EnDown3.conv": "down3", "EnDown_4.conv": "widen",
}
_DECODER = {
    "down_channel": "down_channel", "endconv": "endconv",
    "Enblock8_1": "enblock8_1", "Enblock8_2": "enblock8_2",
    "DeUp4": "deup4", "DeUp3": "deup3", "DeUp2": "deup2",
    "DeBlock4": "deblock4", "DeBlock4_1": "deblock4_1",
    "DeBlock3": "deblock3", "DeBlock3_1": "deblock3_1",
    "DeBlock2": "deblock2", "DeBlock2_1": "deblock2_1",
}
_FFN = {"fn.net.0": "fc1", "fn.net.3": "fc2"}


def state_dict_names(cfg: ModelConfig) -> List[str]:
    """The port's state_dict keys: the reference's 222 names with
    pe_type 'fixed' or 'sinusoidal'; with 'learned', the four ``.pe``
    buffers become ``.pos_embedding`` parameters."""
    pe_leaf = "pos_embedding" if cfg.pe_type == "learned" else "pe"
    names = []
    for r in ("01", "02", "04"):
        names += [f"e_token_{r}", f"s_token_{r}",
                  f"label_{r}_position_encoding.{pe_leaf}"]
    names.append(f"fusion_label_pos.{pe_leaf}")
    for t in ("transformer_01", "transformer_02", "transformer_04",
              "fusion_transformer_1_2_4"):
        a = f"{t}.cross_attention_list.0.fn"
        names += [f"{a}.norm.weight", f"{a}.norm.bias",
                  f"{a}.norm2.weight", f"{a}.norm2.bias",
                  f"{a}.fn.qkv.weight", f"{a}.fn.out_proj.weight",
                  f"{a}.fn.out_proj.bias"]
        f_ = f"{t}.cross_ffn_list.0.fn"
        names += [f"{f_}.norm.weight", f"{f_}.norm.bias",
                  f"{f_}.fn.net.0.weight", f"{f_}.fn.net.0.bias",
                  f"{f_}.fn.net.3.weight", f"{f_}.fn.net.3.bias"]

    def conv(n):
        names.extend([f"{n}.weight", f"{n}.bias"])

    conv("Unet_list.InitConv.conv")
    for blk in ("EnBlock1", "EnBlock1_1", "EnBlock2_1", "EnBlock2_2",
                "EnBlock3_1", "EnBlock3_2", "EnBlock4_1", "EnBlock4_2"):
        conv(f"Unet_list.{blk}.conv1")
        conv(f"Unet_list.{blk}.conv2")
    for d in ("EnDown1", "EnDown2", "EnDown3", "EnDown_4"):
        conv(f"Unet_list.{d}.conv")
    for i in (1, 2, 4):
        conv(f"conv_semantic_{i}")
        conv(f"conv_mid_fea_{i}")
    conv("conv_64_to_32")
    conv("sum_fusion")
    conv("decoder.down_channel")
    for blk in ("Enblock8_1", "Enblock8_2", "DeBlock4", "DeBlock4_1",
                "DeBlock3", "DeBlock3_1", "DeBlock2", "DeBlock2_1"):
        conv(f"decoder.{blk}.conv1")
        conv(f"decoder.{blk}.conv2")
    for up in ("DeUp4", "DeUp3", "DeUp2"):
        for c in ("conv1", "conv2", "conv3"):
            conv(f"decoder.{up}.{c}")
    conv("decoder.endconv")
    for head in ("supervise_label", "mid_supervise_label"):
        for i in (1, 2, 4):
            conv(f"{head}.supervise_label_{i}")
            conv(f"{head}.down_label_{i}")
    for head in ("edge_supervise_label", "mid_edge_supervise_label"):
        for i in (1, 2, 4):
            conv(f"{head}.edge_supervise_label_{i}")
            conv(f"{head}.edge_down_label_{i}")
    return names


def _jax_path(name: str) -> Tuple[tuple, str]:
    """Port state_dict key -> (flax params path, layout rule)."""
    leaf = "kernel" if name.endswith("weight") else "bias"
    if re.fullmatch(r"[es]_token_0[124]", name):
        return (name,), "id"
    m = re.fullmatch(r"(?:label_(0[124])_position_encoding|fusion_label_pos)"
                     r"\.pos_embedding", name)
    if m:
        return (f"pe_{m.group(1) or 'fusion'}", "pos_embedding"), "id"
    m = re.fullmatch(
        r"(transformer_0[124]|fusion_transformer_1_2_4)\."
        r"(cross_attention_list|cross_ffn_list)\.0\.fn\.(.+)\.(weight|bias)",
        name)
    if m:
        mod = ("fusion_transformer" if m.group(1).startswith("fusion")
               else m.group(1))
        block = "cross" if m.group(2) == "cross_attention_list" else "ffn"
        inner, is_w = m.group(3), m.group(4) == "weight"
        if inner in ("norm", "norm2"):
            return (mod, block, inner, "scale" if is_w else "bias"), "id"
        rule = "dense" if is_w else "id"
        if inner in ("fn.qkv", "fn.out_proj"):
            return (mod, block, "attn", inner[3:], "Dense_0", leaf), rule
        return (mod, block, "ffn", _FFN[inner], "Dense_0", leaf), rule
    rule = "conv" if leaf == "kernel" else "id"
    m = re.fullmatch(r"Unet_list\.(.+)\.(weight|bias)", name)
    if m:
        inner = m.group(1)
        if inner in _UNET:
            return ("unet", _UNET[inner], "Conv_0", leaf), rule
        blk, conv = inner.rsplit(".", 1)
        return ("unet", _UNET[blk], conv, "Conv_0", leaf), rule
    m = re.fullmatch(r"decoder\.(.+?)(?:\.(conv\d))?\.(weight|bias)", name)
    if m:
        blk, conv = _DECODER[m.group(1)], m.group(2)
        if conv == "conv2" and blk.startswith("deup"):
            return (("decoder", blk, "up", "ConvTranspose_0", leaf),
                    "deconv" if leaf == "kernel" else "id")
        if conv is None:
            return ("decoder", blk, "Conv_0", leaf), rule
        return ("decoder", blk, conv, "Conv_0", leaf), rule
    m = re.fullmatch(r"((?:mid_)?(?:edge_)?supervise_label)\.(?:edge_)?"
                     r"(supervise|down)_label_(\d)\.(weight|bias)", name)
    if m:
        return (m.group(1), f"{m.group(2)}_0{m.group(3)}", "Conv_0",
                leaf), rule
    m = re.fullmatch(r"(conv_semantic|conv_mid_fea)_(\d)\.(weight|bias)",
                     name)
    if m:
        return (f"{m.group(1)}_0{m.group(2)}", "Conv_0", leaf), rule
    m = re.fullmatch(r"(conv_64_to_32|sum_fusion)\.(weight|bias)", name)
    if m:
        return (m.group(1), "Conv_0", leaf), rule
    raise KeyError(f"no flax path for state_dict entry {name}")


def _to_torch_layout(w: np.ndarray, rule: str) -> np.ndarray:
    if rule == "conv":
        return np.transpose(w, (4, 3, 0, 1, 2))
    if rule == "deconv":
        return np.transpose(w, (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1]
    if rule == "dense":
        return np.transpose(w, (1, 0))
    return w


def pe_buffer(cfg: ModelConfig) -> np.ndarray:
    """The (1024, 1, token_dim) sinusoid table of the reference's
    ExtendFixedPositionalEncoding."""
    return reference_pe_buffer(cfg.geometry["token_dim"])


def state_dict_from_jax(params: dict, cfg: ModelConfig
                        ) -> Dict[str, torch.Tensor]:
    """flax params tree (numpy or array-like leaves, with or without the
    top-level 'params' key) -> the port's state_dict (f32 CPU tensors)."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for name in state_dict_names(cfg):
        if name.endswith(".pe"):
            w = pe_buffer(cfg)
        else:
            path, rule = _jax_path(name)
            node = tree
            for p in path:
                node = node[p]
            w = _to_torch_layout(np.asarray(node, np.float32), rule)
        out[name] = torch.from_numpy(np.array(w, np.float32, order="C"))
    return out


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a reference-format ``.pth`` ({'state_dict': ...}, DDP
    ``module.`` prefixes allowed) into the port's model, strictly."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
