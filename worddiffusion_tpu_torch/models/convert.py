"""Flax parameter trees -> the port's state dicts.

The UNet needs no loader here: its parameter names are the reference
torch keys, so ``worddiffusion_tpu.models.convert.export_reference_unet``
(jax-free, numpy only) already emits a state dict that
``UNet.load_state_dict(strict=True)`` takes, but for the parameters that
exporter leaves out (the CTC aux head and the glyph encoder), which
``jax_unet_extras_to_torch`` maps. This module adds the VAE
(diffusers key names; the inverse of
``worddiffusion_tpu.models.vae.convert_diffusers_vae``) and the OCR
recognizer, the HiGAN+ denoiser, and the PHOSC recognizer, the character counter and the
writer-style encoder in both directions (their CLIs read and write the JAX
CLIs' pickles). Each
function from flax takes a nested dict of numpy arrays and returns
``{key: np.ndarray}``; wrap the values with ``torch.from_numpy`` or pass
the dict to ``state_dict_to_torch``.

Layout transforms: conv HWIO -> OIHW, 1-D conv [k, in, out] ->
[out, in, k], Dense [in, out] -> Linear [out, in], norm ``scale`` ->
``weight``.

A tensor-parallel UNet (``UNet(cfg, mesh)``) takes the full state dict
these give, cut for its rank: ``parallel.tensor.shard_state_dict``.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Mapping

import numpy as np
import torch

from ..configs.config import VAEConfig


def _t(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32))


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def state_dict_to_torch(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _conv(node, key, out):
    out[key + ".weight"] = _t(np.transpose(node["kernel"], (3, 2, 0, 1)))
    out[key + ".bias"] = _t(node["bias"])


def _linear(node, key, out):
    out[key + ".weight"] = _t(np.asarray(node["kernel"]).T)
    out[key + ".bias"] = _t(node["bias"])


def _norm(node, key, out):
    out[key + ".weight"] = _t(node["scale"])
    out[key + ".bias"] = _t(node["bias"])


def jax_unet_extras_to_torch(params: Mapping, cfg) -> dict[str, np.ndarray]:
    """The Flax UNet's parameters that ``export_reference_unet`` does not
    export -> the port's keys: the CTC aux head (``aux_head`` ->
    ``auxhead.*``, its GroupNorms ``temporal_*_gn`` -> ``.1``) with
    ``ocr_head``, the glyph encoder (``glyph_conv1``, ``glyph_conv2``,
    ``glyph_proj``) with ``use_char_images``. Merged with the exporter's
    dict, the port's UNet loads it with ``strict=True``."""
    p = _params(params)
    out: dict[str, np.ndarray] = {}
    if cfg.ocr_head:
        head = p["aux_head"]
        names = ["temporal_i"] + [f"temporal_m{i}" for i in range(cfg.ocr_layers)]
        keys = ["auxhead.temporal_i"] + [f"auxhead.temporal_m.{i}" for i in range(cfg.ocr_layers)]
        for name, key in zip(names, keys):
            _conv(head[name]["Conv_0"], key + ".0", out)
            if cfg.ocr_norm == "group":
                _norm(head[name + "_gn"], key + ".1", out)
        _conv(head["temporal_o"]["Conv_0"], "auxhead.temporal_o", out)
        for lin in ("lin1", "lin2"):
            _linear(head[lin]["Dense_0"], "auxhead." + lin, out)
    if cfg.use_char_images:
        for conv in ("glyph_conv1", "glyph_conv2"):
            _conv(p[conv]["Conv_0"], conv, out)
        _linear(p["glyph_proj"]["Dense_0"], "glyph_proj", out)
    return out


def jax_higan_to_torch(params: Mapping) -> dict[str, np.ndarray]:
    """Flax ``HiGanDenoiserAdapter`` params -> the port's
    ``models.higan.HiGanDenoiserAdapter`` keys (``block_{i}`` ->
    ``blocks.{i}``; the text encoder's keys as the UNet's ``word_emb``)."""
    g = _params(params)["generator"]
    out: dict[str, np.ndarray] = {}
    pre = "generator."
    _linear(g["t_proj"]["Dense_0"], pre + "t_proj", out)
    out[pre + "writer_emb.weight"] = _t(g["writer_emb"]["embedding"])
    enc = g["text_enc"]
    out[pre + "text_enc.embedding.weight"] = _t(enc["embedding"]["embedding"])
    for lin in ("linear_query", "linear_key", "linear_value"):
        _linear(enc["attention"][lin]["Dense_0"], f"{pre}text_enc.attention.{lin}", out)
    for conv in ("conv_in", "conv_out"):
        _conv(g[conv]["Conv_0"], pre + conv, out)
    _norm(g["out_norm"], pre + "out_norm", out)
    blocks = sorted((k for k in g if k.startswith("block_")), key=lambda k: int(k[6:]))
    for i, name in enumerate(blocks):
        node, key = g[name], f"{pre}blocks.{i}."
        for sub in ("cgn1", "cgn2"):
            _norm(node[sub], key + sub, out)
            _linear(node[sub + "_proj"]["Dense_0"], key + sub + "_proj", out)
        for conv in ("conv1", "conv2"):
            _conv(node[conv]["Conv_0"], key + conv, out)
    return out


def _vae_key(part: str, name: str, n_levels: int) -> str:
    """Flax module name -> diffusers prefix (up blocks count from the
    deepest level)."""
    if m := re.fullmatch(r"down_(\d+)_res_(\d+)", name):
        return f"{part}.down_blocks.{m[1]}.resnets.{m[2]}"
    if m := re.fullmatch(r"down_(\d+)_downsample", name):
        return f"{part}.down_blocks.{m[1]}.downsamplers.0.conv"
    if m := re.fullmatch(r"up_(\d+)_res_(\d+)", name):
        return f"{part}.up_blocks.{n_levels - 1 - int(m[1])}.resnets.{m[2]}"
    if m := re.fullmatch(r"up_(\d+)_upsample", name):
        return f"{part}.up_blocks.{n_levels - 1 - int(m[1])}.upsamplers.0.conv"
    if m := re.fullmatch(r"mid_res_(\d)", name):
        return f"{part}.mid_block.resnets.{int(m[1]) - 1}"
    if name == "mid_attn":
        return f"{part}.mid_block.attentions.0"
    return f"{part}.{name}"


def jax_vae_to_torch(params: Mapping, cfg: VAEConfig = VAEConfig(),
                     decoder_only: bool = False) -> dict[str, np.ndarray]:
    """Flax ``AutoencoderKL`` params -> diffusers-keyed state dict.
    ``decoder_only`` keeps the keys the port's decode-half
    ``AutoencoderKL`` holds (``decoder.*`` and ``post_quant_conv``)."""
    p = _params(params)
    out: dict[str, np.ndarray] = {}
    n = len(cfg.channel_mult)
    for part in ("decoder",) if decoder_only else ("encoder", "decoder"):
        for name, node in p[part].items():
            key = _vae_key(part, name, n)
            if name == "mid_attn":
                _norm(node["group_norm"], key + ".group_norm", out)
                for lin in ("to_q", "to_k", "to_v"):
                    _linear(node[lin], f"{key}.{lin}", out)
                _linear(node["to_out"], key + ".to_out.0", out)
            elif "_res" in name:
                for sub, leaf in node.items():
                    (_norm if sub.startswith("norm") else _conv)(leaf, f"{key}.{sub}", out)
            elif "norm" in name:
                _norm(node, key, out)
            else:
                _conv(node, key, out)
    _conv(p["post_quant_conv"], "post_quant_conv", out)
    if not decoder_only:
        _conv(p["quant_conv"], "quant_conv", out)
    return out


def jax_ocr_to_torch(variables: Mapping) -> dict[str, np.ndarray]:
    """Flax ``CTCRecognizer`` variables -> the port's ``CTCRecognizer``
    state dict."""
    p = _params(variables)
    out: dict[str, np.ndarray] = {}
    for name, node in p.items():
        if name == "head":
            _linear(node, name, out)
        elif re.fullmatch(r"t\d", name):
            out[name + ".weight"] = _t(np.transpose(node["kernel"], (2, 1, 0)))
            out[name + ".bias"] = _t(node["bias"])
        else:  # conv blocks b1..b5
            for sub, leaf in node.items():
                (_norm if sub.startswith("gn") else _conv)(leaf, f"{name}.{sub}", out)
    return out


def _tree_to_sd(node: Mapping, prefix: str, out: dict) -> None:
    for name, child in node.items():
        key = prefix + name
        if not isinstance(child, Mapping):  # a bare parameter (the prompter's patch)
            out[key] = _t(child)
        elif "kernel" in child:
            (_conv if np.ndim(child["kernel"]) == 4 else _linear)(child, key, out)
        elif "scale" in child:
            _norm(child, key, out)
        else:
            _tree_to_sd(child, key + ".", out)


def jax_phoscnet_to_torch(variables: Mapping) -> dict[str, np.ndarray]:
    """Flax ``PHOSCNet`` (or ``CharacterCounterNet``) variables -> the port's
    state dict: the module names are the flax names, convs HWIO -> OIHW,
    Dense [in, out] -> Linear [out, in], GroupNorm ``scale`` -> ``weight``."""
    out: dict[str, np.ndarray] = {}
    _tree_to_sd(_params(variables), "", out)
    return out


# the counter's tree follows the same rules (``trunk.conv*``, ``head``), and so
# does the writer-style encoder's (``stem``, ``s0b0.c1`` / ``.n1``, ``proj``)
jax_charcounter_to_torch = jax_phoscnet_to_torch
jax_style_to_torch = jax_phoscnet_to_torch


def torch_phoscnet_to_jax(sd: Mapping) -> dict:
    """The inverse of ``jax_phoscnet_to_torch``: the port's state dict (numpy
    or torch values) -> ``{"params": tree}`` of float32 numpy arrays under
    flax's names, the layout the JAX CLIs pickle."""
    tree: dict = {}
    for key, value in sd.items():
        a = _t(value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else value)
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        if leaf == "weight" and a.ndim == 4:  # conv OIHW -> HWIO
            leaf, a = "kernel", a.transpose(2, 3, 1, 0)
        elif leaf == "weight" and a.ndim == 2:  # Linear [out, in] -> Dense [in, out]
            leaf, a = "kernel", a.T
        elif leaf == "weight":  # a GroupNorm's
            leaf = "scale"
        node[leaf] = np.ascontiguousarray(a)
    return {"params": tree}


torch_charcounter_to_jax = torch_phoscnet_to_jax
torch_style_to_jax = torch_phoscnet_to_jax


def read_params_pickle(path: str) -> dict:
    """A JAX CLI's ``best_params.pkl`` / ``params.pkl`` (a pickled tree of
    numpy arrays; reading it needs numpy only). Unpickle only files this
    program or the JAX package wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)


def write_params_pickle(tree: Mapping, path: str) -> None:
    """Pickle ``tree`` to ``path`` atomically (a reader, or a kill, never
    sees half a file)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(tree, f)
    os.replace(tmp, path)
