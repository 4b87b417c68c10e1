"""Checkpoint converters: the reference's UNet checkpoints, and Flax
parameter trees, to and from the port's state dicts.

The UNet's parameter names are the reference torch keys, so reading a
reference checkpoint is a key-level normaliser, not a layout transform:
``reference_unet_to_port`` (the counterpart of
``worddiffusion_tpu.models.convert.convert_reference_unet``) takes the
published ``ckpt_*.pt`` / ``ema_*.pt`` of WordStylist / WordDiffusion
(``load_torch_checkpoint`` unwraps a ``{"state_dict": ...}``), their
``--attentionMaps`` ``middle_block1`` layout, the research ``UNetModel``'s
dead tensors (left unread) and the ``CTCtopC`` aux head's eval-mode
BatchNorm (folded into its convs); ``port_unet_to_reference`` (the
counterpart of ``export_reference_unet``) writes the reference layout back.
Both walk the keys in JAX's construction order, so they take exactly the
keys JAX's take. ``jax_unet_to_torch`` maps a Flax UNet tree (the JAX
package's parameters, EMA, Adam moments) onto the port's keys: the port's
copy of JAX's ``export_reference_unet`` walk, plus the parameters that
exporter leaves out (the CTC aux head and the glyph encoder,
``jax_unet_extras_to_torch``). This module adds the VAE
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

import logging
import os
import pickle
import re
from typing import Mapping

import numpy as np
import torch

from ..configs.config import VAEConfig


def _t(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):  # a bfloat16 leaf of an orbax checkpoint
        a = a.detach().float().numpy()
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32))


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def state_dict_to_torch(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _conv(node, key, out):
    out[key + ".weight"] = _t(np.transpose(node["kernel"], (3, 2, 0, 1)))
    out[key + ".bias"] = _t(node["bias"])


def _linear(node, key, out, bias: bool = True):
    out[key + ".weight"] = _t(np.asarray(node["kernel"]).T)
    if bias:
        out[key + ".bias"] = _t(node["bias"])


def _norm(node, key, out):
    out[key + ".weight"] = _t(node["scale"])
    out[key + ".bias"] = _t(node["bias"])


def jax_unet_extras_to_torch(params: Mapping, cfg) -> dict[str, np.ndarray]:
    """The Flax UNet's parameters that JAX's ``export_reference_unet`` leaves
    out (the reference has no such tensors) -> the port's keys: the CTC aux
    head (``aux_head`` -> ``auxhead.*``, its GroupNorms ``temporal_*_gn`` ->
    ``.1``) with ``ocr_head``, the glyph encoder (``glyph_conv1``,
    ``glyph_conv2``, ``glyph_proj``) with ``use_char_images``. Part of
    ``jax_unet_to_torch``."""
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

def _resblock(node, key, out):
    _norm(node["in_norm"], key + ".in_layers.0", out)
    _conv(node["in_conv"]["Conv_0"], key + ".in_layers.2", out)
    _linear(node["emb_proj"]["Dense_0"], key + ".emb_layers.1", out)
    _norm(node["out_norm"], key + ".out_layers.0", out)
    _conv(node["out_conv"]["Conv_0"], key + ".out_layers.3", out)
    if "skip" in node:
        _conv(node["skip"]["Conv_0"], key + ".skip_connection", out)


def _attention(node, key, out):
    for n in "qkv":
        _linear(node[f"to_{n}"]["Dense_0"], f"{key}.to_{n}", out, bias=False)
    _linear(node["to_out"]["Dense_0"], key + ".to_out.0", out)


def _spatial_transformer(node, key, cfg, out):
    _norm(node["norm"], key + ".norm", out)
    _conv(node["proj_in"]["Conv_0"], key + ".proj_in", out)
    _conv(node["proj_out"]["Conv_0"], key + ".proj_out", out)
    for d in range(cfg.transformer_depth):
        tb, block = f"{key}.transformer_blocks.{d}", node[f"block_{d}"]
        _attention(block["attn1"], tb + ".attn1", out)
        _attention(block["attn2"], tb + ".attn2", out)
        _norm(block["norm2"], tb + ".norm2", out)
        _norm(block["norm3"], tb + ".norm3", out)
        _linear(block["ff"]["GEGLU_0"]["Dense_0"]["Dense_0"], tb + ".ff.net.0.proj", out)
        _linear(block["ff"]["Dense_0"]["Dense_0"], tb + ".ff.net.2", out)
        if not cfg.attn1_cross:
            _norm(block["norm1"], tb + ".norm1", out)


def _unet_blocks(cfg):
    """(kind, port key prefix, Flax node path) of each block of the UNet in
    JAX's construction order, the one walk of its layout: ``_unet_layout``
    expands each block to its reference keys, ``jax_unet_to_torch`` maps
    each Flax node. Kinds: ``linear``, ``embed``, ``conv``, ``norm``,
    ``res`` (a ResBlock), ``attn`` (a SpatialTransformer)."""
    yield "linear", "time_embed.0", ("time_mlp_1", "Dense_0")
    yield "linear", "time_embed.2", ("time_mlp_2", "Dense_0")
    yield "embed", "label_emb", ("label_emb",)
    yield "embed", "word_emb.embedding", ("word_emb", "embedding")
    for lin in ("linear_query", "linear_key", "linear_value"):
        yield "linear", f"word_emb.attention.{lin}", ("word_emb", "attention", lin, "Dense_0")
    if cfg.style_vec_dim:
        yield "linear", "wrd_proj", ("style_proj", "wrd_proj", "Dense_0")
    yield "conv", "input_blocks.0.0", ("conv_in", "Conv_0")
    idx, ds, levels = 1, 1, len(cfg.channel_mult)
    for level in range(levels):
        for i in range(cfg.num_res_blocks):
            yield "res", f"input_blocks.{idx}.0", (f"in_{level}_{i}_res",)
            if ds in cfg.attention_resolutions:
                yield "attn", f"input_blocks.{idx}.1", (f"in_{level}_{i}_attn",)
            idx += 1
        if level != levels - 1:
            yield "conv", f"input_blocks.{idx}.0.op", (f"down_{level}", "Conv2D_0", "Conv_0")
            idx += 1
            ds *= 2
    yield "res", "middle_block.0", ("mid_res1",)
    yield "attn", "middle_block.1", ("mid_attn",)
    yield "res", "middle_block.2", ("mid_res2",)
    idx = 0
    for level in reversed(range(levels)):
        for i in range(cfg.num_res_blocks + 1):
            yield "res", f"output_blocks.{idx}.0", (f"out_{level}_{i}_res",)
            layer = 1
            if ds in cfg.attention_resolutions:
                yield "attn", f"output_blocks.{idx}.{layer}", (f"out_{level}_{i}_attn",)
                layer += 1
            if level and i == cfg.num_res_blocks:
                yield ("conv", f"output_blocks.{idx}.{layer}.conv",
                       (f"up_{level}", "Conv2D_0", "Conv_0"))
                ds //= 2
            idx += 1
    yield "norm", "out.0", ("out_norm",)
    yield "conv", "out.2", ("out_conv", "Conv_0")


# the Flax UNet creates these only when its init was given writer ids / a style vector
_OPTIONAL_NODES = ("label_emb", "style_proj")


def jax_unet_to_torch(params: Mapping, cfg) -> dict[str, np.ndarray]:
    """A Flax UNet tree (``{'params': ...}`` or its content: parameters, an
    EMA copy, Adam moments, gradients) -> the port's ``UNet(cfg)`` keys,
    fp32 numpy; ``state_dict_to_torch`` of it loads with ``strict=True``.
    The port's counterpart of JAX's ``export_reference_unet`` (the same
    walk, ``_unet_blocks``, without its ``template`` and ``middle_block1``
    options: the port's keys are the reference's ``middle_block``), plus
    what that exporter leaves out (``jax_unet_extras_to_torch``: the CTC aux
    head, the glyph encoder)."""
    p = _params(params)
    out: dict[str, np.ndarray] = {}
    for kind, key, path in _unet_blocks(cfg):
        if path[0] in _OPTIONAL_NODES and path[0] not in p:
            continue
        node = p
        for name in path:
            node = node[name]
        if kind == "res":
            _resblock(node, key, out)
        elif kind == "attn":
            _spatial_transformer(node, key, cfg, out)
        elif kind == "embed":
            out[key + ".weight"] = _t(node["embedding"])
        else:
            {"linear": _linear, "conv": _conv, "norm": _norm}[kind](node, key, out)
    out.update(jax_unet_extras_to_torch(params, cfg))
    return out


# -- the reference UNet's checkpoints ------------------------------------------
def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pt`` checkpoint (``ckpt_*.pt`` / ``ema_*.pt``, or the
    port's ``ema_unet.pt``) -> its state dict, unwrapped from a
    ``{"state_dict": ...}``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def _np(v) -> np.ndarray:
    return _t(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)


def _pairs(names, prefix: str = "") -> list[str]:
    """The weight and bias keys of each module ``names`` under ``prefix``."""
    pre = prefix + "." if prefix else ""
    return [f"{pre}{n}.{leaf}" for n in names for leaf in ("weight", "bias")]


def _resblock_keys(prefix: str, skip: bool) -> list[str]:
    keys = _pairs(("in_layers.0", "in_layers.2", "emb_layers.1", "out_layers.0",
                   "out_layers.3"), prefix)
    return keys + _pairs(("skip_connection",), prefix) if skip else keys


def _transformer_keys(prefix: str, cfg) -> list[str]:
    keys = _pairs(("norm", "proj_in", "proj_out"), prefix)
    for d in range(cfg.transformer_depth):
        tb = f"{prefix}.transformer_blocks.{d}"
        for attn in ("attn1", "attn2"):
            keys += [f"{tb}.{attn}.to_{n}.weight" for n in "qkv"]
            keys += _pairs(("to_out.0",), f"{tb}.{attn}")
        keys += _pairs(("norm2", "norm3", "ff.net.0.proj", "ff.net.2"), tb)
        if not cfg.attn1_cross:  # the WordStylist variant runs norm1
            keys += _pairs(("norm1",), tb)
    return keys


# --attentionMaps checkpoints hold the middle block as
# middle_block1 = [[ResBlock, ST], [ResBlock]] (reference unet.py:1336-1366)
_MIDDLE_BLOCK1 = {"middle_block.0": "middle_block1.0.0", "middle_block.1": "middle_block1.0.1",
                  "middle_block.2": "middle_block1.1.0"}


def _unet_layout(cfg, has, middle_block1: bool) -> list[tuple[str, str]]:
    """(port key, reference key) of every UNet tensor JAX's converters carry,
    in their construction order (``convert_reference_unet``; the blocks of
    ``_unet_blocks``). ``has(key)``: whether the source state dict holds a
    ResBlock's skip connection."""
    pairs = []
    for kind, port, _ in _unet_blocks(cfg):
        ref = _MIDDLE_BLOCK1.get(port, port) if middle_block1 else port
        if kind == "res":
            keys = _resblock_keys(ref, has(ref + ".skip_connection.weight"))
        elif kind == "attn":
            keys = _transformer_keys(ref, cfg)
        elif kind == "embed":
            keys = [ref + ".weight"]
        else:
            keys = _pairs((ref,))
        pairs += [(port + k[len(ref):], k) for k in keys]
    return pairs


def _glyph_keys(cfg) -> list[str]:
    """The port's glyph encoder (``use_char_images``), which JAX's converters
    do not carry; the port's own checkpoints hold it under these keys."""
    return _pairs(("glyph_conv1", "glyph_conv2", "glyph_proj")) if cfg.use_char_images else []


def _fold_bn_conv(sd, conv: str, bn: str, eps: float = 1e-5) -> tuple[np.ndarray, np.ndarray]:
    """An eval-mode BatchNorm2d folded into the conv before it, in fp32 numpy
    in JAX's order (``_fold_bn_conv``): s = gamma / sqrt(var + eps)."""
    w, b = _np(sd[conv + ".weight"]), _np(sd[conv + ".bias"])
    gamma, beta = _np(sd[bn + ".weight"]), _np(sd[bn + ".bias"])
    mean, var = _np(sd[bn + ".running_mean"]), _np(sd[bn + ".running_var"])
    s = gamma / np.sqrt(var + eps)
    return w * s[:, None, None, None], (b - mean) * s + beta


_OCR_NORM_REFUSAL = ("converted reference CTC heads fold BatchNorm into the convs; "
                     "build the UNet with ocr_norm='none'")


def _aux_head(sd, cfg, out: dict, read: set) -> None:
    """The CTC aux head (``cfg.ocr_head``) into ``out``: the reference
    ``CTCtopC``'s BatchNorm folded into its convs (``ocr_norm="none"``,
    JAX's ``_ctc_head``), or, under ``ocr_norm="group"``, the port's own
    GroupNorm head as its trainer saves it."""
    pre = "auxhead"
    convs = [f"{pre}.temporal_i"] + [f"{pre}.temporal_m.{i}" for i in range(cfg.ocr_layers)]
    batchnorm = f"{pre}.temporal_i.1.running_mean" in sd
    if cfg.ocr_norm != "none" and (batchnorm or cfg.ocr_norm != "group"):
        raise ValueError(_OCR_NORM_REFUSAL)
    plain = _pairs(("temporal_o", "lin1", "lin2"), pre)

    def copy(keys):
        out.update({k: _np(sd[k]) for k in keys})
        read.update(keys)

    def fold(name):
        out[name + ".0.weight"], out[name + ".0.bias"] = _fold_bn_conv(
            sd, name + ".0", name + ".1")
        read.update(_pairs(("0", "1"), name) + [f"{name}.1.running_mean",
                                                 f"{name}.1.running_var"])

    if cfg.ocr_norm == "group":
        copy([k for c in convs for k in _pairs(("0", "1"), c)] + plain)
        return
    fold(convs[0])  # JAX's order: temporal_i, temporal_o, lin1, lin2, temporal_m
    copy(plain)
    for name in convs[1:]:
        fold(name)


def reference_unet_to_port(sd: Mapping, cfg) -> dict[str, np.ndarray]:
    """A reference UNet state dict (torch tensors or numpy; a
    ``{"state_dict": ...}`` is unwrapped) -> the port's ``UNet(cfg)`` keys,
    fp32 numpy (``state_dict_to_torch`` makes it loadable with
    ``strict=True``). The counterpart of JAX's ``convert_reference_unet``:
    the same keys in the same order, ``middle_block1`` read as
    ``middle_block``, the ``to_kv`` / ``attnc`` / dead ``norm1`` tensors and
    the buffers left unread (logged), a ``CTCtopC`` head's BatchNorm folded
    under ``ocr_norm="none"``. A tensor the UNet needs and ``sd`` lacks raises
    ``KeyError`` naming it."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    middle_block1 = "middle_block.0.in_layers.0.weight" not in sd
    out, read = {}, set()
    for port, ref in _unet_layout(cfg, lambda k: k in sd, middle_block1):
        if ref not in sd:
            raise KeyError(ref)
        out[port] = _np(sd[ref])
        read.add(ref)
    for k in _glyph_keys(cfg):
        out[k] = _np(sd[k])
        read.add(k)
    if cfg.ocr_head:
        if "auxhead.temporal_i.0.weight" not in sd:
            raise KeyError("auxhead.temporal_i.0.weight")
        _aux_head(sd, cfg, out, read)
    unread = [k for k in sd if k not in read]
    if unread:
        logging.info("reference UNet checkpoint: %d of %d tensors left unread (e.g. %s)",
                     len(unread), len(sd), ", ".join(unread[:3]))
    return out


def port_unet_to_reference(sd: Mapping, cfg, template: Mapping | None = None,
                           middle_block1: bool = False) -> dict[str, torch.Tensor]:
    """The port's UNet state dict -> a reference state dict, fp32 tensors:
    the counterpart of JAX's ``export_reference_unet``, with its key set and
    values. ``template`` (an original reference state dict) fills every key
    this does not write (dead tensors, buffers), so the reference module
    loads the result with ``strict=True``; ``middle_block1`` writes the
    ``--attentionMaps`` layout. The CTC aux head and the glyph encoder are
    not exported (a converted head's BatchNorm was folded; retrain it or
    keep the template's)."""
    out = {ref: _np(sd[port]) for port, ref in _unet_layout(cfg, lambda k: k in sd,
                                                             middle_block1)}
    merged = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
              for k, v in (template or {}).items()}
    merged.update(state_dict_to_torch(out))
    return merged


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
