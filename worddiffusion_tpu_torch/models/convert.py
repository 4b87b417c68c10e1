"""Flax parameter trees -> the port's state dicts.

The UNet needs no loader here: its parameter names are the reference
torch keys, so ``worddiffusion_tpu.models.convert.export_reference_unet``
(jax-free, numpy only) already emits a state dict that
``UNet.load_state_dict(strict=True)`` takes. This module adds the VAE
(diffusers key names; the inverse of
``worddiffusion_tpu.models.vae.convert_diffusers_vae``) and the OCR
recognizer. Each function takes a nested dict of numpy arrays and
returns ``{key: np.ndarray}``; wrap the values with ``torch.from_numpy``
or pass the dict to ``state_dict_to_torch``.

Layout transforms: conv HWIO -> OIHW, 1-D conv [k, in, out] ->
[out, in, k], Dense [in, out] -> Linear [out, in], norm ``scale`` ->
``weight``.
"""

from __future__ import annotations

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
