"""Convert an f32 DiT state dict into the int8 weight-only serving one
(port of osu_diffusion_tpu/models/quantize.py).

A model built with `quant=True` (models/dit.py) holds every block's
projection weights as int8 codes with a float32 scale per output channel.
This module makes that state dict from an f32 one: each block weight
becomes its codes under the same name plus a scale beside it
(`in_proj_weight` -> `in_proj_weight` + `in_proj_scale`; `<layer>.weight`
-> `<layer>.weight` + `<layer>.scale`), by symmetric per-output-channel
absmax quantization (ops/quant.py, quantize_weight). Everything else
(embedders, label table, final layer, biases) passes through unchanged.
"""
from __future__ import annotations

import re
from typing import Callable

import torch

from osu_diffusion_tpu_torch.ops.quant import quantize_weight

# the block weights that become int8, as (weight name, scale name) suffixes
_QUANT_WEIGHT = re.compile(
    r"^(blocks\.\d+\.)(attn\.in_proj_weight|attn\.out_proj\.weight|mlp\.fc[12]\.weight"
    r"|adaLN_modulation\.1\.weight)$"
)


def _scale_name(weight_name: str) -> str:
    if weight_name.endswith("in_proj_weight"):
        return weight_name[: -len("weight")] + "scale"
    return weight_name[: -len(".weight")] + ".scale"


def quantize_state_dict(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """f32 state dict -> the int8 serving state dict of DiT(quant=True).
    Raises ValueError on a dict that is already int8."""
    out: dict[str, torch.Tensor] = {}
    for name, value in sd.items():
        if not _QUANT_WEIGHT.match(name):
            out[name] = value
            continue
        if value.dtype == torch.int8 or _scale_name(name) in sd:
            raise ValueError(
                f"{name} is already int8-quantized: quantize_state_dict takes the "
                "full-precision state dict (see restore_quantized)"
            )
        out[name], out[_scale_name(name)] = quantize_weight(value)
    return out


def restore_quantized(ckpt_path: str, model_ctor: Callable[..., torch.nn.Module], **model_kwargs):
    """The int8 serving model from a full-precision checkpoint:
    `model_ctor(**model_kwargs, quant=True)` (a `DiT_models` entry) loaded
    with the quantized weights of `ckpt_path`, on the CPU."""
    from osu_diffusion_tpu_torch.train.checkpoint import load_checkpoint

    model = model_ctor(**model_kwargs, quant=True)
    model.load_state_dict(quantize_state_dict(load_checkpoint(ckpt_path)))
    return model
