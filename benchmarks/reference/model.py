"""The DiT forward in plain PyTorch, over a state dict with the reference
model's parameter names (OliBomby/osu-diffusion `models.py`):

    xoc_embedder.mlp.0, xoc_embedder.playfield_size, t_embedder.mlp.{0,2},
    y_embedder.embedding_table (num_classes + 1 rows, the null class last),
    blocks.N.attn.{in_proj_weight, in_proj_bias, out_proj},
    blocks.N.mlp.fc{1,2}, blocks.N.adaLN_modulation.1,
    final_layer.{linear, adaLN_modulation.1}

Each block is adaLN-Zero's: LayerNorm without affine (eps 1e-6), modulated
by shift and scale, gated; attention over the band q - L < k <= q + L and
keys below the valid length; a GELU-tanh MLP of ratio 4. The first layer
embeds each coordinate times the playfield (512, 384), and o / 10, as
128-wide sinusoids (cos first) beside the 144-wide context; the timestep
embedder is a 256-wide sinusoid through Linear-SiLU-Linear.

Precision is stated, not implied. `Precision.stream` rounds what the model
carries between its parts (the residual stream, the projections' operands
and products); `Precision.operands` rounds the operands of the attention
core's two products (q scaled by Dh^-1/2, k, the unnormalised
probabilities, v) and of the MLP's two (the modulated input, the hidden
activation after GELU, both weights), each product summed in f32. "f32"
leaves a value as it is, "bf16" and "fp8" (e4m3, saturated at 448) round
it. Rounding is straight through under autograd: the value is rounded,
the gradient passes unchanged. `quant` replaces each block's four weights
by int8 (or int4) codes with one f32 scale an output row
(`quantize_blocks`): a product is then op(a) . codes^T times the scale.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

PLAYFIELD = (512.0, 384.0)
LN_EPS = 1e-6
FIRST_FREQ = 128  # the first layer's sinusoid width per input
T_FREQ = 256  # the timestep embedder's sinusoid width
BLOCK_WEIGHTS = ("attn.in_proj_weight", "attn.out_proj.weight", "mlp.fc1.weight", "mlp.fc2.weight",
                 "adaLN_modulation.1.weight")


@dataclass(frozen=True)
class Precision:
    stream: str = "f32"
    operands: str = "f32"


FP8_MAX = 448.0


def _round(a: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "f32":
        return a
    if kind == "bf16":
        r = a.detach().to(torch.bfloat16).to(torch.float32)
    elif kind == "fp8":
        r = a.detach().clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(torch.float32)
    else:
        raise ValueError(f"unknown precision {kind!r}")
    return a + (r - a).detach() if a.requires_grad else r


def param_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every tensor of the state dict, in the model's order."""
    d, depth = cfg["hidden_size"], cfg["depth"]
    hdim = int(d * cfg["mlp_ratio"])
    out = cfg["in_channels"] * (2 if cfg["learn_sigma"] else 1)
    first_in = cfg["in_channels"] * FIRST_FREQ + FIRST_FREQ + cfg["context_size"]
    shapes = [("xoc_embedder.mlp.0.weight", (d, first_in)), ("xoc_embedder.mlp.0.bias", (d,)),
              ("xoc_embedder.playfield_size", (2,)),
              ("t_embedder.mlp.0.weight", (d, T_FREQ)), ("t_embedder.mlp.0.bias", (d,)),
              ("t_embedder.mlp.2.weight", (d, d)), ("t_embedder.mlp.2.bias", (d,)),
              ("y_embedder.embedding_table.weight", (cfg["num_classes"] + 1, d))]
    for i in range(depth):
        b = f"blocks.{i}."
        shapes += [(b + "attn.in_proj_weight", (3 * d, d)), (b + "attn.in_proj_bias", (3 * d,)),
                   (b + "attn.out_proj.weight", (d, d)), (b + "attn.out_proj.bias", (d,)),
                   (b + "mlp.fc1.weight", (hdim, d)), (b + "mlp.fc1.bias", (hdim,)),
                   (b + "mlp.fc2.weight", (d, hdim)), (b + "mlp.fc2.bias", (d,)),
                   (b + "adaLN_modulation.1.weight", (6 * d, d)),
                   (b + "adaLN_modulation.1.bias", (6 * d,))]
    shapes += [("final_layer.linear.weight", (out, d)), ("final_layer.linear.bias", (out,)),
               ("final_layer.adaLN_modulation.1.weight", (2 * d, d)),
               ("final_layer.adaLN_modulation.1.bias", (2 * d,))]
    return shapes


def quantize(w: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-row quantization: scale = absmax / (2^(bits-1) - 1)
    (1 for an all-zero row), codes = round(w / scale), half to even. Returns
    (codes as f32, scale (out,))."""
    top = 2 ** (bits - 1) - 1
    w = w.to(torch.float32)
    absmax = w.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / top, torch.ones_like(absmax))
    return torch.round(w / scale[:, None]).clamp(-top, top), scale


def quantize_blocks(params: dict, depth: int, bits: int) -> dict:
    """name -> (codes, scale) of every block weight that int8 serving holds
    as codes."""
    return {f"blocks.{i}.{w}": quantize(params[f"blocks.{i}.{w}"], bits)
            for i in range(depth) for w in BLOCK_WEIGHTS}


def sinusoid(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """(...,) -> (..., dim): cos then sin of t * exp(-ln(max_period) * i / half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                            device=t.device) / half)
    args = t.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    xc = x - x.mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + LN_EPS)


class Reference:
    """One model's forward under one precision. `params`: f32 tensors by
    name on one device; `quant`: `quantize_blocks`' codes, or None."""

    def __init__(self, cfg: dict, params: dict, prec: Precision = Precision(), quant: dict | None = None):
        self.cfg, self.p, self.prec, self.quant = cfg, params, prec, quant

    def s(self, a):
        return _round(a, self.prec.stream)

    def op(self, a):
        return _round(a, self.prec.operands)

    def dense(self, x, name: str):
        """A projection in the stream: operands and product rounded, then the
        bias. Under `quant` a block weight's codes take op(x) instead."""
        w, b = self.p[name + "weight"], self.p[name + "bias"]
        if self.quant is not None and name + "weight" in self.quant:
            codes, scale = self.quant[name + "weight"]
            return torch.matmul(self.op(x), codes.t()) * scale + b
        return self.s(self.s(torch.matmul(self.s(x), self.s(w).t())) + self.s(b))

    def first_layer(self, x, o, c):
        n, t, ch = x.shape
        pf = torch.tensor(PLAYFIELD, dtype=torch.float32, device=x.device)
        x_freq = sinusoid(x * pf, FIRST_FREQ).reshape(n, t, ch * FIRST_FREQ)
        o_freq = sinusoid(o / 10.0, FIRST_FREQ)
        return self.dense(torch.cat([x_freq, o_freq, c], dim=-1), "xoc_embedder.mlp.0.")

    def cond(self, t, y, drop=None):
        h = F.linear(sinusoid(t, T_FREQ), self.p["t_embedder.mlp.0.weight"], self.p["t_embedder.mlp.0.bias"])
        temb = F.linear(F.silu(h), self.p["t_embedder.mlp.2.weight"], self.p["t_embedder.mlp.2.bias"])
        if drop is not None:
            y = torch.where(drop, self.cfg["num_classes"], y)
        return temb + self.p["y_embedder.embedding_table.weight"][y]

    def attention(self, h, i: int, band: int, valid: int, int8: bool):
        n, t, d = h.shape
        heads = self.cfg["num_heads"]
        dh = d // heads
        if int8:
            qkv = self.dense(h, f"blocks.{i}.attn.in_proj_")
        else:
            w = self.p[f"blocks.{i}.attn.in_proj_weight"]
            b = self.p[f"blocks.{i}.attn.in_proj_bias"]
            qkv = self.s(self.s(torch.matmul(self.s(h), self.s(w).t())) + self.s(b))
        q, k, v = (a.reshape(n, t, heads, dh).transpose(1, 2) for a in qkv.split(d, dim=-1))
        scores = torch.matmul(self.op(q * (1.0 / math.sqrt(dh))), self.op(k).transpose(-1, -2))
        idx = torch.arange(t, device=h.device)
        allowed = ((idx[None, :] > idx[:, None] - band) & (idx[None, :] <= idx[:, None] + band)
                   & (idx[None, :] < valid))
        scores = torch.where(allowed, scores, -1e30)
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.where(allowed, torch.exp(scores - m), 0.0)
        o = torch.matmul(self.op(p), self.op(v)) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = o.transpose(1, 2).reshape(n, t, d)
        if int8:  # the out projection takes o rounded to the operand type
            return self.dense(self.op(o), f"blocks.{i}.attn.out_proj.")
        return self.dense(self.s(o), f"blocks.{i}.attn.out_proj.")

    def mlp(self, x, shift, scale, gate, i: int):
        h = layer_norm(x) * (1 + scale[:, None, :]) + shift[:, None, :]
        name = f"blocks.{i}.mlp."
        if self.quant is not None:
            (c1, s1), (c2, s2) = self.quant[name + "fc1.weight"], self.quant[name + "fc2.weight"]
            pre = torch.matmul(self.op(h), c1.t()) * s1 + self.p[name + "fc1.bias"]
            out = torch.matmul(self.op(F.gelu(pre, approximate="tanh")), c2.t()) * s2
        else:
            pre = torch.matmul(self.op(h), self.op(self.p[name + "fc1.weight"]).t()) + self.p[name + "fc1.bias"]
            out = torch.matmul(self.op(F.gelu(pre, approximate="tanh")), self.op(self.p[name + "fc2.weight"]).t())
        return self.s(x + gate[:, None, :] * (out + self.p[name + "fc2.bias"]))

    def block(self, x, cond, i: int, band: int, valid: int):
        mod = self.dense(F.silu(cond), f"blocks.{i}.adaLN_modulation.1.")
        shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = mod.chunk(6, dim=-1)
        h = self.s(self.s(layer_norm(x)) * (1 + scale_a[:, None, :]) + shift_a[:, None, :])
        x = self.s(x + gate_a[:, None, :] * self.attention(h, i, band, valid, self.quant is not None))
        return self.mlp(x, shift_m, scale_m, gate_m, i)

    def forward(self, x, t, o, c, y, band: int, valid: int | None = None, drop=None):
        """x (N, T, 2), t (N,) original timesteps, o (N, T), c (N, T, 144),
        y (N,) -> (N, T, 2C) f32; keys at or past `valid` are masked."""
        valid = x.shape[1] if valid is None else valid
        h = self.first_layer(x, o, c)
        cond = self.cond(t, y, drop)
        for i in range(self.cfg["depth"]):
            h = self.block(h, cond, i, band, valid)
        mod = self.dense(F.silu(cond), "final_layer.adaLN_modulation.1.")
        shift, scale = mod.chunk(2, dim=-1)
        h = self.s(self.s(layer_norm(h)) * (1 + scale[:, None, :]) + shift[:, None, :])
        return F.linear(h, self.p["final_layer.linear.weight"], self.p["final_layer.linear.bias"])

    def forward_cfg(self, x, t, o, c, y, cfg_scale: float, band: int, valid: int | None = None):
        """Classifier-free guidance over [cond | uncond]: both halves see the
        first half's x; the eps channels are guided, the variance channels
        pass through."""
        half = x[: x.shape[0] // 2]
        out = self.forward(torch.cat([half, half]), t, o, c, y, band, valid)
        ch = self.cfg["in_channels"]
        cond_eps, uncond_eps = out[..., :ch].chunk(2)
        eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        return torch.cat([torch.cat([eps, eps]), out[..., ch:]], dim=-1)
