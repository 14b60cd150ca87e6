"""Diffusion Transformer with adaLN-Zero conditioning: the inference and the
training forward (port of osu_diffusion_tpu/models/dit.py).

Modules and parameter names follow the reference torch model, so a
reference state dict loads with `load_state_dict`:

    xoc_embedder.mlp.0, xoc_embedder.playfield_size
    t_embedder.mlp.{0,2}
    y_embedder.embedding_table          (num_classes + 1 rows; null class last)
    blocks.N.attn.{in_proj_weight, in_proj_bias, out_proj}
    blocks.N.mlp.fc{1,2}
    blocks.N.adaLN_modulation.1
    final_layer.{linear, adaLN_modulation.1}

Layout is (N, T, C) throughout. In each block the MLP half is the fused
adaLN-MLP (kernel B on the card) and, with a band, the attention core is
banded attention (kernel A, and in training its dq and dk/dv kernels); the
attention-side LayerNorm/modulate and gate+residual stay plain torch, as
they are plain jnp in the JAX package. `matmul_dtype` is the operand type of
the kernels: bfloat16 (the kernels' contract, the default) or float32, which
only the plain versions on the CPU take.

The residual stream runs in `dtype` (float32, or bfloat16 in training over
f32 master weights), cast where the JAX package casts, not where autocast
would: FirstLayer rounds its f32 sincos and context to the stream type
before `proj`; the adaLN projections, qkv and out projections multiply in
the stream type with weights cast at use, and add their bias in it;
LayerNorm takes f32 statistics; the MLP kernel takes f32 modulation
vectors; the final head runs in f32, so the output is f32.

Context parallelism (`cp`, a parallel/mesh.py `Mesh`): x, o and c hold
this rank's rows of the sequence. Everything but attention works per token
(the first layer, the MLP half, the final layer) or per sample (the
conditioning), so each rank runs the whole model on its rows and attention
alone exchanges halos with the neighbouring ranks; `valid_len` is the
global real length. The f32 and the int8 blocks both take it.

Tensor parallelism (TP, parallel/sharding.py `shard_model`, which gives
the modules below a mesh as `.tp`): each model rank holds its shard of the
label table (rows), of every adaLN head (output columns) and of every MLP
(fc1's rows, fc2's columns) and runs the same forward on the same batch.
The label lookup zeroes the rows that are not this rank's and the row sums
them; each head computes its columns of the modulation and the row
gathers them before it is chunked; the MLP half runs kernel B on the
rank's hidden units, every rank but the first as a partial (no residual x
and no b2), and the row sums the outputs. The sums of the input gradients
of the MLP and of each head run in the backward (`row_grad_sum`). A part
that `shard_model` left whole (a degree that does not divide it) runs as
it does without TP. `shard_model` swaps the parameters' data only, so a
Linear's `out_features` and the table's `num_embeddings` keep the whole
model's sizes, against which a module tells its shard. Under `cp` as well
(the row's ranks split the sequence and hold the weight shards), each
block and the final layer gather their sharded weights whole first
(`linear_params`, one collective each) and run the CP path on them, and the
label lookup's row sum also sums its gradient over the row
(parallel/sharding.py says why); under remat a block's gathered weights
live only while it runs, and again in its recompute.

Training (`train=True`): labels drop to the null class `num_classes` with
probability `class_dropout_prob` (from a generator, or a given mask), and
with `remat` each block is recomputed in the backward
(`torch.utils.checkpoint`, the JAX package's `nn.remat`). `mlp_bwd` picks
the MLP half's backward, as the JAX `DiTConfig.mlp_bwd` does: "xla" (the
plain backward, the default) or "fused" (the two backward kernels).

int8 weight-only serving (`quant=True`, the JAX package's
`DiTConfig.quant`): every block's projections hold int8 codes with a
float32 scale per output channel, as buffers (not parameters), filled by
`models/quantize.py` from an f32 state dict. The names stay beside the
reference's, each int8 weight with its scale:

    blocks.N.attn.{in_proj_weight (int8, (3D, D)), in_proj_scale, in_proj_bias}
    blocks.N.attn.out_proj.{weight (int8), scale, bias}
    blocks.N.mlp.fc{1,2}.{weight (int8), scale, bias}
    blocks.N.adaLN_modulation.1.{weight (int8), scale, bias}

Embedders, label table and final layer stay f32. A quant block makes four
int8 dispatches around the attention core: the adaLN projection
(`int8_matmul` of silu(cond)), the qkv projection with LayerNorm and
modulation folded in (`int8_modulated_matmul`), the out projection with
gate and residual folded in (`int8_out_residual`), and the whole MLP half
(`adaln_mlp_quant`). Each reads its int8 codes as the buffers hold them
(torch's Linear layout; the qkv projection and the MLP half upcast them on
chip in kernel B's Hopper GEMM), so nothing packs or copies a weight. The
stream is float32 only (the int8 wrappers raise
TypeError on another type; the sampler refuses a bf16 stream over int8
blocks), and the quant model serves only: it raises
under `train=True` and under grad.

Δ-cache (`delta_mode`, the JAX package's cross-step reuse of the middle
blocks): "record" returns Δ = x after block hi-1 minus x before block lo
beside the output; "apply" adds a given Δ at block lo and never runs blocks
lo..hi-1. The same loop serves the f32 and the int8 blocks, and every block
returns a new tensor (no kernel writes its residual in place), so the x
kept at block lo is still the block's input when Δ is taken.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from osu_diffusion_tpu_torch import PLAYFIELD
from osu_diffusion_tpu_torch.ops.adaln_mlp import (
    BWD_IMPLS,
    AdalnMlp,
    adaln_mlp,
    adaln_mlp_quant,
)
from osu_diffusion_tpu_torch.ops.attention import multi_head_attention
from osu_diffusion_tpu_torch.ops.embeddings import (
    offset_sequence_embedding,
    position_sequence_embedding,
    timestep_embedding,
)
from osu_diffusion_tpu_torch.ops.quant import int8_matmul
from osu_diffusion_tpu_torch.parallel.sharding import (
    gather_columns,
    gather_shards,
    row_grad_sum,
    row_sum,
    table_rows,
)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation; shift/scale are (N, D)."""
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Non-affine LayerNorm with the two-pass variance, statistics in f32,
    result in x's type."""
    xf = x.to(torch.float32)
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps)).to(x.dtype)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A Linear layer computed in `dtype`: input and weight cast at use, the
    product rounded to `dtype`, then the bias (cast to `dtype`) added."""
    return F.linear(x.to(dtype), weight.to(dtype)) + bias.to(dtype)


def linear_params(linears, tp, cp) -> list[torch.Tensor]:
    """Each Linear's weight and bias, in order: under context parallelism
    over a sharded model, whole (the row's shards gathered in one
    collective, parallel/sharding.py `gather_shards`); else the parameters
    themselves (a TP shard stays a shard)."""
    params = [p for lin in linears for p in (lin.weight, lin.bias)]
    if tp is None or cp is None:
        return params
    shapes = [s for lin in linears for s in ((lin.out_features, lin.in_features), (lin.out_features,))]
    dims = [next((d for d, (a, b) in enumerate(zip(p.shape, shape)) if a != b), None)
            for p, shape in zip(params, shapes)]
    return gather_shards(tp, params, dims)


def modulation(weight: torch.Tensor, bias: torch.Tensor, out_features: int, cond: torch.Tensor,
               dtype: torch.dtype, tp) -> torch.Tensor:
    """An adaLN head, silu(cond) through (weight, bias) in `dtype`. Under
    tensor parallelism a head split over the model ranks (fewer than
    `out_features` rows) computes its columns and gathers the row's; its
    input gradient is summed over the row."""
    if tp is None or weight.shape[0] == out_features:
        return dense(F.silu(cond), weight, bias, dtype)
    (cond,) = row_grad_sum(cond, mesh=tp)
    return gather_columns(dense(F.silu(cond), weight, bias, dtype), tp)


class TimestepEmbedder(nn.Module):
    """256-dim sinusoid -> MLP(SiLU) -> hidden, in f32."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(
            nn.Linear(frequency_embedding_size, hidden_size),
            nn.SiLU(),
            nn.Linear(hidden_size, hidden_size),
        )

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(timestep_embedding(t, self.frequency_embedding_size))


class LabelEmbedder(nn.Module):
    """Class-label table; with dropout_prob > 0 it has a null-class row at
    index num_classes (the CFG unconditional label), to which labels drop in
    training."""

    def __init__(self, num_classes: int, hidden_size: int, dropout_prob: float):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.embedding_table = nn.Embedding(num_classes + int(dropout_prob > 0), hidden_size)
        self.tp = None  # the mesh, once parallel/sharding.py has split the table

    def forward(self, labels: torch.Tensor, train: bool = False, drop: torch.Tensor | None = None,
                generator: torch.Generator | None = None, cp=None) -> torch.Tensor:
        """`drop`: a bool mask of the labels to drop (the draw when given);
        else, in training, a Bernoulli(dropout_prob) draw from `generator`.
        `cp`: the context-parallel mesh, under which a split table's row sum
        also sums the gradient."""
        if drop is None and train and self.dropout_prob > 0:
            u = torch.rand(labels.shape, generator=generator, device=labels.device)
            drop = u < self.dropout_prob
        if drop is not None:
            labels = torch.where(drop, self.num_classes, labels)
        table = self.embedding_table.weight
        rows = table.shape[0]
        if self.tp is None or rows == table_rows(self.embedding_table.num_embeddings):
            return self.embedding_table(labels)
        # vocab-parallel: this rank's rows, the others' labels zero; the row sums
        local = labels - self.tp.model_rank * rows
        mine = (local >= 0) & (local < rows)
        emb = F.embedding(torch.where(mine, local, 0), table)
        return row_sum(torch.where(mine[..., None], emb, 0.0), self.tp, grad_sum=cp is not None)


class FirstLayer(nn.Module):
    """Per-coordinate 128-dim sincos of x * playfield (256) + 128-dim sincos
    of o / 10 + context -> Linear to hidden. The sincos are computed from f32
    inputs; only their result drops to the stream type."""

    def __init__(self, in_channels: int, context_size: int, hidden_size: int,
                 frequency_embedding_size: int = 128):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        fe = frequency_embedding_size
        self.mlp = nn.Sequential(nn.Linear(in_channels * fe + fe + context_size, hidden_size))
        # a constant the reference keeps as a frozen parameter; loaded
        # checkpoints are checked to hold this value
        self.register_buffer("playfield_size", torch.tensor(PLAYFIELD, dtype=torch.float32))

    def forward(self, x, o, c, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        fe = self.frequency_embedding_size
        x_freq = position_sequence_embedding(x.to(torch.float32) * self.playfield_size, fe)
        o_freq = offset_sequence_embedding(o.to(torch.float32) / 10.0, fe)
        xoc = torch.cat([x_freq.to(dtype), o_freq.to(dtype), c.to(dtype)], dim=-1)
        return dense(xoc, self.mlp[0].weight, self.mlp[0].bias, dtype)


class SelfAttention(nn.Module):
    """Packed-qkv multi-head self-attention with torch MultiheadAttention's
    parameter names."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden_size))
        self.out_proj = nn.Linear(hidden_size, hidden_size)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, band: int | None, valid_len: int | torch.Tensor | None, matmul_dtype,
                cp=None) -> torch.Tensor:
        return multi_head_attention(
            x, self.in_proj_weight, self.in_proj_bias, self.out_proj.weight,
            self.out_proj.bias, self.num_heads, band, valid_len, matmul_dtype, cp=cp,
        )


class Mlp(nn.Module):
    """fc1 -> GELU-tanh -> fc2 parameters; the forward is the fused
    adaLN-MLP."""

    def __init__(self, hidden_size: int, mlp_hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden_size, mlp_hidden)
        self.fc2 = nn.Linear(mlp_hidden, hidden_size)
        self._kernel_weights = None

    def kernel_weights(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """fc1/fc2 weights in `dtype`, contiguous in torch's (out, in)
        layout, as `adaln_mlp` takes them, for the inference forward. Made
        once and kept until the weights change (a load, an in-place update
        or a move to another device). They carry no autograd history: the
        training forward casts inside `AdalnMlp` instead."""
        w1, w2 = self.fc1.weight, self.fc2.weight
        key = (dtype, w1.device, w1.data_ptr(), w1._version, w2.data_ptr(), w2._version)
        if self._kernel_weights is None or self._kernel_weights[0] != key:
            with torch.no_grad():
                self._kernel_weights = (key, tuple(w.to(dtype).contiguous() for w in (w1, w2)))
        return self._kernel_weights[1]


class DiTBlock(nn.Module):
    """adaLN-Zero block. Modulation order: shift/scale/gate of the attention
    half, then of the MLP half. `mlp_bwd`: the MLP half's backward in
    training, "xla" (plain) or "fused" (ops/adaln_mlp.py, `AdalnMlp`)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 mlp_bwd: str = "xla"):
        super().__init__()
        self.mlp_bwd = mlp_bwd
        self.attn = SelfAttention(hidden_size, num_heads)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 6 * hidden_size))
        self.tp = None  # the mesh, once parallel/sharding.py has split the head and the MLP

    def forward(self, x, cond, band: int | None, valid_len: int | torch.Tensor | None, matmul_dtype, cp=None):
        ada, fc1, fc2 = self.adaLN_modulation[1], self.mlp.fc1, self.mlp.fc2
        # under CP a sharded block's weights are gathered whole: no TP collective below
        ada_w, ada_b, w1, b1, w2, b2 = linear_params((ada, fc1, fc2), self.tp, cp)
        tp = self.tp if cp is None else None
        mod = modulation(ada_w, ada_b, ada.out_features, cond, x.dtype, tp)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        h = modulate(layer_norm(x), shift_msa, scale_msa)
        x = x + gate_msa[:, None, :] * self.attn(h, band, valid_len, matmul_dtype, cp)
        # the MLP kernel takes its modulation vectors in f32
        shift, scale, gate = (a.to(torch.float32) for a in (shift_mlp, scale_mlp, gate_mlp))
        if tp is not None and w1.shape[0] != fc1.out_features:
            # Megatron: this rank's hidden units, x and b2 added by the first
            # rank alone; the row sums the outputs and the input gradients
            x, shift, scale, gate = row_grad_sum(x, shift, scale, gate, mesh=tp)
            out = AdalnMlp.apply(x, shift, scale, gate, w1, b1, w2, b2, 1e-6, matmul_dtype,
                                 self.mlp_bwd, tp.model_rank != 0)
            return row_sum(out, tp)
        if torch.is_grad_enabled() and (x.requires_grad or w1.requires_grad):
            return AdalnMlp.apply(x, shift, scale, gate, w1, b1, w2, b2, 1e-6, matmul_dtype, self.mlp_bwd)
        if w1 is fc1.weight:
            w1, w2 = self.mlp.kernel_weights(matmul_dtype)
        else:  # gathered for this call
            w1, w2 = (w.to(matmul_dtype).contiguous() for w in (w1, w2))
        return adaln_mlp(x, shift, scale, gate, w1, b1, w2, b2, 1e-6, matmul_dtype)


class QuantLinear(nn.Module):
    """int8 weight-only Linear for serving: buffers `weight` (out, in) int8
    codes, `scale` (out,) f32 per output channel, `bias` (out,) f32."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features))


class QuantSelfAttention(nn.Module):
    """Packed-qkv attention over int8 projections; x is the raw residual
    stream, and the forward returns the next one (see `multi_head_attention`
    with `quant_scales`)."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        d = hidden_size
        self.register_buffer("in_proj_weight", torch.zeros(3 * d, d, dtype=torch.int8))
        self.register_buffer("in_proj_scale", torch.ones(3 * d))
        self.register_buffer("in_proj_bias", torch.zeros(3 * d))
        self.out_proj = QuantLinear(d, d)

    def forward(self, x, quant_mod, band: int | None, valid_len: int | torch.Tensor | None, matmul_dtype, cp=None):
        return multi_head_attention(
            x, self.in_proj_weight, self.in_proj_bias, self.out_proj.weight, self.out_proj.bias,
            self.num_heads, band, valid_len, matmul_dtype,
            quant_scales=(self.in_proj_scale, self.out_proj.scale), quant_mod=quant_mod, cp=cp,
        )


class QuantMlp(nn.Module):
    """int8 fc1/fc2; the forward is the int8 fused adaLN-MLP."""

    def __init__(self, hidden_size: int, mlp_hidden: int):
        super().__init__()
        self.fc1 = QuantLinear(hidden_size, mlp_hidden)
        self.fc2 = QuantLinear(mlp_hidden, hidden_size)


class QuantDiTBlock(nn.Module):
    """adaLN-Zero block over int8 projections (serving only). Under `cp`
    the projections and the MLP half run on this rank's rows (the adaLN
    projection per sample, the same on every rank) and the attention core
    through the halo exchange."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.attn = QuantSelfAttention(hidden_size, num_heads)
        self.mlp = QuantMlp(hidden_size, int(hidden_size * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), QuantLinear(hidden_size, 6 * hidden_size))

    def forward(self, x, cond, band: int | None, valid_len: int | torch.Tensor | None, matmul_dtype, cp=None):
        if torch.is_grad_enabled():
            raise RuntimeError("the int8 model serves only: call it under torch.no_grad()")
        ada = self.adaLN_modulation[1]
        mod = int8_matmul(F.silu(cond), ada.weight, ada.scale, ada.bias, matmul_dtype=matmul_dtype)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        x = self.attn(x, (shift_msa, scale_msa, gate_msa), band, valid_len, matmul_dtype, cp)
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        return adaln_mlp_quant(x, shift_mlp, scale_mlp, gate_mlp, fc1.weight, fc1.scale, fc1.bias,
                               fc2.weight, fc2.scale, fc2.bias, 1e-6, matmul_dtype)


class FinalLayer(nn.Module):
    """adaLN (shift/scale, in the stream type) + linear head in f32."""

    def __init__(self, hidden_size: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(hidden_size, out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 2 * hidden_size))
        self.tp = None  # the mesh, once parallel/sharding.py has split the head

    def forward(self, x, cond, cp=None):
        ada = self.adaLN_modulation[1]
        weight, bias = linear_params((ada,), self.tp, cp)
        mod = modulation(weight, bias, ada.out_features, cond, x.dtype, self.tp if cp is None else None)
        shift, scale = mod.chunk(2, dim=-1)
        return self.linear(modulate(layer_norm(x), shift, scale).to(torch.float32))


class DiT(nn.Module):
    """Diffusion Transformer.

    forward(x (N, T, C), t (N,), o (N, T), c (N, T, E), y (N,)) ->
    (N, T, out_channels) f32: the C mean channels (eps or x0), then with
    learn_sigma the C variance channels."""

    def __init__(
        self,
        in_channels: int = 2,
        context_size: int = 144,
        hidden_size: int = 1152,
        depth: int = 28,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        class_dropout_prob: float = 0.1,
        num_classes: int = 1000,
        learn_sigma: bool = True,
        matmul_dtype: torch.dtype = torch.bfloat16,
        remat: bool = True,
        quant: bool = False,
        mlp_bwd: str = "xla",
    ):
        super().__init__()
        if mlp_bwd not in BWD_IMPLS:
            raise ValueError(f"mlp_bwd must be one of {BWD_IMPLS}, got {mlp_bwd!r}")
        self.quant = quant
        self.in_channels = in_channels
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.num_classes = num_classes
        self.matmul_dtype = matmul_dtype
        self.remat = remat
        self.xoc_embedder = FirstLayer(in_channels, context_size, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size, class_dropout_prob)
        self.blocks = nn.ModuleList(
            QuantDiTBlock(hidden_size, num_heads, mlp_ratio) if quant
            else DiTBlock(hidden_size, num_heads, mlp_ratio, mlp_bwd) for _ in range(depth)
        )
        self.final_layer = FinalLayer(hidden_size, self.out_channels)
        self.tp = None  # the mesh, once parallel/sharding.py has split the weights

    @torch.no_grad()
    def initialize_weights(self, generator: torch.Generator | None = None) -> None:
        """The reference's init: xavier-uniform linears with zero bias;
        std-0.02 normals for the first-layer projection, the timestep MLP and
        the label table; zeros for every adaLN modulation and the final
        linear (adaLN-Zero: each block starts as the identity)."""
        g = generator
        for module in self.modules():
            if isinstance(module, nn.Linear):
                nn.init.xavier_uniform_(module.weight, generator=g)
                nn.init.zeros_(module.bias)
        for block in self.blocks:
            nn.init.xavier_uniform_(block.attn.in_proj_weight, generator=g)
            nn.init.zeros_(block.attn.in_proj_bias)
        for linear in (self.xoc_embedder.mlp[0], self.t_embedder.mlp[0], self.t_embedder.mlp[2]):
            nn.init.normal_(linear.weight, std=0.02, generator=g)
        nn.init.normal_(self.y_embedder.embedding_table.weight, std=0.02, generator=g)
        for linear in [b.adaLN_modulation[1] for b in self.blocks] + [
            self.final_layer.adaLN_modulation[1], self.final_layer.linear
        ]:
            nn.init.zeros_(linear.weight)
            nn.init.zeros_(linear.bias)

    def forward(self, x, t, o, c, y, band: int | None = None, valid_len: int | torch.Tensor | None = None,
                train: bool = False, drop: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                dtype: torch.dtype = torch.float32, cp=None, delta_mode: str = "off",
                delta_span: tuple[int, int] | None = None, delta: torch.Tensor | None = None):
        """`band`: attention half-width (None = full attention); `valid_len`:
        the real length when T is padded (keys past it are masked), an int
        or a 0-d int32 tensor on x's device (the Sampler's graphed chains
        pass it so: the attention kernel reads it on the device; not under
        `cp`, nor in training);
        `train`: label dropout (`drop` mask, else drawn from `generator`)
        and, with `remat` under grad, recomputed blocks; `dtype`: the
        residual stream's type; `cp`: the context-parallel mesh (x, o, c
        are this rank's rows). A tensor-parallel model (`.tp`, set by
        parallel/sharding.py `shard_model`) takes the whole x, o, c, y on
        every rank of the row, with the same `drop`, and returns the whole
        output on each; with `cp` too (the same mesh), each rank's rows.

        Δ-cache (cross-step reuse of the middle blocks' contribution, the
        JAX package's `delta_mode`): "off" returns the output; "record"
        runs every block and returns (out, Δ), Δ = x after block hi-1 minus
        x before block lo for `delta_span` = (lo, hi), in the stream's type;
        "apply" adds the given `delta` at block lo in place of blocks
        lo..hi-1, which never run, and returns (out, delta)."""
        if self.quant and train:
            raise RuntimeError("the int8 model serves only: train=True has no int8 path")
        if delta_mode not in ("off", "record", "apply"):
            raise ValueError(f"unknown delta_mode: {delta_mode}")
        lo = hi = -1
        if delta_mode != "off":
            lo, hi = delta_span
            if not 0 <= lo < hi <= len(self.blocks):
                raise ValueError(f"delta_span {delta_span} outside depth {len(self.blocks)}")
            if delta_mode == "apply" and delta is None:
                raise ValueError("delta_mode='apply' needs the recorded delta")
        x = self.xoc_embedder(x, o, c, dtype)
        cond = self.t_embedder(t) + self.y_embedder(y, train, drop, generator, cp)
        use_remat = train and self.remat and torch.is_grad_enabled()
        extra = () if cp is None else (cp,)
        for i, block in enumerate(self.blocks):
            if delta_mode == "apply" and lo <= i < hi:
                if i == lo:
                    x = x + delta.to(x.dtype)
                continue  # the cached span's blocks never run
            if delta_mode == "record" and i == lo:
                before = x  # every block returns a new tensor, so this one stays as it is
            if use_remat:
                # blocks draw no random numbers, so no RNG state is kept;
                # every CP rank recomputes the same blocks in the same
                # order, so the recompute's halo exchanges stay matched
                x = checkpoint(block, x, cond, band, valid_len, self.matmul_dtype, *extra,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x, cond, band, valid_len, self.matmul_dtype, *extra)
            if delta_mode == "record" and i == hi - 1:
                delta = x - before
        out = self.final_layer(x, cond, cp)
        return out if delta_mode == "off" else (out, delta)

    def forward_with_cfg(self, x, t, o, c, y, cfg_scale: float,
                         band: int | None = None, valid_len: int | torch.Tensor | None = None, cp=None,
                         dtype: torch.dtype = torch.float32, delta_mode: str = "off",
                         delta_span: tuple[int, int] | None = None,
                         delta: torch.Tensor | None = None):
        """Classifier-free guidance over the batch [cond | uncond], which
        shares the first half's x. Guidance applies to the eps channels only
        (the reference's quirk); the variance channels pass through.
        `dtype` and the Δ-cache arguments are `forward`'s (the Δ covers the
        doubled batch); under a Δ mode the result is (out, Δ)."""
        half = x[: x.shape[0] // 2]
        out = self.forward(torch.cat([half, half], dim=0), t, o, c, y, band, valid_len, cp=cp,
                           dtype=dtype, delta_mode=delta_mode, delta_span=delta_span, delta=delta)
        if delta_mode != "off":
            out, delta = out
        eps, rest = out[..., : self.in_channels], out[..., self.in_channels:]
        cond_eps, uncond_eps = eps.chunk(2, dim=0)
        half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        out = torch.cat([torch.cat([half_eps, half_eps], dim=0), rest], dim=-1)
        return out if delta_mode == "off" else (out, delta)


def DiT_XL(**kwargs) -> DiT:
    return DiT(depth=28, hidden_size=1152, num_heads=16, **kwargs)


def DiT_L(**kwargs) -> DiT:
    return DiT(depth=24, hidden_size=1024, num_heads=16, **kwargs)


def DiT_B(**kwargs) -> DiT:
    return DiT(depth=12, hidden_size=768, num_heads=12, **kwargs)


def DiT_S(**kwargs) -> DiT:
    return DiT(depth=12, hidden_size=384, num_heads=6, **kwargs)


DiT_models: dict[str, Callable[..., DiT]] = {
    "DiT-XL": DiT_XL,
    "DiT-L": DiT_L,
    "DiT-B": DiT_B,
    "DiT-S": DiT_S,
}
