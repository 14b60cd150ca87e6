#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. The card (nvidia-smi name and power limit), torch's, the CUDA
   runtime's, the CUDA driver's and nvcc's versions, the
   nvcc build of every kernel library from osu_diffusion_tpu_torch/csrc
   (one nvcc per source, all at once), and the g++ build of the native
   featurizer (csrc/osu_native.cpp).
2. Inference kernel A (banded attention, f32 q/k/v) against its plain
   version on the card: at the DiT-B sampling shape and at ragged shapes,
   against the plain version with bf16-rounded operands and against the f32
   plain version; its body (sm90), the same bits on a second call, o in
   bf16 (the int8 block's) equal to the rounded f32 o, and the registers,
   spill bytes (0 required) and shared memory of its f32 builds.
3. Inference kernel B (fused adaLN-MLP), the same way, with the body its
   calls took (bf16 weights: sm90) and the same bits on a second call;
   timed beside a cuBLAS bf16 fc1 + fc2 of its shapes (`library_ms`).
4. The training kernels, the same way, at the DiT-B training shapes (q/k/v
   (256, 12, 128, 64), x (256, 128, 768), bf16 stream) and ragged ones (T not
   a tile multiple, valid_len < T, band < T, the DiT-S width 384, the f32
   stream): the banded attention forward with LSE, its dq and dk/dv kernels
   (the LSE and all three gradients checked), and kernel B's training forward
   (out and the a / mlp residuals checked; its body, the same bits on a
   second call, its three stages' times beside the whole, the registers,
   spill bytes and shared memory of its eight GEMM builds, and a cuBLAS
   bf16 fc1 + fc2 of its shapes). `[attn-train]` and `[attn-cp]`
   (13) print the registers, spill bytes (required 0) and shared memory of
   the Hopper builds of the forward (both types), dq and dk/dv, and for
   each case the body its calls took (the forward: sm90 in both streams;
   dq and dk/dv: bf16 sm90, f32 the WMMA body); at the main shapes, two dq
   calls on the same inputs must give the same bits, and in `[attn-cp]` a
   second forward call in every case.
5. The sample CLI end to end at DiT-B width (hidden 768, depth 12, 12 heads,
   52670 classes) with seeded random weights on the kimi_no_bouken fixture:
   STEPS CFG denoise steps, the .osu written and reparsed, and each inference
   kernel's launch count equal to steps x depth. The CLI's chain (its
   capture included) and two more chains of its sampler (replays) give the
   seconds per denoise step, and a profiled chain the device time by kernel
   (kernel B's own per denoise step).
6. The model against its plain versions: one DiT-B forward at the sampling
   inputs on the card (kernels) and on the CPU (plain versions).
7. The training input path on the card's host (`[loader]`): the native
   featurizer built by g++ from osu_diffusion_tpu_torch/csrc/osu_native.cpp
   (no g++ or a failed build fails the run), tools/make_corpus.py's corpus
   of 4096 maps, native against the Python featurizer on every fixture
   (<= 2e-3) and on 64 corpus maps (<= 2e-2), maps/s both ways on one
   thread, the trainer's loader alone at 2 and 4 threads on both
   featurizers, and the cached loader over 256 maps. Then the train CLI
   end to end at DiT-B width with 52670 classes (seeded
   random init) on a Track dataset of kimi_no_bouken copies: global batch
   256, seq-len 128, 20 optimizer steps, a checkpoint inside the run that a
   second run resumes from for one more step. Checks finite "Train Loss:"
   lines and each training kernel's launch count (steps x depth x 2 for the
   two forward kernels, recomputed under --remat; steps x depth for dq and
   dk/dv). Prints seconds per optimizer step (CUDA events, steady state),
   the device busy share, the top device ops and kernel B's device time
   per step (torch.profiler), and the loader alone on both featurizers.
   Then the train CLI on the corpus at the trainer's defaults (4 threads,
   the native featurizer) for 16 steps with --profile-dir
   (`[train-corpus]`: the launch counts, the trace written, start to start
   against inside train_step, the busy share).
8. One DiT-B training step at batch 4, card (kernels) against CPU (plain
   versions), same weights and draws: the L1 loss's terms (loss, l1, vb),
   then the MSE loss and every parameter gradient, and the card's launch
   counts (rows 2 and 8 twice a block under remat, rows 3 and 4 once).
9. The int8 weight-only kernels (`[quant]`): the adaLN projection
   (int8_matmul), the qkv projection with LayerNorm and modulation folded
   in (int8_modulated_matmul), the out projection with gate and residual
   (int8_out_residual, o in bf16) and the int8 fused MLP (adaln_mlp_quant), against
   their plain versions with the same bf16 operands and int8 codes and
   against the f32 dequantised ones, at the DiT-B sampling shapes and ragged
   ones (M = 1000 for the qkv projection; 1 to 256 rows and the DiT-XL
   shape for the adaLN projection), with the same bits on a second call;
   each timed beside the cuBLAS bf16 product of its shape. The adaLN
   projection runs the body `quant.adaln_plan` names (its skinny body at
   few rows, the int8 GEMM on wide batches; required), timed warm (back to
   back) and cold (rotating over more weight copies than L2 holds). The
   qkv and out projections and the MLP run kernel B's Hopper body over int8
   codes (body sm90 required): their kernels are timed alone (modulate and
   GEMM; modulate, up and down), the ten int8 GEMM builds' and the four
   skinny builds' registers and spills printed (0 spill bytes required), and
   torch._weight_int8pack_mm is probed for the adaLN, qkv and out products
   (`library_ms` where it runs on CUDA).
10. The sample CLI with --quantize-weights (`[slice-int8]`), as in 5: every
   int8 kernel and banded attention launched steps x depth times, the f32
   MLP kernel never, and no f32 o cast to bf16 before the out projection;
   seconds per denoise step beside the f32 run's, and a profile
   (`[profile-int8]`: the device time of rows 1 and 10-13's kernels by
   name; `[profile]` gives rows 1 and 7's). Then one int8 DiT-B forward card against CPU (`[forward-int8]`)
   and its gap to the f32 forward on the card (the quantisation error,
   printed, not checked).
11. The fused MLP backward's two kernels (`[mlp-bwd]`): prologue and
   epilogue against their plain versions (bf16 operands, and f32) at the
   DiT-B training shape and ragged ones (T = 50 with N = 3, the DiT-S
   width, the DiT-L width at T = 757, the f32 stream), every output, with
   the body each stream's calls took (bf16: the Hopper body, f32: the WMMA
   body) and the same bits on a second call; the registers, spill bytes
   (required 0) and shared memory of the Hopper body's kernels; times
   beside bounds, plain versions and the cuBLAS product of each stage's
   shape, and the Hopper body's four kernels alone (the dmlp pass, the
   dgelu GEMM, the dh1 GEMM, the row pass); the whole fused backward
   against the plain one at the same inputs, in turns.
12. The train CLI with --mlp-bwd fused (`[train-fused]`), as in 7 without
   the checkpoint: each backward kernel launched steps x depth times;
   seconds per step, busy share, top ops and the backward kernels' device
   time per step beside the default run's (whose count of both backward
   kernels must stay 0). Then train_nodist_torch.py
   with --embed-only-epochs 1 resumed from the default run's checkpoint for
   3 steps (`[train-modes]`: only the label table moves), and one DiT-B
   step card vs CPU with the fused backward (`[step-fused]`).
13. Context parallelism. The four ranged entries (`[attn-cp]`) against their
   plain versions (bf16 operands, and f32): the CP training shard (q/k/v
   (32, 12, 512, 64) bf16: seq-len 512 over 2 ranks, halo 128) at the left-
   and the right-edge bounds, the sampling shard (kimi T 757 -> 768 over 2
   ranks, T_ext 640, f32), and ragged cases; each timed beside its bound
   (the bytes of the rows the function needs: q, o, lse and do on the
   shard's own rows, k and v on the keys they reach), its plain version
   and SDPA with the band-and-bounds mask on the shard's own query rows.
   Then two gloo ranks share the card (this script again, with --cp-rank,
   in torchrun's environment): one DiT-B forward_with_cfg at the kimi
   inputs against the one-device forward and a CP sampling chain
   (`[forward-cp]`: the chain's gap to one device within
   CP_CHAIN_FLOOR_MULTIPLE of its noise floor, the one-device chain
   against itself with the plain bf16 rows 1 and 7), context_parallel_banded_attention's output and
   gradients through the halo exchange against the one-device kernels in
   the f32 and the bf16 stream (`[attn-cp-exchange]`), one DiT-B CP
   training step against the one-device step (`[step-cp]`), and the
   train CLI with --num-model 2 --context-parallel --dist gloo beside a
   one-process run of the same seed (`[train-cp]`: losses, launch counts on
   every rank, seconds per optimizer step). Every rank must exit 0.
14. The serving paths beyond the main chain, at DiT-B on kimi (after 6),
   every launch count checked: the sample CLI with --sampling-method ddim
   (`[slice-ddim]`) and --compute-dtype bf16 (`[slice-bf16]`: its device
   time by kernel, one bf16 forward on the card within BF16_FORWARD_TOL of
   the CPU's f32 one, rows 1 and 7 on bf16 inputs at the sampling shape
   against their plain versions), each reparsed and timed in turns with the
   f32 chain (`[serving]`); an in-painted chain whose known rows end at
   known_x (`[inpaint]`); the Δ-cache on the f32 and the int8 model
   (`[slice-accel]`, `[slice-accel-int8]`: the CLI at interval 2 with
   launches full x depth + skipped x (depth - 8), tau 0 bit-equal to the
   exact chain with STEPS full steps, one forward recorded then applied at the
   same input (record: the full forward's bits and block 2's input left as
   it was; apply: the full forward within DELTA_APPLY_REL_TOL), then
   interval 1 and ACCEL_INTERVALS and a tau on both drift modes (taken
   from a cuda_graph=False record of one-step drifts): launches, device
   time, the gap to the exact chain; each adaptive chain graphed against
   its eager form bit for bit with the same full steps; s per step in turns
   with the busy share, the graphed adaptive chains against their eager
   forms, the exact chain, tau 0 (graphed and eager) and the fixed
   interval with the nearest count of full steps); the refine pass (`[refine]`: a second .osu, 10 x
   depth more launches). `[serving]` prints these phases' wall time.
15. The in-paint accuracy protocol (`[toy]`, evals/toy.py's main) at DiT-B on
   the stream suite: 100 predictions a fixture, the null class, no CFG,
   seq_len and band 128, TOY_STEPS sampling steps (the protocol's 1000, cut), f32
   and then --quantize-weights: launches by the schedule (rows 1 and 7, or
   rows 1 and 10-13, steps x depth x fixtures), row 13 on its wide body at
   100 rows, every pinned row exactly its known_x, every prediction finite;
   the accuracy (random weights: not a gate), s per fixture, one fixture's
   device ms per step and busy share (torch.profiler). Then main --generate
   on one fixture, whose printed lines must parse as hit objects.
16. Pattern repair (`[unfuck]`, evals/unfuck.py's main) at DiT-B on the
   geometry suite: 100 predictions, 5 px, 10 t = 0 steps (the protocol's
   1000, cut): rows 1 and 7 by the schedule, the rows outside each span
   equal to their input bit for bit, both distances finite.
17. The toy learning run (`[longrun]`, tools/longrun_toy.py in a child
   process: this script with --longrun-child) at DiT-S, batch 64, seq-len
   128, --pad-rows 160: two chunks of 10 steps, the second resumed from the
   first's checkpoint, an eval round of 10 predictions and 10 sampling steps
   on one suite after each (cuts); two JSON lines, and the launches counted
   in the child: the training rows 2, 3, 4 and 8 and the eval's rows 1 and 7
   by the schedule. Each of 15-17 prints its wall time.
18. DiT-XL serving (hidden 1152, 28 blocks, 16 heads of 72). After 9, the
   kernels at XL's shapes against their plain versions at the unchanged
   tolerances: rows 1 and 5 without LSE at head dim 72, f32 and bf16 q/k/v,
   o in bf16 too, with their five builds' registers and spills (0
   required) and the main shape's time beside its bound and SDPA
   (`[attn-xl]`); row 7 at D 1152 (`[mlp-xl]`) and rows 10-13 (`[quant-xl]`),
   each with its time, bound and library time. After 10, the sample CLI at
   --model DiT-XL on kimi from a seeded random checkpoint, XL_STEPS steps, f32 and
   --quantize-weights (`[slice-xl]`, `[slice-xl-int8]`: 28 x steps
   launches of each path kernel, the .osu reparsed, s per step, device ms
   a step, busy share); one XL forward of each stream against the same
   forward with every kernel's plain version patched in on the card
   (`[xl-forward]`, `[xl-bf16-forward]`, `[xl-int8-forward]`).
19. DiT-XL training. After 18's kernels, rows 2-4 at head dim 72
   (`[attn-train-xl]`: q/k/v (256, 16, 128, 72) in both streams, a ragged
   T in both, three 128-row blocks; the registers, spills and shared
   memory of the Dh 72 dq and dk/dv builds, Hopper and WMMA; times beside
   bounds, the plain versions and SDPA without and with the band as a
   mask) and row 8 at D 1152 (`[mlp-train-xl]`: x (256, 128, 1152) in
   both streams and a ragged T), at `[attn-train]`'s and `[mlp-train]`'s
   tolerances. After 18's forwards: one training step card against CPU at
   XL's widths with the depth cut to XL_STEP_DEPTH (`[xl-train-step]`, 8's
   checks and tolerances), then the train CLI at --model DiT-XL and its
   defaults for XL_TRAIN_STEPS steps (`[xl-train]`: finite losses, per
   optimizer step 56 launches of rows 2 and 8 and 28 of rows 3 and 4, s
   per step, busy share, peak device memory) and with --mlp-bwd fused
   (`[xl-train-fused]`: also 28 launches of rows 9a and 9b a step and no
   plain MLP backward), one run each, and one
   --no-use-bf16 step of each (dq, dk/dv and rows 9a/9b on their WMMA
   bodies).
20. DiT-XL under context parallelism and with the fused MLP backward.
   After 19's kernels, rows 5 (with LSE) and 6 at head dim 72
   (`[attn-cp-xl]`: the XL CP training shard's two edges and a tail inside
   a shard, both streams; the registers, spills (0 required) and shared
   memory of the ranged Dh 72 builds, Hopper and WMMA; the left edge's
   times beside bounds, plain versions and SDPA with the band-and-bounds
   mask) and rows 9a/9b at D 1152 (`[mlp-bwd-xl]`: x (256, 128, 1152) in
   both streams and a ragged T in both; the WMMA builds at D 1152 and the
   Hopper ones, 0 spills required; times beside bounds, plain versions and
   the cuBLAS product of each stage's shape, the Hopper body's kernels
   alone, the whole fused MLP backward against the plain one in turns), at
   `[attn-cp]`'s and `[mlp-bwd]`'s tolerances. After 19's train CLI runs,
   the train CLI at --model DiT-XL --num-model 2 --context-parallel --dist
   gloo --mlp-bwd fused on two ranks sharing the card beside one process
   of the same seed (`[xl-train-cp]`: losses within CP_LOSS_REL_TOL, the
   ranged entries' and rows 8 and 9a/9b's launch counts on every rank, s
   per step, each rank's peak device memory).
21. Tensor parallelism. After 20's kernels, rows 8, 9a and 9b on one model
   rank's shard of the hidden units, H = 4D/P (`[mlp-tp]`: DiT-B at P = 2
   and 4, DiT-XL at P = 2 and 4, DiT-S and DiT-L widths, the f32 stream),
   every rank of each case, the first whole and the others with the
   rank-partial argument (no b2, residual x or residual g), against their
   plain versions at `[mlp-train]`'s and `[mlp-bwd]`'s tolerances; the
   row's sums of out, mlp, dx, dshift, dscale and dgate against the whole
   MLP half's f32 plain version; the builds' registers and spills (0
   required); at DiT-B P = 2 and DiT-XL P = 2 and 4 the times beside
   bounds, plain versions and the cuBLAS products of the shard's shape.
   After 13, the train CLI at DiT-B with --num-model 2 --dist gloo (no
   --context-parallel) on two ranks sharing the card (this script with
   --tp-rank), with the default and with --mlp-bwd fused, beside one
   process of the same seed and flags (`[train-tp]`: losses within
   CP_LOSS_REL_TOL, rows 2-4, 8 and 9a/9b launched on every rank as in one
   process, s per step, each rank's parameters and peak device memory).
22. The rest of the mesh. `[attn-cp]` and `[attn-cp-xl]` also check the
   ranged forward's bf16 o from f32 q/k/v (the int8 block's) against its
   f32 o rounded, with its builds' registers and spills (0 required).
   After 21's kernels, rows 8, 9a and 9b at the shard widths the kernels
   take only zero-padded to a multiple of 128 (`[mlp-tp-ragged]`: 192 at D
   384, 576 and 288 at D 1152, both streams, as 21 checks them, the padded
   units exactly 0; times at the padded width beside the bound at the true
   one; and `AdalnMlp` on a ragged shard with each backward). Inside 13's
   ranks, the int8 DiT-B (quantized at load) under `Sampler(cp=)`
   (`[slice-int8-cp]`: its 10-step chain within CP_CHAIN_FLOOR_MULTIPLE of
   the one-process int8 chain's noise floor, the launches of rows 5 and
   10-13 on every rank, no f32 o cast, s per step); `[train-cp]` runs over
   sharded weights (the trainer shards whenever --num-model > 1), and
   `[train-tp-cp]` adds the same CLI with --mlp-bwd fused and both
   backwards over whole weights on every rank (the replicated CP step:
   `trainer.shard_model` a no-op for those runs), beside one process:
   losses, launches on every rank, fewer parameters and less peak memory a
   rank than the replicated runs. After 21's CLI runs, DiT-L with
   --num-model 3 on three ranks sharing the card, a degree that leaves the
   MLP whole (`[train-tp-whole-mlp]`: launches, finite losses, parameters
   and peak memory a rank).
23. The bench tools (`[bench-tools]`, last): each of
   osu_diffusion_tpu_torch/tools/bench_{sample,accel,quant,train,flash}.py
   called in this process through its `main(argv)` at its smallest setting
   (BENCH_TOOL_RUNS); every rate it prints finite and positive, and the
   kernels each tool drives launched (bench_quant the four int8 kernels,
   bench_flash the LSE forward, dq and dk/dv). Its times are smoke, not
   findings: the tools give those in processes of their own.
24. The diffusion's other parameterizations at DiT-B (before 23, each
   phase's seconds printed, `[modes]` their sum): `[bpd]`, calc_bpd_loop on
   two kimi windows of 128 rows over BPD_STEPS respaced squaredcos steps,
   through rows 1 and 7 (depth x BPD_STEPS launches each), its step
   program captured and replayed, bit for bit against the same loop eager
   (cuda_graph=False; s per step in turns and the busy share of both), and
   against the same loop through their plain versions on the card with the same draws
   (BPD_REL_TOL, the t = 0 decoder NLL column on its own,
   BPD_DECODER_REL_TOL; prior_bpd bit for bit); `[train-kl]`, 8's step
   card vs CPU under create_diffusion(use_kl=True), and under
   predict_xstart on a DiT with learn_sigma=False with --mlp-bwd fused (8's
   tolerances and launch checks, rows 9a/9b too); `[sample-fixed-var]`, a
   FIXED_VAR_STEPS-step CFG chain on kimi through the Sampler on a
   learn_sigma=False DiT under sigma_small: one forward at t = 999 card vs
   CPU (FORWARD_REL_TOL), then the chain with the kernels against the plain
   versions on the card, gated at CP_CHAIN_FLOOR_MULTIPLE of the plain
   chain's gap to itself with f32 operands.
25. The Sampler's CUDA graphs (`[graph]`, after 10, f32 and int8 at DiT-B
   on kimi, T 757 -> 768, CFG 2, band 128): the ancestral, DDIM, fixed
   Δ-cache (interval GRAPH_INTERVAL), in-painted and refine chains, and
   the adaptive Δ-cache in both drift modes (tau the median of a
   cuda_graph=False chain's one-step drifts; its step a "decide" part and
   two bodies under conditional IF nodes), each on
   a graphed sampler (the default) and an eager one (`cuda_graph=False`):
   graph against eager bit for bit at T 757 and at GRAPH_SHORT_T (the same
   bucket) with the same full steps, one cache entry and one capture per
   step kind across the two lengths, each path kernel's launches equal to
   steps x depth (by the Δ-cache's schedule; the adaptive warm-up's two
   bodies once more) in the first (captured) chain and in a replayed
   one, the replayed chain under torch.cuda.set_sync_debug_mode("error")
   (no host sync but the adaptive chain's read of its full steps at the
   end), s per denoise step graph against eager in turns with
   each one's busy share (device ms by torch.profiler), the capture's ms
   and its pool's bytes. `[graph-xl]` (in 18): s per denoise step of the
   f32 DiT-XL chain, graph against eager in turns. `[attn]` and
   `[attn-xl]` hold row 1 with valid_len on the device against the int
   form bit for bit and print both times.

Every kernel is timed beside its plain version, its bound (the least time
this card could take: bytes over 3.35 TB/s or bf16 operations over
989 TFLOP/s, whichever is larger, counted from this run's inputs) and, where
one PyTorch call computes the same function, that call (`library_ms`; the
port never calls it). Then one JSON line describing the kernels, and last,
the device JSON line. Exits non-zero, printing no result, without a CUDA
device.
"""
import contextlib
import copy
import ctypes
import gc
import glob
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

from osu_diffusion_tpu_torch.utils.benchmark import cuda_ms, device_line

# max |kernel - plain| allowed. Against the plain version with the same
# bf16-rounded operands only summation order, the online softmax's rounding
# point and ulp-level LN/GELU differences remain; each of those can flip
# the bf16 rounding of an intermediate (one ulp, 2^-8 relative), which moves
# an MLP output by up to gate * ulp * |w2|. Against f32 the bf16 operand
# rounding (2^-9 relative) adds up over the dot products. An indexing or
# masking fault moves outputs by O(0.1-1).
ATTN_TOL_BF16 = 5e-3
ATTN_TOL_F32 = 3e-2
MLP_TOL_BF16 = 5e-3  # 1e-3 failed on an H100 at 1.48e-3 (x ~ N(0, 1), gate ~ N(0, 0.3))
MLP_TOL_F32 = 5e-2  # bf16 rounding over D=768 and H=3072 terms: ~1.2e-2 seen on the CPU
# The training kernels, as max |kernel - plain| / max |plain| per output.
# Against the same bf16 operands: a bf16 stream rounds every output to 2^-8
# of itself (so one flipped rounding is ~4e-3 of a max), and a flipped bf16
# rounding of P, dS or the hidden activation moves a sum by 2^-8 of a term.
# Against f32: the operand rounding over 128-3072-term sums, a few 2^-9.
TRAIN_TOL_BF16 = 1e-2
TRAIN_TOL_F32 = 5e-2
LSE_TOL = 1e-3  # absolute; f32 log-sum-exp of the same (bf16) scores
LSE_TOL_F32 = 1e-2  # absolute; against f32 scores (bf16 q.k rounding, |s| ~ 1)
# one DiT-B forward, kernels on the card vs plain bf16 versions on the CPU:
# max |diff| / max |plain output|
FORWARD_REL_TOL = 2e-2
# one DiT-B training step, card vs CPU plain versions, bf16 stream under the
# MSE loss (the L1 loss's gradient is sign(eps - noise): wherever bf16
# rounding moves a prediction across its target a whole term flips, which
# the CPU parity test measured at ~10% of a tensor's max; MSE's gradient is
# continuous). Each gradient within this share of its max, the loss within
# this relative error: bf16 rounds the stream, projections and kernel
# operands at the same points on both sides, but sums run in other orders.
# The L1 loss's terms (continuous in the prediction) are held to the same
# relative error.
STEP_GRAD_REL_TOL = 5e-2
STEP_LOSS_REL_TOL = 1e-2

# the int8 kernels, max |kernel - plain| / max |plain|. Against the same
# bf16 operands and int8 codes: f32 sums in another order, and where a
# LayerNorm or GELU comes first an ulp-level difference that flips one bf16
# rounding of an operand (2^-8 of one term). Against the f32 dequantised
# plain version: bf16 rounding of the activations (2^-9) over K-term sums.
QUANT_TOL_BF16 = 2e-3
QUANT_TOL_F32 = 1e-2

# published H100 SXM peaks (NVIDIA's data sheet): the bound of a kernel is
# the larger of its bytes over HBM_BPS and its bf16 operations over BF16_FLOPS
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12

BEATMAP = os.path.join("assets", "toy_datasets", "kimi_no_bouken.osu")
MODEL = "DiT-B"
NUM_CLASSES = 52670
STEPS = 20  # the sample CLI's denoise steps at DiT-B (its default is 250, cut)
CFG_SCALE = 2.0
BAND = 128
SEED = 0
TRAIN_BATCH = 256
TRAIN_SEQ = 128
TRAIN_STEPS = 20
TRAIN_CKPT_EVERY = 15
TRAIN_COPIES = 16  # kimi copies: ~40 windows each, >= 2 batches of 256 an epoch
# the training input path ([loader], [train-corpus]): tools/make_corpus.py's
# corpus at ~1/13 of the reference's ORS13402 (52,670 maps in 13,402 sets),
# with its layout (Track folders of 4 maps) and labels (the file names'
# integer prefixes); each map has >= 176 rows, ~4 windows of 128 at stride 16
CORPUS_MAPS = 4096
CORPUS_MAPS_PER_TRACK = 4
CORPUS_MIN_DATAPOINTS = 176
NATIVE_FIXTURE_TOL = 2e-3  # max |native - python| on the fixtures (tests/test_native.py's bound)
NATIVE_CORPUS_TOL = 2e-2  # on corpus maps (tests/test_corpus.py's bound)
CORPUS_PARITY_MAPS = 64
FEATURIZE_MAPS = 256  # maps/s of both featurizers over the first corpus maps
FEATURIZE_NATIVE_PASSES = 16
LOADER_THREADS = (2, 4)
LOADER_BATCHES = {"native": 20, "python": 5}  # timed batches; the Python loader is slow
CACHE_MAPS = 256
TRAIN_CORPUS_STEPS = 16
TRAIN_CORPUS_PROFILED = range(14, 16)  # after TIMED_STEPS
# training-kernel checks: (name, N, H, T, valid_len, band, stream), the
# DiT-B training shape first
ATTN_TRAIN_CASES = [
    ("main", 256, 12, 128, 128, 128, "bf16"),
    ("t_not_tile_multiple_band_lt_t", 2, 3, 200, 190, 20, "bf16"),
    ("valid_lt_t", 2, 12, 100, 77, 128, "bf16"),
    ("fully_masked_rows", 1, 2, 256, 60, 16, "bf16"),
    ("dit_s_heads", 4, 6, 128, 128, 128, "bf16"),
    ("three_blocks_odd_heads", 3, 5, 384, 370, 128, "bf16"),
    ("f32_stream", 4, 12, 128, 128, 128, "f32"),
]
# [attn-train-xl]: rows 2-4 at DiT-XL's head dim 72, the same way: the XL
# training shape (batch 256 x 16 heads, T = band = 128) in both streams,
# a ragged T (not a multiple of 64, valid_len < T, band < T) in both, and
# three 128-row blocks (the persistent walks over several blocks and tiles)
ATTN_TRAIN_XL_CASES = [
    ("main", 256, 16, 128, 128, 128, "bf16"),
    ("main_f32", 256, 16, 128, 128, 128, "f32"),
    ("ragged_t", 3, 5, 200, 190, 20, "bf16"),
    ("ragged_t_f32", 3, 5, 200, 190, 20, "f32"),
    ("three_blocks", 3, 5, 384, 370, 128, "bf16"),
]
# the body each stream's forward, dq and dk/dv take (`.body` of the
# wrappers): every forward entry the Hopper body in both streams; dq and
# dk/dv bf16 the Hopper body, f32 the WMMA body
FWD_BODY = {"bf16": "sm90", "f32": "sm90"}
BODY = {"bf16": "sm90", "f32": "wmma"}
# (name, N, T, D, stream)
MLP_TRAIN_CASES = [("main", 256, 128, 768, "bf16"), ("ragged_t", 3, 50, 768, "bf16"),
                   ("dit_s_width", 2, 100, 384, "bf16"), ("f32_stream", 4, 128, 768, "f32"),
                   ("dit_l_width_t757", 1, 757, 1024, "bf16")]
# [mlp-train-xl]: row 8 at DiT-XL's D 1152 (H 4608), the XL training shape
# in both streams and a ragged T
MLP_TRAIN_XL_CASES = [("main", 256, 128, 1152, "bf16"), ("main_f32", 256, 128, 1152, "f32"),
                      ("ragged_t", 3, 50, 1152, "bf16")]
# kernel B's Hopper body: its kernels' names in a profile
MLP_SM90_KERNELS = ("adaln_mlp_modulate_kernel", "adaln_mlp_gemm_kernel")
# the banded-attention forward's (row 1's, in the sampling chains)
ATTN_FWD_KERNEL = "banded_attn_fwd_sm90_kernel"
# the int8 adaLN projection's skinny body (row 13's on the sampling chain)
ADALN_SKINNY_KERNEL = "int8_matmul_skinny_kernel"
# weight copies the cold timing of row 13 rotates over: 24 x 3.54 MB at
# DiT-B, more than the H100's 50 MB L2
COLD_COPIES = 24
# the fused MLP backward's Hopper body (rows 9a/9b): its kernels' names in a
# profile (sum_partials_kernel: the five sums of partials, also the WMMA
# body's)
MLP_BWD_SM90_KERNELS = ("adaln_mlp_bwd_dmlp_kernel", "adaln_mlp_bwd_gemm_kernel",
                        "adaln_mlp_bwd_ln_kernel", "sum_partials_kernel")
# the fused MLP backward's checks: (name, N, T, D, stream), the DiT-B
# training shape first
MLP_BWD_CASES = [("main", 256, 128, 768, "bf16"), ("ragged_t_n3", 3, 50, 768, "bf16"),
                 ("dit_s_width", 2, 100, 384, "bf16"), ("dit_l_width_t757", 1, 757, 1024, "bf16"),
                 ("f32_stream", 4, 128, 768, "f32")]
# [mlp-bwd-xl]: rows 9a/9b at DiT-XL's D 1152 (H 4608): the XL training
# shape in both streams (bf16 the Hopper body, f32 the WMMA body) and a
# ragged T with N = 3 in both
MLP_BWD_XL_CASES = [("main", 256, 128, 1152, "bf16"), ("main_f32", 256, 128, 1152, "f32"),
                    ("ragged_t_n3", 3, 50, 1152, "bf16"), ("ragged_t_n3_f32", 3, 50, 1152, "f32")]
# [mlp-tp]: rows 8, 9a and 9b on one tensor-parallel rank's hidden units,
# H = 4D/P: (name, N, T, D, P, stream); the main_* cases (the training
# shape at DiT-B P = 2 and DiT-XL P = 2 and 4) are timed
MLP_TP_CASES = [("main_b_p2", 256, 128, 768, 2, "bf16"), ("main_xl_p2", 256, 128, 1152, 2, "bf16"),
                ("main_xl_p4", 256, 128, 1152, 4, "bf16"), ("b_p4_ragged_t", 3, 50, 768, 4, "bf16"),
                ("s_p4", 2, 100, 384, 4, "bf16"), ("l_p2_t757", 1, 757, 1024, 2, "bf16"),
                ("b_p2_f32", 4, 128, 768, 2, "f32")]
# [mlp-tp-ragged]: the shard widths the kernels take only zero-padded to a
# multiple of 128 (ops/adaln_mlp.py `pad_hidden`): 192 (DiT-S over 8
# ranks), 576 and 288 (DiT-XL over 8 and 16), in both streams; the main_*
# cases timed at the padded width beside the bound at the true one
MLP_TP_RAGGED_CASES = [("main_s_p8", 256, 128, 384, 8, "bf16"), ("main_xl_p8", 256, 128, 1152, 8, "bf16"),
                       ("main_xl_p16", 256, 128, 1152, 16, "bf16"), ("s_p8_f32", 4, 128, 384, 8, "f32"),
                       ("xl_p8_f32", 4, 128, 1152, 8, "f32"), ("xl_p16_f32_ragged_t", 3, 50, 1152, 16, "f32")]
# [train-tp]: the train CLI at DiT-B, --num-model TP_RANKS without
# --context-parallel, two gloo ranks sharing the card
TP_RANKS = 2
TP_BATCH = 32
TP_STEPS = 5
# [train-tp-whole-mlp]: DiT-L over 3 ranks (4096 hidden units do not split
# over 3: the MLP stays whole, the block heads split)
TP_WHOLE_MLP_MODEL = "DiT-L"
TP_WHOLE_MLP_RANKS = 3
TP_WHOLE_MLP_STEPS = 2
# context parallelism: two ranks share the card over gloo (NCCL refuses two
# ranks on one device), so its times say nothing of NCCL across cards
CP_RANKS = 2
CP_SEQ = 512  # the CP training window: two shards of 256
CP_BATCH = 32
CP_STEPS = 3  # timed from the second step
CP_SAMPLE_STEPS = 10
CP_TIMEOUT = 600  # seconds for the ranks' run (the process group's own timeout is 5 minutes)
# the CP train run against the one-process run, relative difference of each
# logged loss: the two differ only in rounding order (the halo rows' dk/dv
# are two bf16 partial sums, the projections run at another row count, the
# gradients are summed over two ranks), ~2^-8 of a term where it shows;
# the default and fused MLP backward runs, which differ the same way,
# agreed within 3e-4 over 20 steps
CP_LOSS_REL_TOL = 1e-2
# [step-cp] and [forward-cp], CP on two ranks against one device on the
# card: each gradient and the output within this share of its max, the
# loss within this relative error (the same kernels on the same bf16
# operands; only the halo's partial sums and the summation order differ)
CP_REL_TOL = 1e-2
# [forward-cp]'s CP_SAMPLE_STEPS-step chain against the one-device chain:
# its gap's max and median within this multiple of the noise floor's, the
# gap between the one-device chain with the kernels and the same chain with
# the plain bf16 versions of rows 1 and 7 (two correct chains; at t near T
# the x0 prediction amplifies the forwards' rounding differences before
# the clamp). On an H100 the CP gap was 1.08x (max) and 1.01x (median) the
# floor; a fault in the ranged kernels or the halo exchange moves the
# median by O(0.1-1).
CP_CHAIN_FLOOR_MULTIPLE = 3.0
# [attn-cp-exchange]: context_parallel_banded_attention on CP_RANKS ranks
# against the one-device banded_attention, forward and backward through the
# halo exchange, each in the f32 and the bf16 stream: (name, N, T, valid_len)
# at H 12, Dh 64, band BAND; the CP training shard and the sampling tail
CP_EXCHANGE_CASES = [("train_shard", 32, CP_SEQ, None), ("sample_tail", 2, 768, 757)]
# its tolerance, of max, per stream: f32 as CP_REL_TOL; in bf16 a halo row's
# dk/dv is rounded three times (each rank's partial, then their sum) where
# one device rounds once, each rounding up to 2^-8 of the value: <= 1.6e-2
CP_EXCHANGE_TOL = {"f32": CP_REL_TOL, "bf16": 2e-2}
# the ranged checks: (name, N, H, T_loc, band, shard index, shards,
# valid_len, stream); the CP training shard's two edges and the sampling
# shards first
ATTN_CP_CASES = [
    ("train_left_edge", 32, 12, 256, 128, 0, 2, None, "bf16"),
    ("train_right_edge", 32, 12, 256, 128, 1, 2, None, "bf16"),
    ("sample_shard0", 2, 12, 384, 128, 0, 2, 757, "f32"),
    ("sample_shard1_tail", 2, 12, 384, 128, 1, 2, 757, "f32"),
    ("interior", 2, 3, 256, 96, 1, 3, None, "bf16"),
    ("band48", 2, 3, 128, 48, 0, 2, None, "bf16"),
    ("band160_halo256", 2, 3, 256, 160, 1, 3, None, "bf16"),
    ("tail_inside_shard", 2, 3, 256, 96, 1, 2, 380, "bf16"),
    ("f32_stream", 4, 12, 256, 128, 0, 2, None, "f32"),
]
# [attn-cp-xl]: rows 5 (with LSE) and 6 at DiT-XL's head dim 72, the same
# way: the XL CP training shard (batch 32 x 16 heads, seq-len 512 over 2
# ranks, band 128) at its two edges in both streams, and a tail inside a
# shard (band 96) in both
ATTN_CP_XL_CASES = [
    ("train_left_edge", 32, 16, 256, 128, 0, 2, None, "bf16"),
    ("train_right_edge", 32, 16, 256, 128, 1, 2, None, "bf16"),
    ("train_left_edge_f32", 32, 16, 256, 128, 0, 2, None, "f32"),
    ("train_right_edge_f32", 32, 16, 256, 128, 1, 2, None, "f32"),
    ("tail_inside_shard", 2, 3, 256, 96, 1, 2, 380, "bf16"),
    ("tail_inside_shard_f32", 2, 3, 256, 96, 1, 2, 380, "f32"),
]
# the serving paths (14): the Δ-cache span at DiT-B, (depth // 6, depth -
# depth // 6); a skipped step runs the blocks outside it
ACCEL_SPAN = (2, 10)
# the sweep's fixed interval, and the quantile of the exact chain's
# one-step drifts taken as its tau (so it lands where the chain can skip,
# whatever the weights); one of each keeps the script inside its time limit
ACCEL_INTERVALS = (2,)
ACCEL_TAU_QUANTILES = (0.9,)
# [slice-bf16]: a bf16-stream DiT-B forward on the card against the CPU's
# f32-stream forward, max |diff| (the JAX package's bf16 test holds its
# bf16 forward to f32 at this atol)
BF16_FORWARD_TOL = 0.03
# [inpaint]: known rows against known_x (the last step's mean is its x0
# there, which the in-painting pinned; f32 coefficients near 1)
INPAINT_TOL = 1e-5
# the Δ applied to the input it was recorded at against the full forward:
# they differ by the f32 rounding of before + (after - before) at block hi,
# which flips a few bf16 roundings in the kernels of the blocks after the
# span (~5e-4 of max |out| at DiT-B on an H100, ~1e-7 in the plain f32
# versions); a Δ at the wrong block, a lost residual or a snapshot written
# in place moves the output by the span's whole contribution (~0.4)
DELTA_APPLY_REL_TOL = 1e-3
REFINE_ITERS = 10
TIMED_STEPS = range(3, 14)  # steady-state steps (0-based calls) timed by CUDA events
PROFILED_STEPS = range(15, 18)  # steps traced by torch.profiler
# the evals (15-17), at the protocols' widths with their step counts cut:
# [toy] the in-paint accuracy protocol (100 predictions, the null class, no
# CFG, seq_len and band 128) on one suite, f32 and int8; [unfuck] pattern
# repair (100 predictions, 5 px) on one suite; [longrun] the toy learning
# run at DiT-S in a child process, two chunks and an eval round after each
TOY_SUITE = "stream"
TOY_PREDICTIONS = 100
TOY_STEPS = 10  # the protocol's 1000, cut
TOY_SEQ = 128
UNFUCK_SUITE = "geometry"
UNFUCK_STEPS = 10  # the protocol's 1000 t = 0 steps, cut
UNFUCK_MAGNITUDE = 5.0
LONGRUN_MODEL = "DiT-S"
LONGRUN_CHUNK = 10  # steps a chunk, two chunks
LONGRUN_PREDICTIONS = 10  # the protocol's 100, cut
LONGRUN_SAMPLING_STEPS = 10  # the protocol's 1000, cut
LONGRUN_SUITE = "stream"
LONGRUN_TIMEOUT = 600  # seconds for the child


def host_us(fn, iters=50):
    """Mean host microseconds per call of fn() back to back, without
    waiting for the card (the launch path's Python and enqueue cost)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - start) / iters * 1e6
    torch.cuda.synchronize()
    return us


def check(ok, msg) -> None:
    """A failed check fails the run (unlike assert, kept under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def rel_err(a, b):
    """max |a - b| / max |b|."""
    return max_err(a, b) / max(b.float().abs().max().item(), 1e-30)


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    bf16 operations over the tensor-core rate, whichever is larger."""
    mem_ms, ops_ms = n_bytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(mem_ms, ops_ms), "bound_by": "bytes" if mem_ms >= ops_ms else "operations"}


def nbytes(*tensors) -> int:
    return sum(a.numel() * a.element_size() for a in tensors)


def attention_pairs(t, band, valid, query_valid=False) -> int:
    """(query, key) pairs the banded attention computes at these inputs, per
    (batch, head): keys in the band and below valid_len (and, in the
    backward, queries below valid_len too)."""
    import torch
    from osu_diffusion_tpu_torch.ops.banded_attention import banded_attention_mask

    keep = torch.arange(t) < valid
    allowed = banded_attention_mask(t, band) & keep[None, :]
    if query_valid:
        allowed &= keep[:, None]
    return int(allowed.sum())


def phase_build():
    import torch
    from osu_diffusion_tpu_torch import native
    from osu_diffusion_tpu_torch.ops import cuda_build

    card = device_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    driver_api = ctypes.c_int()
    ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(driver_api))
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-2]
    print(f"[build] CUDA runtime {torch.version.cuda} (torch's), driver {driver} (CUDA "
          f"{driver_api.value // 1000}.{driver_api.value % 1000 // 10}), nvcc: {nvcc}; the adaptive "
          f"chain's IF nodes need 12.4 or later")
    names = ("banded_attention", "banded_attention_bwd", "adaln_mlp", "adaln_mlp_bwd", "int8_matmul",
             "graph_cond")
    wall = time.perf_counter()
    cuda_build.build_all(names)  # one nvcc per source, all at once
    print(f"[build] {len(names)} libraries in {time.perf_counter() - wall:.1f} s wall")
    for name in names:
        info = cuda_build.build_info[name]
        print(f"[build] {name}: {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    # the native featurizer, before any phase's trainer or loader builds it
    check(native.available(), "no g++ on PATH: the native featurizer is not built")
    print(f"[build] osu_native ({native.build_info['compiler']}): {native.build_info['seconds']:.1f} s")
    return card


# the Hopper attention builds: the forward's six (q/k/v type, o type; bf16
# o from f32 q/k/v for the int8 block, unranged and ranged) at Dh 64 and at
# Dh 72 (DiT-XL), and dq's and dk/dv's two, each unranged and ranged, at Dh
# 64 and 72
SM90_FWD_BUILDS = ("fwd bf16", "fwd f32", "fwd f32->bf16", "ranged fwd bf16", "ranged fwd f32",
                   "ranged fwd f32->bf16")
SM90_FWD_XL_BUILDS = tuple(f"{name} dh72" for name in SM90_FWD_BUILDS)
SM90_BWD_XL_BUILDS = ("dq dh72", "dkv dh72")
SM90_BWD_CP_XL_BUILDS = ("ranged dq dh72", "ranged dkv dh72")
SM90_ATTN_BUILDS = (SM90_FWD_BUILDS + SM90_FWD_XL_BUILDS + ("dq", "ranged dq", "dkv", "ranged dkv")
                    + SM90_BWD_XL_BUILDS + SM90_BWD_CP_XL_BUILDS)


def attn_build_name(entry: str, kernel: str, key: str) -> str:
    """The SM90_ATTN_BUILDS name of a mangled Hopper attention kernel:
    <RANGED[, q/k/v type, o type], head dim> for the forward, <RANGED, head
    dim> for dq and dk/dv."""
    name = ("ranged " if f"{kernel}ILb1E" in entry else "") + key
    if key != "fwd":
        return name + (" dh72" if "Li72E" in entry.split(kernel, 1)[1] else "")
    types = entry.split(f"{kernel}ILb", 1)[1][2:]  # past the flag and its E
    dh = " dh72" if "Li72E" in types else ""
    if types.startswith("ff"):
        return name + " f32" + dh
    return name + (" f32->bf16" if types.startswith("f13__nv_bfloat16") else " bf16") + dh


def sm90_resources() -> dict:
    """Registers, spill bytes (stores + loads) and dynamic shared memory per
    CTA of the Hopper attention builds (SM90_ATTN_BUILDS), from this build's
    ptxas lines (cuda_build.build_info) and the libraries."""
    from osu_diffusion_tpu_torch.ops import banded_attention as ba
    from osu_diffusion_tpu_torch.ops import cuda_build

    smem = ba.sm90_smem_bytes()
    found = {}
    for lib, kernel, key in (("banded_attention", "banded_attn_fwd_sm90_kernel", "fwd"),
                             ("banded_attention_bwd", "banded_attn_bwd_dq_sm90_kernel", "dq"),
                             ("banded_attention_bwd", "banded_attn_bwd_dkv_sm90_kernel", "dkv")):
        entry = None
        for line in cuda_build.build_info[lib]["log"].splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
                continue
            if entry is None or kernel not in entry:
                continue
            name = attn_build_name(entry, kernel, key)
            smem_key = key
            if key == "fwd":  # the f32 staging buffer
                smem_key += " f32" * (" f32" in name)
            smem_key += " dh72" * name.endswith("dh72")  # Dh 72's second slabs
            res = found.setdefault(name, {"smem_bytes": smem[smem_key]})
            if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
                res["spill_bytes"] = int(m[1]) + int(m[2])
            if (m := re.search(r"Used (\d+) registers", line)):
                res["registers"] = int(m[1])
    check(set(found) == set(SM90_ATTN_BUILDS) and all(len(r) == 3 for r in found.values()),
          f"ptxas lines of the {len(SM90_ATTN_BUILDS)} Hopper attention builds not found: {found}")
    check(all(r["spill_bytes"] == 0 for r in found.values()), f"Hopper attention bodies spill: {found}")
    return found


def wmma_resources() -> dict:
    """Registers, spill bytes and dynamic shared memory per CTA of the f32
    stream's WMMA dq and dk/dv builds ("wmma dq", "wmma ranged dkv", ...
    " dh72" at Dh 72), from this build's ptxas lines and the library."""
    from osu_diffusion_tpu_torch.ops import banded_attention as ba
    from osu_diffusion_tpu_torch.ops import cuda_build

    smem = ba.wmma_smem_bytes()
    found = {}
    entry = None
    for line in cuda_build.build_info["banded_attention_bwd"]["log"].splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        kernel = next((k for k in ("dq", "dkv") if entry and f"banded_attn_bwd_{k}_kernelI" in entry), None)
        if kernel is None:
            continue
        args = entry.split(f"banded_attn_bwd_{kernel}_kernelI", 1)[1]
        dh = " dh72" if "Li72E" in args else ""
        name = f"wmma {'ranged ' * ('Lb1E' in args)}{kernel}{dh}"
        res = found.setdefault(name, {"smem_bytes": smem[f"wmma {kernel}{dh}"]})
        if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            res["spill_bytes"] = int(m[1]) + int(m[2])
        if (m := re.search(r"Used (\d+) registers", line)):
            res["registers"] = int(m[1])
    return found


def print_sm90_resources(tag, names) -> None:
    res = sm90_resources()
    print(f"[{tag}] Hopper bodies (ptxas): " + "; ".join(
        f"{n} {res[n]['registers']} registers, {res[n]['spill_bytes']} spill bytes, "
        f"{res[n]['smem_bytes']} B shared memory a CTA" for n in names))


def phase_attention(dev):
    """Row 1: the inference forward on f32 q/k/v (the sampling stream)
    against its plain versions, its body (sm90) and the same bits on a
    second call in every case; o in bf16 (the int8 block's) equal to the
    rounded f32 o; valid_len as a device operand (a 0-d int32 tensor, read
    by the kernel: the Sampler's CUDA graphs pass it so) giving the int
    form's bits, f32 and bf16 o; at the main shape its times (f32 and bf16
    o, the int and the device valid_len) beside the bound, the plain
    versions and SDPA."""
    import torch
    import torch.nn.functional as F
    from osu_diffusion_tpu_torch.ops.banded_attention import (
        banded_attention,
        banded_attention_mask,
        banded_attention_reference,
    )

    g = torch.Generator(device=dev).manual_seed(1)
    print_sm90_resources("attn", ("fwd f32", "fwd f32->bf16"))
    # (name, N, H, T, valid_len, band): the DiT-B main-path shape first
    cases = [
        ("main", 2, 12, 768, 757, BAND),
        ("band_not_tile_multiple", 1, 3, 200, 190, 20),
        ("t_below_band", 2, 2, 50, 50, 128),
        ("fully_masked_rows", 1, 2, 256, 60, 16),
    ]
    result = None
    for name, n, h, t, valid, band in cases:
        # head views of a packed qkv projection, as the model passes them
        qkv = torch.randn((n, t, 3 * h * 64), generator=g, device=dev)
        q, k, v = (a.view(n, t, h, 64).transpose(1, 2) for a in qkv.split(h * 64, dim=-1))
        got = banded_attention(q, k, v, band, valid)
        torch.cuda.synchronize()
        body = banded_attention.body
        same = torch.equal(banded_attention(q, k, v, band, valid), got)
        # o in bf16 from the same f32 q/k/v: the f32 o, rounded
        got16 = banded_attention(q, k, v, band, valid, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        rounded = got16.dtype == torch.bfloat16 and torch.equal(got16, got.to(torch.bfloat16))
        body16 = banded_attention.body
        ref16 = banded_attention_reference(q, k, v, band, valid, torch.bfloat16)
        ref32 = banded_attention_reference(q, k, v, band, valid, torch.float32)
        e16, e32 = max_err(got, ref16), max_err(got, ref32)
        finite = bool(torch.isfinite(got).all())
        valid_dev = torch.tensor(valid, dtype=torch.int32, device=dev)
        launches = banded_attention.launches
        same_dev = (torch.equal(banded_attention(q, k, v, band, valid_dev), got)
                    and torch.equal(banded_attention(q, k, v, band, valid_dev, out_dtype=torch.bfloat16), got16))
        launched = banded_attention.launches - launches
        print(f"[attn] {name}: N={n} H={h} T={t} valid={valid} band={band} body {body} "
              f"(bf16 o: {body16}) max_abs_err bf16={e16:.3e} (tol {ATTN_TOL_BF16}) "
              f"f32={e32:.3e} (tol {ATTN_TOL_F32}) finite={finite}; same bits on a second call: "
              f"{same}; bf16 o is the rounded f32 o: {rounded}; valid_len on the device gives the int "
              f"form's bits (f32 and bf16 o): {same_dev}")
        check(same_dev and launched == 2, f"attention {name}: device valid_len bits {same_dev}, "
              f"{launched} launches")
        check(body == body16 == "sm90", f"attention {name}: bodies {body}, {body16}, expected sm90")
        check(same, f"attention {name}: a second call gave other bits")
        check(rounded, f"attention {name}: bf16 o is not the rounded f32 o")
        check(finite, f"attention {name}: non-finite output")
        check(e16 <= ATTN_TOL_BF16, f"attention {name}: {e16} > {ATTN_TOL_BF16}")
        check(e32 <= ATTN_TOL_F32, f"attention {name}: {e32} > {ATTN_TOL_F32}")
        if name == "fully_masked_rows":
            # rows whose band holds no valid key (q >= valid + band) are 0
            check(bool((got[:, :, valid + band:] == 0).all()), "masked rows not 0")
        if name == "main":
            ms = cuda_ms(lambda: banded_attention(q, k, v, band, valid))
            ms16 = cuda_ms(lambda: banded_attention(q, k, v, band, valid, out_dtype=torch.bfloat16))
            ms_dev = cuda_ms(lambda: banded_attention(q, k, v, band, valid_dev))
            ms16_dev = cuda_ms(lambda: banded_attention(q, k, v, band, valid_dev, out_dtype=torch.bfloat16))
            plain_ms = cuda_ms(lambda: banded_attention_reference(q, k, v, band, valid, torch.float32))
            plain16_ms = cuda_ms(lambda: banded_attention_reference(q, k, v, band, valid, torch.bfloat16))
            # yardstick: SDPA with the band and the valid keys as a boolean mask
            mask = banded_attention_mask(t, band, dev) & (torch.arange(t, device=dev) < valid)[None, :]
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
            flops = 4 * 64 * n * h * attention_pairs(t, band, valid)
            b = bound(nbytes(q, k, v, got), flops)
            b16 = bound(nbytes(q, k, v, got16), flops)
            print(f"[attn] main: valid_len an int {ms:.4f} ms (bf16 o {ms16:.4f} ms), on the device "
                  f"{ms_dev:.4f} ms (bf16 o {ms16_dev:.4f} ms)")
            print(f"[attn] main: kernel {ms:.4f} ms (bf16 o {ms16:.4f} ms), plain f32 {plain_ms:.4f} ms, "
                  f"plain bf16-rounded {plain16_ms:.4f} ms, SDPA (masked) {library_ms:.4f} ms, "
                  f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; bf16 o {b16['bound_ms']:.4f} ms)")
            result = {"max_abs_err": e16, "ms": ms, "plain_ms": plain_ms, **b,
                      "library_ms": library_ms}
    return result


# [attn-xl]: row 1 at DiT-XL's head dim (1152 / 16 heads = 72): (name, N,
# H, T, valid_len, band), the XL sampling shape first, then [attn]'s edge
# cases; and row 5 without LSE on the XL sampling shard (T 757 -> 768 over
# 2 ranks, halo 128: T_ext 640), each shard
XL_HEAD_DIM = 72
ATTN_XL_CASES = [("main", 2, 16, 768, 757, BAND), ("band_not_tile_multiple", 1, 3, 200, 190, 20),
                 ("t_below_band", 2, 2, 50, 50, 128), ("fully_masked_rows", 1, 2, 256, 60, 16)]
ATTN_XL_CP_SHARDS = 2


def head_views(qkv, n, t, h, dh):
    """q, k, v as head views (N, H, T, Dh) of a packed (N, T, 3 H Dh)
    projection, as the model passes them."""
    return tuple(a.view(n, t, h, dh).transpose(1, 2) for a in qkv.split(h * dh, dim=-1))


def phase_attention_xl(dev):
    """[attn-xl]: rows 1 and 5 (no LSE) at Dh 72 against their plain
    versions, f32 and bf16 q/k/v, o in q's type and (f32 q/k/v) in bf16;
    the body (sm90) and the same bits on a second call in every case, and
    with valid_len a device operand (row 1); the five Dh 72 builds'
    registers and spills (0 required); at the XL sampling shape the time
    (row 1 also with the device valid_len) beside the bound (4 x 72 FLOP a pair), the
    plain versions and SDPA with the band mask. Returns row 1's and row 5's
    numbers at their main shapes."""
    import types

    import torch
    import torch.nn.functional as F
    from osu_diffusion_tpu_torch.ops import banded_attention as ba
    from osu_diffusion_tpu_torch.parallel.context import BLOCK, shard_bounds

    g = torch.Generator(device=dev).manual_seed(11)
    bf16, f32, dh = torch.bfloat16, torch.float32, XL_HEAD_DIM
    print_sm90_resources("attn-xl", SM90_FWD_XL_BUILDS)
    results = {}
    for name, n, h, t, valid, band in ATTN_XL_CASES:
        qkv = torch.randn((n, t, 3 * h * dh), generator=g, device=dev)
        for stream in ("f32", "bf16"):
            q, k, v = head_views(qkv if stream == "f32" else qkv.to(bf16), n, t, h, dh)
            got = ba.banded_attention(q, k, v, band, valid)
            torch.cuda.synchronize()
            body = ba.banded_attention.body
            same = torch.equal(ba.banded_attention(q, k, v, band, valid), got)
            valid_dev = torch.tensor(valid, dtype=torch.int32, device=dev)
            same_dev = torch.equal(ba.banded_attention(q, k, v, band, valid_dev), got)
            check(same_dev, f"attn-xl {name} {stream}: device valid_len gave other bits")
            ref16 = ba.banded_attention_reference(q, k, v, band, valid, bf16)
            ref32 = ba.banded_attention_reference(q, k, v, band, valid, f32)
            finite = bool(torch.isfinite(got).all())
            extra = f"; valid_len on the device gives the int form's bits: {same_dev}"
            if stream == "f32":
                # o in bf16 from the same f32 q/k/v: the f32 o, rounded
                got16 = ba.banded_attention(q, k, v, band, valid, out_dtype=bf16)
                torch.cuda.synchronize()
                rounded = got16.dtype == bf16 and torch.equal(got16, got.to(bf16))
                if not rounded:
                    diff = (got16.float() - got.to(bf16).float()).abs()
                    where = diff.nonzero()
                    print(f"[attn-xl] {name}: bf16 o differs from the rounded f32 o at {len(where)} of "
                          f"{diff.numel()} elements, max {diff.max().item():.3e}; columns "
                          f"{sorted(set(where[:, 3].tolist()))[:20]}, rows {sorted(set(where[:, 2].tolist()))[:20]}; "
                          f"bf16 o against the plain bf16 version {max_err(got16, ref16):.3e}; same bits "
                          f"on a second call {torch.equal(got16, ba.banded_attention(q, k, v, band, valid, out_dtype=bf16))}")
                check(ba.banded_attention.body == "sm90", f"attn-xl {name}: bf16 o body {ba.banded_attention.body}")
                check(rounded, f"attn-xl {name}: bf16 o is not the rounded f32 o")
                e16, e32 = max_err(got, ref16), max_err(got, ref32)
                tol16, tol32, how = ATTN_TOL_BF16, ATTN_TOL_F32, "max_abs_err"
                extra += f"; bf16 o is the rounded f32 o: {rounded}"
            else:
                # a bf16 o rounds to 2^-8 of itself: held as [slice-bf16] holds row 1's bf16 stream
                e16, e32 = rel_err(got, ref16), rel_err(got, ref32)
                tol16, tol32, how = TRAIN_TOL_BF16, TRAIN_TOL_F32, "error of max |plain|"
            print(f"[attn-xl] {name} {stream} q/k/v: N={n} H={h} T={t} Dh={dh} valid={valid} band={band} "
                  f"body {body} {how} bf16={e16:.3e} (tol {tol16}) f32={e32:.3e} (tol {tol32}) "
                  f"finite={finite}; same bits on a second call: {same}{extra}")
            check(got.dtype == q.dtype and got.shape == q.shape, f"attn-xl {name} {stream}: {got.dtype} {got.shape}")
            check(body == "sm90", f"attn-xl {name} {stream}: body {body}, expected sm90")
            check(same, f"attn-xl {name} {stream}: a second call gave other bits")
            check(finite, f"attn-xl {name} {stream}: non-finite output")
            check(e16 <= tol16, f"attn-xl {name} {stream}: {e16} > {tol16}")
            check(e32 <= tol32, f"attn-xl {name} {stream}: {e32} > {tol32}")
            if name == "fully_masked_rows":
                check(bool((got[:, :, valid + band:] == 0).all()), f"attn-xl {name}: masked rows not 0")
            if name != "main":
                continue
            pairs = attention_pairs(t, band, valid)
            flops = 4 * dh * n * h * pairs
            ms = cuda_ms(lambda: ba.banded_attention(q, k, v, band, valid))
            ms_dev = cuda_ms(lambda: ba.banded_attention(q, k, v, band, valid_dev))
            plain_ms = cuda_ms(lambda: ba.banded_attention_reference(q, k, v, band, valid, f32))
            mask = ba.banded_attention_mask(t, band, dev) & (torch.arange(t, device=dev) < valid)[None, :]
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
            b = bound(nbytes(q, k, v, got), flops)
            ms16 = ""
            if stream == "f32":
                ms_o16 = cuda_ms(lambda: ba.banded_attention(q, k, v, band, valid, out_dtype=bf16))
                ms16 = f" (bf16 o {ms_o16:.4f} ms)"
            print(f"[attn-xl] main {stream} q/k/v: valid_len an int {ms:.4f} ms, on the device {ms_dev:.4f} ms")
            print(f"[attn-xl] main {stream} q/k/v: kernel {ms:.4f} ms{ms16}, "
                  f"{ms * 1e6 / (n * h * pairs):.4f} ns per (query, key) pair per head, plain f32 "
                  f"{plain_ms:.4f} ms, SDPA (masked) {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']}, {nbytes(q, k, v, got) / 1e6:.2f} MB, {flops:.3e} FLOP)")
            results[f"banded_attention {stream}"] = {"max_abs_err": max_err(got, ref16), "ms": ms,
                                                     "plain_ms": plain_ms, **b, "library_ms": library_ms}

    # row 5 without LSE: the XL sampling shard of each of ATTN_XL_CP_SHARDS ranks
    n, h, t_real, band = 2, 16, 757, BAND
    t_glob = -(-t_real // (BLOCK * ATTN_XL_CP_SHARDS)) * BLOCK * ATTN_XL_CP_SHARDS
    t_loc, halo = t_glob // ATTN_XL_CP_SHARDS, -(-band // BLOCK) * BLOCK
    t = t_loc + 2 * halo
    for idx in range(ATTN_XL_CP_SHARDS):
        bounds = shard_bounds(t_loc, halo, types.SimpleNamespace(model_rank=idx, num_model=ATTN_XL_CP_SHARDS),
                              t_real)
        rows = slice(bounds[2], bounds[3])
        qkv = torch.randn((n, t, 3 * h * dh), generator=g, device=dev)
        for stream in ("f32", "bf16"):
            q, k, v = head_views(qkv if stream == "f32" else qkv.to(bf16), n, t, h, dh)
            got = ba.banded_attention_ranged(q, k, v, band, bounds)
            torch.cuda.synchronize()
            body = ba.banded_attention_ranged.body
            same = torch.equal(ba.banded_attention_ranged(q, k, v, band, bounds), got)
            ref16 = ba.banded_attention_fwd_lse_reference(q, k, v, band, t, bf16, bounds)[0]
            ref32 = ba.banded_attention_fwd_lse_reference(q, k, v, band, t, f32, bounds)[0]
            got_r, ref16_r, ref32_r = got[:, :, rows], ref16[:, :, rows], ref32[:, :, rows]
            if stream == "f32":
                e16, e32 = max_err(got_r, ref16_r), max_err(got_r, ref32_r)
                tol16, tol32, how = ATTN_TOL_BF16, ATTN_TOL_F32, "max_abs_err"
            else:
                e16, e32 = rel_err(got_r, ref16_r), rel_err(got_r, ref32_r)
                tol16, tol32, how = TRAIN_TOL_BF16, TRAIN_TOL_F32, "error of max |plain|"
            finite = bool(torch.isfinite(got_r).all())
            print(f"[attn-xl] ranged shard {idx} of {ATTN_XL_CP_SHARDS} {stream} q/k/v: N={n} H={h} "
                  f"T_ext={t} Dh={dh} bounds {bounds} band={band} body {body} {how} on the shard's rows "
                  f"bf16={e16:.3e} (tol {tol16}) f32={e32:.3e} (tol {tol32}) finite={finite}; same "
                  f"bits on a second call: {same}")
            check(body == "sm90" and same and finite, f"attn-xl ranged {idx} {stream}: body {body}, "
                  f"same {same}, finite {finite}")
            check(e16 <= tol16 and e32 <= tol32, f"attn-xl ranged {idx} {stream}: {e16}, {e32}")
            if idx != 0 or stream != "f32":
                continue
            allowed = ba._allowed(t, band, t, "cpu", query_valid=True, bounds=bounds)
            pairs = int(allowed.sum()) * n * h
            n_q, n_k = bounds[3] - bounds[2], int(allowed.any(dim=0).sum())
            row_bytes = n * h * dh * q.element_size()
            b = bound(row_bytes * 2 * (n_q + n_k), 4 * dh * pairs)  # q, o on the rows; k, v on the keys
            ms = cuda_ms(lambda: ba.banded_attention_ranged(q, k, v, band, bounds))
            plain_ms = cuda_ms(lambda: ba.banded_attention_fwd_lse_reference(q, k, v, band, t, f32, bounds))
            idx_t = torch.arange(t, device=dev)
            keys = (idx_t >= bounds[0]) & (idx_t < bounds[1])
            mask = (ba.banded_attention_mask(t, band, dev) & keys[None, :])[rows]
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q[:, :, rows], k, v, attn_mask=mask))
            print(f"[attn-xl] ranged shard 0 f32: kernel {ms:.4f} ms, plain f32 {plain_ms:.4f} ms, SDPA "
                  f"(masked) {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
            results["banded_attention_ranged f32"] = {"max_abs_err": max_err(got_r, ref16_r), "ms": ms,
                                                      "plain_ms": plain_ms, **b, "library_ms": library_ms}
    return results


def cublas_mlp_ms(n, t, d, hdim, dev) -> float:
    """Yardstick, not the same function: cuBLAS bf16 fc1 + fc2 of kernel B's
    shapes, (N*T, D) x (D, H) and (N*T, H) x (H, D), bf16 results."""
    import torch

    bf16 = torch.bfloat16
    h, w1 = torch.randn(n * t, d, device=dev, dtype=bf16), torch.randn(d, hdim, device=dev, dtype=bf16)
    g, w2 = torch.randn(n * t, hdim, device=dev, dtype=bf16), torch.randn(hdim, d, device=dev, dtype=bf16)
    return cuda_ms(lambda: (torch.mm(h, w1), torch.mm(g, w2)))


def mlp_sm90_resources(int8: bool = False) -> str:
    """Registers and spill bytes (0 required) of kernel B's Hopper GEMM
    builds from this build's ptxas lines, and the dynamic shared memory a
    CTA at each width: over bf16 weights the eight builds (tile width, up
    or down, x's type); over int8 codes (`int8`) the ten of rows 10 to 13
    (tile width; up, down, qkv, out or ada; f32 x)."""
    from osu_diffusion_tpu_torch.ops import adaln_mlp as am
    from osu_diffusion_tpu_torch.ops import cuda_build

    found, entry = {}, None
    for line in cuda_build.build_info["adaln_mlp"]["log"].splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        # <BN, EPI, TX, BL>: EPI 0 up, 1 down, 2 qkv, 3 out, 4 ada; TX f or __nv_bfloat16; BL 2 int8
        k = entry and re.search(r"adaln_mlp_gemm_kernelILi(\d+)ELi(\d)E(f|13__nv_bfloat16)Li(\d)E",
                                entry)
        if not k or (k[4] == "2") != int8:
            continue
        name = f"{k[1]} {('up', 'down', 'qkv', 'out', 'ada')[int(k[2])]} {'bf16' if k[3] != 'f' else 'f32'}"
        res = found.setdefault(name, {})
        if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            res["spill_bytes"] = int(m[1]) + int(m[2])
        if (m := re.search(r"Used (\d+) registers", line)):
            res["registers"] = int(m[1])
    want = 10 if int8 else 8
    what = "int8" if int8 else "bf16"
    check(len(found) == want and all(len(r) == 2 for r in found.values()),
          f"ptxas lines of the {want} {what} Hopper MLP GEMM builds not found: {found}")
    check(all(r["spill_bytes"] == 0 for r in found.values()), f"{what} Hopper MLP GEMMs spill: {found}")
    smem = am.sm90_smem_bytes(int8)
    return ("; ".join(f"{n} {r['registers']} registers, {r['spill_bytes']} spill bytes"
                      for n, r in sorted(found.items()))
            + "; shared memory a CTA " + ", ".join(f"{w}-wide {b} B" for w, b in smem.items()))


def skinny_resources() -> str:
    """Registers and spill bytes (0 required) of row 13's skinny body, one
    build per row block (1, 2, 4 and 8 n8 tiles), from this build's ptxas
    lines."""
    from osu_diffusion_tpu_torch.ops import cuda_build

    found, entry = {}, None
    for line in cuda_build.build_info["int8_matmul"]["log"].splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        k = entry and re.search(r"int8_matmul_skinny_kernelILi(\d+)E", entry)
        if not k:
            continue
        res = found.setdefault(f"{k[1]} n8 tiles", {})
        if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            res["spill_bytes"] = int(m[1]) + int(m[2])
        if (m := re.search(r"Used (\d+) registers", line)):
            res["registers"] = int(m[1])
    want = {f"{nt} n8 tiles" for nt in (1, 2, 4, 8)}
    check(set(found) == want and all(len(r) == 2 for r in found.values()),
          f"ptxas lines of the four skinny builds not found: {found}")
    check(all(r["spill_bytes"] == 0 for r in found.values()), f"the skinny builds spill: {found}")
    return "; ".join(f"{n} {r['registers']} registers, {r['spill_bytes']} spill bytes"
                     for n, r in sorted(found.items(), key=lambda kv: int(kv[0].split()[0])))


def mlp_bwd_wmma_resources(d: int) -> str:
    """Registers, spill bytes (0 required) and dynamic shared memory a CTA
    of the f32 stream's WMMA prologue and epilogue builds at width `d`, from
    this build's ptxas lines and the library."""
    from osu_diffusion_tpu_torch.ops import adaln_mlp as am
    from osu_diffusion_tpu_torch.ops import cuda_build

    found, entry = {}, None
    for line in cuda_build.build_info["adaln_mlp_bwd"]["log"].splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        k = entry and re.search(r"bwd_(prologue|epilogue)_kernelILi(\d+)E", entry)
        if not k or int(k[2]) != d:
            continue
        res = found.setdefault(k[1], {})
        if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            res["spill_bytes"] = int(m[1]) + int(m[2])
        if (m := re.search(r"Used (\d+) registers", line)):
            res["registers"] = int(m[1])
    check(set(found) == {"prologue", "epilogue"} and all(len(r) == 2 for r in found.values()),
          f"ptxas lines of the WMMA MLP backward builds at D {d} not found: {found}")
    check(all(r["spill_bytes"] == 0 for r in found.values()), f"WMMA MLP backward at D {d} spills: {found}")
    smem = am.bwd_wmma_smem_bytes(d)
    return "; ".join(f"{stage} D {d} {r['registers']} registers, {r['spill_bytes']} spill bytes, "
                     f"{smem[stage]} B shared memory a CTA" for stage, r in found.items())


def mlp_bwd_sm90_resources() -> str:
    """Registers and spill bytes (0 required) of the fused backward's Hopper
    body from this build's ptxas lines: the three GEMM builds (dgelu at 128,
    dh1 at 128 and 256) and the dmlp and row passes at each D; and the GEMM's
    dynamic shared memory a CTA at each width."""
    from osu_diffusion_tpu_torch.ops import adaln_mlp as am
    from osu_diffusion_tpu_torch.ops import cuda_build

    found, entry = {}, None
    for line in cuda_build.build_info["adaln_mlp_bwd"]["log"].splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        k = entry and re.search(r"adaln_mlp_bwd_(gemm|dmlp|ln)_kernelILi(\d+)E(?:Li(\d)E)?", entry)
        if not k:  # the WMMA body's and the sums' kernels
            continue
        name = (f"{k[2]} {'dgelu' if k[3] == '0' else 'dh1'} GEMM" if k[1] == "gemm"
                else f"{k[1]} pass D {k[2]}")
        res = found.setdefault(name, {})
        if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            res["spill_bytes"] = int(m[1]) + int(m[2])
        if (m := re.search(r"Used (\d+) registers", line)):
            res["registers"] = int(m[1])
    want = 3 + 2 * len(am.BWD_WIDTHS)  # three GEMM builds, and two row passes at each D
    check(len(found) == want and all(len(r) == 2 for r in found.values()),
          f"ptxas lines of the {want} Hopper MLP backward builds not found: {found}")
    check(all(r["spill_bytes"] == 0 for r in found.values()), f"Hopper MLP backward spills: {found}")
    smem = am.bwd_sm90_smem_bytes()
    return ("; ".join(f"{n} {r['registers']} registers, {r['spill_bytes']} spill bytes"
                      for n, r in sorted(found.items()))
            + "; GEMM shared memory a CTA " + ", ".join(f"{w}-wide {b} B" for w, b in smem.items()))


# [mlp]: (name, N, T, D) of row 7, the DiT-B sampling shape first;
# [mlp-xl]: DiT-XL's (D 1152, H 4608) and a ragged T at that width
MLP_CASES = [("main", 2, 768, 768), ("ragged_t", 3, 50, 768), ("dit_s_width", 2, 100, 384),
             ("dit_l_width_t757", 1, 757, 1024)]
MLP_XL_CASES = [("main", 2, 768, 1152), ("ragged_t", 3, 50, 1152)]


def phase_mlp(dev, tag="mlp", cases=MLP_CASES):
    """Row 7 on f32 x against its plain versions in each case (`cases`,
    the main path's shape first): its body, the same bits on a second call;
    at the main shape its time beside the bound, the plain versions and
    cuBLAS's two products. [mlp-xl] also holds the bf16 stream at the main
    shape, as [slice-bf16] holds it at DiT-B."""
    import torch
    from osu_diffusion_tpu_torch.ops.adaln_mlp import adaln_mlp, adaln_mlp_reference

    g = torch.Generator(device=dev).manual_seed(2)
    result = None
    for name, n, t, d in cases:
        hdim = 4 * d

        def rnd(*shape, std):
            return torch.randn(shape, generator=g, device=dev) * std

        x = rnd(n, t, d, std=1.0)
        mod = rnd(n, 6 * d, std=0.3)  # shift/scale/gate are row views of it
        shift, scale, gate = mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:]
        w1, w2 = rnd(d, hdim, std=d ** -0.5), rnd(hdim, d, std=hdim ** -0.5)
        b1, b2 = rnd(hdim, std=0.02), rnd(d, std=0.02)
        w1b, w2b = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
        fc1_w, fc2_w = w1b.t().contiguous(), w2b.t().contiguous()  # torch's Linear layout
        got = adaln_mlp(x, shift, scale, gate, fc1_w, b1, fc2_w, b2)
        torch.cuda.synchronize()
        body = adaln_mlp.body
        same = torch.equal(adaln_mlp(x, shift, scale, gate, fc1_w, b1, fc2_w, b2), got)
        ref16 = adaln_mlp_reference(x, shift, scale, gate, w1b, b1, w2b, b2, 1e-6, torch.bfloat16)
        ref32 = adaln_mlp_reference(x, shift, scale, gate, w1, b1, w2, b2, 1e-6, torch.float32)
        e16, e32 = max_err(got, ref16), max_err(got, ref32)
        print(f"[{tag}] {name}: x=({n}, {t}, {d}) w1=({d}, {hdim}) body {body} "
              f"max_abs_err bf16={e16:.3e} (tol {MLP_TOL_BF16}) "
              f"f32={e32:.3e} (tol {MLP_TOL_F32}); same bits on a second call: {same}")
        check(body == "sm90", f"{tag} {name}: body {body}, expected sm90")
        check(same, f"{tag} {name}: a second call gave other bits")
        check(bool(torch.isfinite(got).all()), f"{tag} {name}: non-finite output")
        check(e16 <= MLP_TOL_BF16, f"{tag} {name}: {e16} > {MLP_TOL_BF16}")
        check(e32 <= MLP_TOL_F32, f"{tag} {name}: {e32} > {MLP_TOL_F32}")
        if name == "main":
            ms = cuda_ms(lambda: adaln_mlp(x, shift, scale, gate, fc1_w, b1, fc2_w, b2))
            plain_ms = cuda_ms(lambda: adaln_mlp_reference(
                x, shift, scale, gate, w1, b1, w2, b2, 1e-6, torch.float32))
            plain16_ms = cuda_ms(lambda: adaln_mlp_reference(
                x, shift, scale, gate, w1b, b1, w2b, b2, 1e-6, torch.bfloat16))
            library_ms = cublas_mlp_ms(n, t, d, hdim, dev)
            b = bound(nbytes(x, shift, scale, gate, fc1_w, b1, fc2_w, b2, got), 4 * n * t * d * hdim)
            print(f"[{tag}] main: kernel {ms:.4f} ms, plain f32 {plain_ms:.4f} ms, "
                  f"plain bf16-rounded {plain16_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']}); yardstick, not the same function: cuBLAS bf16 fc1 + fc2 "
                  f"({n * t}, {d}) x ({d}, {hdim}), ({n * t}, {hdim}) x ({hdim}, {d}) {library_ms:.4f} ms")
            result = {"max_abs_err": e16, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": library_ms}
            if tag == "mlp":
                continue
            # the bf16 stream at this shape ([xl-bf16-forward] runs it end to end)
            xb = x.to(torch.bfloat16)
            got_b = adaln_mlp(xb, shift, scale, gate, fc1_w, b1, fc2_w, b2)
            e_b = rel_err(got_b, adaln_mlp_reference(xb, shift, scale, gate, w1b, b1, w2b, b2, 1e-6,
                                                     torch.bfloat16))
            ms_b = cuda_ms(lambda: adaln_mlp(xb, shift, scale, gate, fc1_w, b1, fc2_w, b2))
            print(f"[{tag}] main, bf16 x: body {adaln_mlp.body} {e_b:.3e} of max from its plain version "
                  f"(tol {TRAIN_TOL_BF16}: a bf16 output rounds to 2^-8 of itself), {ms_b:.4f} ms")
            check(got_b.dtype == torch.bfloat16 and adaln_mlp.body == "sm90" and e_b <= TRAIN_TOL_BF16,
                  f"{tag} bf16 x: {got_b.dtype}, body {adaln_mlp.body}, {e_b}")
    return result


def phase_attention_train(dev, tag="attn-train", cases=ATTN_TRAIN_CASES, dh=64):
    """Rows 2-4: the forward with LSE, dq and dk/dv against their plain
    versions (bf16 operands, and f32), every output checked, at head dim
    `dh`; the cases named main* timed. Returns the numbers of the case
    named main."""
    import torch
    import torch.nn.functional as F
    from osu_diffusion_tpu_torch.ops import banded_attention as ba

    g = torch.Generator(device=dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    results = {}
    if dh == 64:
        print_sm90_resources(tag, ("fwd bf16", "fwd f32", "dq", "dkv"))
    else:  # the builds this head dim adds to training: dq and dk/dv, Hopper and WMMA
        print_sm90_resources(tag, ("fwd bf16 dh72", "fwd f32 dh72") + SM90_BWD_XL_BUILDS)
        wmma = wmma_resources()
        print(f"[{tag}] WMMA bodies (ptxas): " + "; ".join(
            f"{n} {r['registers']} registers, {r['spill_bytes']} spill bytes, {r['smem_bytes']} B shared "
            f"memory a CTA" for n, r in sorted(wmma.items()) if n.endswith("dh72")))
    for name, n, h, t, valid, band, stream in cases:
        dtype = f32 if stream == "f32" else bf16
        qkv = torch.randn((n, t, 3 * h * dh), generator=g, device=dev).to(dtype)
        q, k, v = (a.view(n, t, h, dh).transpose(1, 2) for a in qkv.split(h * dh, dim=-1))
        # the gradient arrives in the (N, T, H, Dh) layout of the head merge
        do = torch.randn((n, t, h, dh), generator=g, device=dev).to(dtype).permute(0, 2, 1, 3)
        o, lse = ba.banded_attention_fwd_lse(q, k, v, band, valid)
        dq = ba.banded_attention_bwd_dq(q, k, v, o, lse, do, band, valid)
        dk, dv = ba.banded_attention_bwd_dkv(q, k, v, o, lse, do, band, valid)
        torch.cuda.synchronize()
        body = {"fwd": ba.banded_attention_fwd_lse.body, "dq": ba.banded_attention_bwd_dq.body,
                "dkv": ba.banded_attention_bwd_dkv.body}
        want = {"fwd": FWD_BODY[stream], "dq": BODY[stream], "dkv": BODY[stream]}
        check(body == want, f"{tag} {name}: bodies {body}, want {want}")
        o16, lse16 = ba.banded_attention_fwd_lse_reference(q, k, v, band, valid, bf16)
        grads16 = ba.banded_attention_bwd_reference(q, k, v, o, lse, do, band, valid, bf16)
        o32, lse32 = ba.banded_attention_fwd_lse_reference(q, k, v, band, valid, f32)
        grads32 = ba.banded_attention_bwd_reference(q, k, v, o32, lse32, do, band, valid, f32)
        has_key = lse16 > -1e29  # rows whose band holds a valid key
        errs = {"lse": (max_err(lse[has_key], lse16[has_key]), max_err(lse[has_key], lse32[has_key]))}
        for out, got, w16, w32 in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                                      (o16, *grads16), (o32, *grads32)):
            check(bool(torch.isfinite(got).all()), f"{tag} {name}: non-finite {out}")
            errs[out] = (rel_err(got, w16), rel_err(got, w32))
        print(f"[{tag}] {name}: N={n} H={h} T={t} Dh={dh} valid={valid} band={band} {stream} "
              f"body fwd={body['fwd']} dq={body['dq']} dkv={body['dkv']} "
              + " ".join(f"{k}={a:.2e}/{b:.2e}" for k, (a, b) in errs.items())
              + f" (bf16/f32 plain; tol lse {LSE_TOL}/{LSE_TOL_F32} abs, "
              f"others {TRAIN_TOL_BF16}/{TRAIN_TOL_F32} of max)")
        check(errs["lse"][0] <= LSE_TOL and errs["lse"][1] <= LSE_TOL_F32, f"{tag} lse {name}: {errs['lse']}")
        check(bool((lse[~has_key] < -1e29).all()), f"{tag} lse {name}: rows without a key not ~-1e30")
        for out in ("o", "dq", "dk", "dv"):
            check(errs[out][0] <= TRAIN_TOL_BF16, f"{tag} {out} {name}: {errs[out][0]} > {TRAIN_TOL_BF16}")
            check(errs[out][1] <= TRAIN_TOL_F32, f"{tag} {out} {name}: {errs[out][1]} > {TRAIN_TOL_F32}")
        check(bool((dq[:, :, valid:] == 0).all() and (dk[:, :, valid:] == 0).all()
                   and (dv[:, :, valid:] == 0).all()), f"{tag} {name}: gradient past valid_len")
        if name == "fully_masked_rows":
            check(bool((o[:, :, valid + band:] == 0).all()), "masked rows not 0")
        if not name.startswith("main"):
            continue
        # no atomics: one CTA owns each query block, so dq is the same bits run to run
        check(torch.equal(dq, ba.banded_attention_bwd_dq(q, k, v, o, lse, do, band, valid)),
              f"{tag} {name}: dq differs run to run")
        fwd_ms = cuda_ms(lambda: ba.banded_attention_fwd_lse(q, k, v, band, valid))
        dq_ms = cuda_ms(lambda: ba.banded_attention_bwd_dq(q, k, v, o, lse, do, band, valid))
        dkv_ms = cuda_ms(lambda: ba.banded_attention_bwd_dkv(q, k, v, o, lse, do, band, valid))
        fwd_plain_ms = cuda_ms(lambda: ba.banded_attention_fwd_lse_reference(q, k, v, band, valid, f32))
        bwd_plain_ms = cuda_ms(lambda: ba.banded_attention_bwd_reference(
            q, k, v, o32, lse32, do, band, valid, f32))
        # yardstick: SDPA at T = band = valid_len is full attention, the same
        # function; its forward with inputs that need grad also keeps the
        # LSE, and its backward computes dq, dk and dv in one call
        ql, kl, vl = (a.detach().requires_grad_() for a in (q, k, v))
        sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl))
        out = F.scaled_dot_product_attention(ql, kl, vl)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True))
        mask_note = ""
        if dh != 64:  # also with the band as a boolean mask (every pair allowed here)
            mask = ba.banded_attention_mask(t, band, dev) & (torch.arange(t, device=dev) < valid)[None, :]
            sdpa_mask_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask))
            out_m = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
            sdpa_mask_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out_m, (ql, kl, vl), do, retain_graph=True))
            mask_note = (f"; SDPA with the band as a bool mask fwd {sdpa_mask_fwd_ms:.4f} ms, "
                         f"bwd {sdpa_mask_bwd_ms:.4f} ms")
        pairs_f = attention_pairs(t, band, valid) * n * h
        pairs_b = attention_pairs(t, band, valid, query_valid=True) * n * h
        bounds = {
            "fwd_lse": bound(nbytes(q, k, v, o, lse), 4 * dh * pairs_f),
            "dq": bound(nbytes(q, k, v, o, do, lse, dq), 6 * dh * pairs_b),
            "dkv": bound(nbytes(q, k, v, o, do, lse, dk, dv), 8 * dh * pairs_b),
        }
        print(f"[{tag}] {name} ({stream}; bodies fwd {body['fwd']}, dq {body['dq']}, dk/dv {body['dkv']}): "
              f"fwd+lse {fwd_ms:.4f} ms, dq {dq_ms:.4f} ms, dk/dv {dkv_ms:.4f} ms; "
              f"plain f32 fwd {fwd_plain_ms:.4f} ms, bwd (dq, dk, dv) {bwd_plain_ms:.4f} ms; "
              f"SDPA fwd {sdpa_fwd_ms:.4f} ms, bwd {sdpa_bwd_ms:.4f} ms{mask_note}; bounds "
              + ", ".join(f"{k} {b['bound_ms']:.4f} ms ({b['bound_by']})" for k, b in bounds.items()))
        if name != "main":
            continue
        results = {
            "banded_attention_fwd_lse": {"max_abs_err": max_err(o, o16), "ms": fwd_ms,
                                         "plain_ms": fwd_plain_ms, **bounds["fwd_lse"],
                                         "library_ms": sdpa_fwd_ms},
            "banded_attention_bwd_dq": {"max_abs_err": max_err(dq, grads16[0]), "ms": dq_ms,
                                        "plain_ms": bwd_plain_ms, **bounds["dq"],
                                        "library_ms": sdpa_bwd_ms},
            "banded_attention_bwd_dkv": {"max_abs_err": max(max_err(dk, grads16[1]), max_err(dv, grads16[2])),
                                         "ms": dkv_ms, "plain_ms": bwd_plain_ms, **bounds["dkv"],
                                         "library_ms": sdpa_bwd_ms},
        }
    return results


def phase_mlp_train(dev, tag="mlp-train", cases=MLP_TRAIN_CASES):
    """Row 8: kernel B's training forward (out, a, mlp) against its plain
    version (bf16 operands, and f32); its body and repeatability; at the
    shapes named main* its three stages' times beside the whole, and the
    Hopper GEMM builds' resources. Returns the numbers of the case named
    main."""
    import torch
    from osu_diffusion_tpu_torch.ops import adaln_mlp as am

    g = torch.Generator(device=dev).manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    print(f"[{tag}] Hopper GEMM builds (ptxas): {mlp_sm90_resources()}")
    result = None
    for name, n, t, d, stream in cases:
        dtype = f32 if stream == "f32" else bf16
        hdim = 4 * d

        def rnd(*shape, std):
            return torch.randn(shape, generator=g, device=dev) * std

        x = rnd(n, t, d, std=1.0).to(dtype)
        mod = rnd(n, 6 * d, std=0.3)
        shift, scale, gate = mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:]
        w1, w2 = rnd(d, hdim, std=d ** -0.5), rnd(hdim, d, std=hdim ** -0.5)
        b1, b2 = rnd(hdim, std=0.02), rnd(d, std=0.02)
        w1b, w2b = w1.to(bf16), w2.to(bf16)
        fc1_w, fc2_w = w1b.t().contiguous(), w2b.t().contiguous()
        args = (x, shift, scale, gate, fc1_w, b1, fc2_w, b2)
        got = am.adaln_mlp_train(*args)
        torch.cuda.synchronize()
        body = am.adaln_mlp_train.body
        same = all(torch.equal(u, v) for u, v in zip(am.adaln_mlp_train(*args), got))
        want16 = am.adaln_mlp_train_reference(x, shift, scale, gate, w1b, b1, w2b, b2, 1e-6, bf16)
        want32 = am.adaln_mlp_train_reference(x, shift, scale, gate, w1, b1, w2, b2, 1e-6, f32)
        errs = {}
        for out, a, w16, w32 in zip(("out", "a", "mlp"), got, want16, want32):
            check(bool(torch.isfinite(a).all()), f"{tag} {name}: non-finite {out}")
            check(a.shape == w16.shape and a.dtype == w16.dtype, f"{tag} {name}: {out} shape/type")
            errs[out] = (rel_err(a, w16), rel_err(a, w32))
        print(f"[{tag}] {name}: x=({n}, {t}, {d}) {stream} body {body} "
              + " ".join(f"{k}={a:.2e}/{b:.2e}" for k, (a, b) in errs.items())
              + f" (bf16/f32 plain, of max; tol {TRAIN_TOL_BF16}/{TRAIN_TOL_F32}); "
              f"same bits on a second call: {same}")
        check(body == "sm90", f"{tag} {name}: body {body}, expected sm90")
        check(same, f"{tag} {name}: a second call gave other bits")
        for out, (e16, e32) in errs.items():
            check(e16 <= TRAIN_TOL_BF16, f"{tag} {name} {out}: {e16} > {TRAIN_TOL_BF16}")
            check(e32 <= TRAIN_TOL_F32, f"{tag} {name} {out}: {e32} > {TRAIN_TOL_F32}")
        if name.startswith("main"):
            ms = cuda_ms(lambda: am.adaln_mlp_train(*args))
            # each stage alone (a timing run: the other stages' outputs unwritten)
            stage_ms = {stage: cuda_ms(lambda m=mask: am._launch(
                am.adaln_mlp_train, *args, 1e-6, bf16, residuals=True, stages=m))
                for stage, mask in (("modulate", 1), ("up", 2), ("down", 4))}
            up, down = am.mlp_plan(n, t, d, hdim, torch.cuda.get_device_properties(0).multi_processor_count)
            plain_ms = cuda_ms(lambda: am.adaln_mlp_train_reference(
                x, shift, scale, gate, w1, b1, w2, b2, 1e-6, f32))
            plain16_ms = cuda_ms(lambda: am.adaln_mlp_train_reference(
                x, shift, scale, gate, w1b, b1, w2b, b2, 1e-6, bf16))
            library_ms = cublas_mlp_ms(n, t, d, hdim, dev)
            b = bound(nbytes(*args, *got), 4 * n * t * d * hdim)
            print(f"[{tag}] {name} ({stream}): kernel {ms:.4f} ms (stages alone: modulate "
                  f"{stage_ms['modulate']:.4f}, up {stage_ms['up']:.4f} ({up.width}-wide tiles, "
                  f"{up.tiles} on {up.grid} CTAs), down {stage_ms['down']:.4f} ({down.width}-wide, "
                  f"{down.tiles} on {down.grid}); sum {sum(stage_ms.values()):.4f}), plain f32 "
                  f"{plain_ms:.4f} ms, plain bf16-rounded {plain16_ms:.4f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}); yardstick, not the same function: "
                  f"cuBLAS bf16 fc1 + fc2 ({n * t}, {d}) x ({d}, {hdim}), ({n * t}, {hdim}) x "
                  f"({hdim}, {d}) {library_ms:.4f} ms")
            if name == "main":
                result = {"max_abs_err": max_err(got[0], want16[0]), "ms": ms, "plain_ms": plain_ms,
                          **b, "library_ms": library_ms}
    return result


def phase_mlp_bwd(dev, tag="mlp-bwd", cases=MLP_BWD_CASES):
    """Rows 9a/9b: the fused backward's prologue and epilogue against their
    plain versions (bf16 operands, and f32), each of the ten outputs, with
    their bodies and the same bits on a second call, in each case of
    `cases`; at the shapes named main* (the training shape) their times
    beside their bounds, their plain versions and the cuBLAS bf16 product
    of their shape, and in the bf16 stream their Hopper body's four kernels
    alone; at the one named main the whole fused backward beside the plain
    backward (`adaln_mlp_bwd`) at the same inputs, in turns. [mlp-bwd-xl]
    also prints the WMMA body's builds at D 1152. Returns (the two kernels'
    numbers at main, {plain, fused: mean ms of the whole backward})."""
    import torch
    from osu_diffusion_tpu_torch.ops import adaln_mlp as am

    g = torch.Generator(device=dev).manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    print(f"[{tag}] Hopper body builds (ptxas): {mlp_bwd_sm90_resources()}")
    if tag != "mlp-bwd":
        print(f"[{tag}] WMMA body builds (ptxas): {mlp_bwd_wmma_resources(cases[0][3])}")
    results, whole_ms = {}, None
    for name, n, t, d, stream in cases:
        dtype = f32 if stream == "f32" else bf16
        hdim = 4 * d

        def rnd(*shape, std):
            return torch.randn(shape, generator=g, device=dev) * std

        x = rnd(n, t, d, std=1.0).to(dtype)
        mod = rnd(n, 6 * d, std=0.3)
        shift, scale, gate = mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:]
        w1, w2 = rnd(d, hdim, std=d ** -0.5), rnd(hdim, d, std=hdim ** -0.5)
        b1, b2 = rnd(hdim, std=0.02), rnd(d, std=0.02)
        w1b, w2b = w1.to(bf16), w2.to(bf16)
        fc1_w, fc2_w = w1b.t().contiguous(), w2b.t().contiguous()  # torch's Linear layout
        # the residuals, from the training forward
        _, a, mlp = am.adaln_mlp_train(x, shift, scale, gate, fc1_w, b1, fc2_w, b2)
        gout = rnd(n, t, d, std=1.0).to(dtype)
        pro = am.adaln_mlp_bwd_prologue(gout, mlp, a, gate, fc2_w)
        epi = am.adaln_mlp_bwd_epilogue(pro[0], x, gout, shift, scale, fc1_w)
        torch.cuda.synchronize()
        body = (am.adaln_mlp_bwd_prologue.body, am.adaln_mlp_bwd_epilogue.body)
        # no atomics: the same bits on a second call
        same = (all(torch.equal(u, v) for u, v in zip(am.adaln_mlp_bwd_prologue(gout, mlp, a, gate, fc2_w), pro))
                and all(torch.equal(u, v) for u, v in zip(
                    am.adaln_mlp_bwd_epilogue(pro[0], x, gout, shift, scale, fc1_w), epi)))
        # each stage against its plain versions on the same inputs (the
        # epilogue on the kernel prologue's da)
        wants = [
            (am.adaln_mlp_bwd_prologue_reference(gout, mlp, a, gate, w2b, bf16),
             am.adaln_mlp_bwd_prologue_reference(gout, mlp, a, gate, w2, f32)),
            (am.adaln_mlp_bwd_epilogue_reference(pro[0], x, gout, shift, scale, w1b, 1e-6, bf16),
             am.adaln_mlp_bwd_epilogue_reference(pro[0], x, gout, shift, scale, w1, 1e-6, f32)),
        ]
        names = (("da", "gelu_out", "dmlp", "dgate", "db1", "db2"), ("dx", "h1", "dshift", "dscale"))
        errs = {}
        for outs, got, (w16, w32) in zip(names, (pro, epi), wants):
            for out, u, v16, v32 in zip(outs, got, w16, w32):
                check(bool(torch.isfinite(u).all()), f"{tag} {name}: non-finite {out}")
                check(u.shape == v16.shape and u.dtype == v16.dtype, f"{tag} {name}: {out} shape/type")
                errs[out] = (rel_err(u, v16), rel_err(u, v32))
        print(f"[{tag}] {name}: x=({n}, {t}, {d}) {stream} body prologue={body[0]} epilogue={body[1]} "
              + " ".join(f"{k}={u:.2e}/{v:.2e}" for k, (u, v) in errs.items())
              + f" (bf16/f32 plain, of max; tol {TRAIN_TOL_BF16}/{TRAIN_TOL_F32}); "
              f"same bits on a second call: {same}")
        check(body == (BODY[stream],) * 2, f"{tag} {name}: bodies {body}, want {BODY[stream]}")
        check(same, f"{tag} {name}: a second call gave other bits")
        for out, (e16, e32) in errs.items():
            check(e16 <= TRAIN_TOL_BF16, f"{tag} {name} {out}: {e16} > {TRAIN_TOL_BF16}")
            check(e32 <= TRAIN_TOL_F32, f"{tag} {name} {out}: {e32} > {TRAIN_TOL_F32}")
        if not name.startswith("main"):
            continue
        pro_ms = cuda_ms(lambda: am.adaln_mlp_bwd_prologue(gout, mlp, a, gate, fc2_w))
        epi_ms = cuda_ms(lambda: am.adaln_mlp_bwd_epilogue(pro[0], x, gout, shift, scale, fc1_w))
        # the Hopper body's kernels alone (timing runs: the others' outputs unwritten)
        stage_ms = {} if stream == "f32" else {
            "dmlp pass": cuda_ms(lambda: am._bwd_prologue_launch(gout, mlp, a, gate, fc2_w, bf16, 1)),
            "dgelu GEMM": cuda_ms(lambda: am._bwd_prologue_launch(gout, mlp, a, gate, fc2_w, bf16, 2)),
            "dh1 GEMM": cuda_ms(lambda: am._bwd_epilogue_launch(pro[0], x, gout, shift, scale, fc1_w,
                                                                1e-6, bf16, 1)),
            "row pass": cuda_ms(lambda: am._bwd_epilogue_launch(pro[0], x, gout, shift, scale, fc1_w,
                                                                1e-6, bf16, 2)),
        }
        dgelu_plan, dh1_plan = am.mlp_bwd_plan(n, t, d, hdim,
                                               torch.cuda.get_device_properties(0).multi_processor_count)
        pro_plain_ms = cuda_ms(lambda: am.adaln_mlp_bwd_prologue_reference(gout, mlp, a, gate, w2, f32))
        epi_plain_ms = cuda_ms(lambda: am.adaln_mlp_bwd_epilogue_reference(
            pro[0], x, gout, shift, scale, w1, 1e-6, f32))
        flops = 2 * n * t * d * hdim
        bounds = {"prologue": bound(nbytes(gout, mlp, a, gate, fc2_w, *pro), flops),
                  "epilogue": bound(nbytes(pro[0], x, gout, shift, scale, fc1_w, *epi), flops)}
        mats = {"prologue": (torch.randn(n * t, d, device=dev, dtype=bf16),
                             torch.randn(d, hdim, device=dev, dtype=bf16)),
                "epilogue": (torch.randn(n * t, hdim, device=dev, dtype=bf16),
                             torch.randn(hdim, d, device=dev, dtype=bf16))}
        cublas = {k: cuda_ms(lambda u=u, v=v: torch.mm(u, v, out_dtype=f32)) for k, (u, v) in mats.items()}
        del mats
        print(f"[{tag}] {name} ({stream}, body {body[0]}): prologue {pro_ms:.4f} ms (bound "
              f"{bounds['prologue']['bound_ms']:.4f}, {bounds['prologue']['bound_by']}; plain f32 "
              f"{pro_plain_ms:.4f}; yardstick, not the same function: cuBLAS bf16 ({n * t}, {d}) x ({d}, "
              f"{hdim}) {cublas['prologue']:.4f}), epilogue {epi_ms:.4f} ms (bound "
              f"{bounds['epilogue']['bound_ms']:.4f}, {bounds['epilogue']['bound_by']}; plain f32 "
              f"{epi_plain_ms:.4f}; cuBLAS bf16 ({n * t}, {hdim}) x ({hdim}, {d}) {cublas['epilogue']:.4f}); "
              "no single PyTorch call computes either")
        if stage_ms:
            print(f"[{tag}] {name}: the Hopper body's kernels alone: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in stage_ms.items())
                  + f" ms (dgelu {dgelu_plan.width}-wide tiles, {dgelu_plan.tiles} on {dgelu_plan.grid} CTAs; "
                  f"dh1 {dh1_plan.width}-wide, {dh1_plan.tiles} on {dh1_plan.grid}; each GEMM with its sums "
                  f"of partials, the row passes with theirs)")
        if name != "main":
            continue
        # the whole backward, fused against plain, at the same inputs, in turns
        fc1_m, fc2_m = w1.t(), w2.t()  # the f32 master weights in torch's layout
        runs = {"plain": lambda: am.adaln_mlp_bwd(x, shift, scale, gate, fc1_m, fc2_m, a, mlp, gout,
                                                  1e-6, bf16),
                "fused": lambda: am.adaln_mlp_bwd_fused(x, shift, scale, gate, fc1_m, fc2_m, a, mlp,
                                                        gout, 1e-6, bf16, weights=(fc1_w, fc2_w))}
        diff = max(rel_err(u, v) for u, v in zip(runs["fused"](), runs["plain"]()))
        whole = {k: [] for k in runs}
        for k in ("plain", "fused", "fused", "plain"):
            whole[k].append(cuda_ms(runs[k], iters=10))
        print(f"[{tag}] main: whole MLP backward in turns (plain, fused, fused, plain): plain "
              + ", ".join(f"{v:.4f}" for v in whole["plain"]) + " ms, fused "
              + ", ".join(f"{v:.4f}" for v in whole["fused"]) + f" ms (fused = both kernels + the two "
              f"cuBLAS weight-gradient products); fused vs plain gradients differ by {diff:.2e} of max "
              f"(tol {TRAIN_TOL_F32})")
        check(diff <= TRAIN_TOL_F32, f"{tag}: fused vs plain MLP backward: {diff}")
        for kern, ms, plain_ms, err in (("adaln_mlp_bwd_prologue", pro_ms, pro_plain_ms,
                                         max_err(pro[0], wants[0][0][0])),
                                        ("adaln_mlp_bwd_epilogue", epi_ms, epi_plain_ms,
                                         max_err(epi[0], wants[1][0][0]))):
            stage = kern.rsplit("_", 1)[1]
            results[kern] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bounds[stage],
                             "library_ms": None, "cublas_product_ms": cublas[stage]}
        whole_ms = {k: sum(v) / len(v) for k, v in whole.items()}
    return results, whole_ms


def phase_mlp_tp(dev, cases=MLP_TP_CASES, tag="mlp-tp"):
    """[mlp-tp]: rows 8, 9a and 9b on the shards tensor parallelism gives
    them: for each case every model rank's hidden units (fc1's rows and
    b1, fc2's columns; H = 4D/P), rank 0 whole and the others with the
    rank-partial argument, against their plain versions on the same shard
    (bf16 operands, and f32) at [mlp-train]'s and [mlp-bwd]'s tolerances,
    with their bodies; the row's sums (out, mlp, and the epilogue's dx,
    dshift, dscale and the prologue's dgate) against the whole MLP half's
    f32 plain forward and backward. At the main_* cases rank 1's (a
    partial's) times beside bounds, plain versions and the cuBLAS products
    of the shard's shape, and rank 0's forward. [mlp-tp-ragged]: shard
    widths that are not a multiple of 128 run the kernels zero-padded to
    one, as `AdalnMlp` pads them (their outputs sliced back to the shard,
    the padded units' a, da and db1 required to be exactly 0), against the
    plain versions at the true width, the times at the padded width beside
    the bound at the true one; and `AdalnMlp` itself on one rank's shard of
    each main case, each backward, against the plain versions at the true
    width. Returns {case: numbers}."""
    import torch
    from osu_diffusion_tpu_torch.ops import adaln_mlp as am

    g = torch.Generator(device=dev).manual_seed(8)
    bf16, f32 = torch.bfloat16, torch.float32
    wall = time.perf_counter()
    widths = sorted({d for _, _, _, d, _, stream in cases if stream == "f32"})
    print(f"[{tag}] the builds these shards run (ptxas): forward {mlp_sm90_resources()}; backward "
          f"{mlp_bwd_sm90_resources()}; f32 backward "
          + "; ".join(mlp_bwd_wmma_resources(d) for d in widths))
    results = {}
    for name, n, t, d, p, stream in cases:
        dtype = f32 if stream == "f32" else bf16
        hdim = 4 * d
        hs = hdim // p
        hp = am.padded_hidden(hs)  # the width the kernels run

        def rnd(*shape, std):
            return torch.randn(shape, generator=g, device=dev) * std

        x = rnd(n, t, d, std=1.0).to(dtype)
        mod = rnd(n, 6 * d, std=0.3)
        shift, scale, gate = mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:]
        w1, w2 = rnd(d, hdim, std=d ** -0.5), rnd(hdim, d, std=hdim ** -0.5)
        b1, b2 = rnd(hdim, std=0.02), rnd(d, std=0.02)
        w1b, w2b = w1.to(bf16), w2.to(bf16)
        gout = rnd(n, t, d, std=1.0).to(dtype)
        sums = {k: 0.0 for k in ("out", "mlp", "dx", "dshift", "dscale", "dgate")}
        errs, bodies, row8, pads_zero = {}, set(), {}, True
        for r in range(p):
            cols = slice(r * hs, (r + 1) * hs)
            partial = r > 0
            fc1_w, fc2_w = w1b[:, cols].t().contiguous(), w2b[cols].t().contiguous()
            b1r = b1[cols].contiguous()
            kw1, kb1, kw2 = (fc1_w, b1r, fc2_w) if hp == hs else am.pad_hidden(fc1_w, b1r, fc2_w, hp)
            fwd = am.adaln_mlp_train(x, shift, scale, gate, kw1, kb1, kw2, b2, partial=partial)
            pro = am.adaln_mlp_bwd_prologue(gout, fwd[2], fwd[1], gate, kw2)
            epi = am.adaln_mlp_bwd_epilogue(pro[0], x, gout, shift, scale, kw1, partial=partial)
            torch.cuda.synchronize()
            bodies.add((am.adaln_mlp_train.body, am.adaln_mlp_bwd_prologue.body, am.adaln_mlp_bwd_epilogue.body))
            if hp != hs:  # the padded units' a, da, gelu(a) and db1 are exact zeros
                pads_zero = pads_zero and not any(bool(v.any()) for v in (
                    fwd[1][..., hs:], pro[0][..., hs:], pro[1][..., hs:], pro[4][hs:]))
            kernel_out = (fwd, pro)
            # the outputs at the shard's true width
            fwd = (fwd[0], fwd[1][..., :hs], fwd[2])
            pro = (pro[0][..., :hs], pro[1][..., :hs], *pro[2:4], pro[4][:hs], pro[5])
            wants = {}
            for key, w1k, w2k, mdt in (("bf16", w1b, w2b, bf16), ("f32", w1, w2, f32)):
                wf = am.adaln_mlp_train_reference(x, shift, scale, gate, w1k[:, cols], b1r, w2k[cols], b2,
                                                  1e-6, mdt, partial)
                wp = am.adaln_mlp_bwd_prologue_reference(gout, fwd[2], fwd[1], gate, w2k[cols], mdt)
                we = am.adaln_mlp_bwd_epilogue_reference(pro[0], x, gout, shift, scale, w1k[:, cols], 1e-6,
                                                         mdt, partial)
                wants[key] = (*wf, *wp, *we)
            got = (*fwd, *pro, *epi)
            names = ("out", "a", "mlp", "da", "gelu_out", "dmlp", "dgate", "db1", "db2", "dx", "h1", "dshift",
                     "dscale")
            for out, u, v16, v32 in zip(names, got, wants["bf16"], wants["f32"]):
                check(bool(torch.isfinite(u).all()), f"mlp-tp {name} rank {r}: non-finite {out}")
                check(u.shape == v16.shape and u.dtype == v16.dtype, f"mlp-tp {name} rank {r}: {out} shape/type")
                e16, e32 = rel_err(u, v16), rel_err(u, v32)
                old = errs.get(out, (0.0, 0.0))
                errs[out] = (max(old[0], e16), max(old[1], e32))
            for k, v in (("out", fwd[0]), ("mlp", fwd[2]), ("dgate", pro[3]), ("dx", epi[0]), ("dshift", epi[2]),
                         ("dscale", epi[3])):
                sums[k] = sums[k] + v.float()
            if name.startswith("main") and r < 2:  # rank 0 whole, rank 1 a partial
                row8[r] = lambda args=(x, shift, scale, gate, kw1, kb1, kw2, b2), part=partial: (
                    am.adaln_mlp_train(*args, partial=part))
            if name.startswith("main") and r == 1:
                # rows 8 whole and partial in turns (whole, partial, partial, whole)
                turns = {0: [], 1: []}
                for k in (0, 1, 1, 0):
                    turns[k].append(cuda_ms(row8[k]))
                ms, whole_ms = sum(turns[1]) / 2, sum(turns[0]) / 2
                kfwd, kpro = kernel_out
                pro_ms = cuda_ms(lambda: am.adaln_mlp_bwd_prologue(gout, kfwd[2], kfwd[1], gate, kw2))
                epi_ms = cuda_ms(lambda: am.adaln_mlp_bwd_epilogue(kpro[0], x, gout, shift, scale, kw1,
                                                                   partial=True))
                w1c, w2c = w1[:, cols], w2[cols]
                plain = {"fwd": cuda_ms(lambda: am.adaln_mlp_train_reference(
                             x, shift, scale, gate, w1c, b1r, w2c, b2, 1e-6, f32, True)),
                         "pro": cuda_ms(lambda: am.adaln_mlp_bwd_prologue_reference(gout, fwd[2], fwd[1], gate,
                                                                                    w2c, f32)),
                         "epi": cuda_ms(lambda: am.adaln_mlp_bwd_epilogue_reference(
                             pro[0], x, gout, shift, scale, w1c, 1e-6, f32, True))}
                flops = 2 * n * t * d * hs
                bounds = {"fwd": bound(nbytes(x, shift, scale, gate, fc1_w, b1r, fc2_w, *fwd), 2 * flops),
                          "pro": bound(nbytes(gout, fwd[2], fwd[1], gate, fc2_w, *pro), flops),
                          "epi": bound(nbytes(pro[0], x, shift, scale, fc1_w, *epi), flops)}
                mats = {"pro": (torch.randn(n * t, d, device=dev, dtype=bf16),
                                torch.randn(d, hs, device=dev, dtype=bf16)),
                        "epi": (torch.randn(n * t, hs, device=dev, dtype=bf16),
                                torch.randn(hs, d, device=dev, dtype=bf16))}
                cublas = {k: cuda_ms(lambda u=u, v=v: torch.mm(u, v, out_dtype=f32)) for k, (u, v) in mats.items()}
                cublas["fwd"] = cublas_mlp_ms(n, t, d, hs, dev)
                del mats
                results[name] = {"ms": {"fwd": ms, "pro": pro_ms, "epi": epi_ms}, "plain_ms": plain,
                                 "bounds": bounds, "cublas_ms": cublas}
                if hp != hs:
                    results[name]["function"] = adaln_mlp_function_errors(
                        x, shift, scale, gate, w1[:, cols].t().contiguous(), b1r, w2[cols].t().contiguous(), b2,
                        gout)
                    del kfwd, kpro
            del fwd, pro, epi, wants, got, kernel_out
        # the row's sums against the whole MLP half (f32 plain)
        fw = am.adaln_mlp_train_reference(x, shift, scale, gate, w1, b1, w2, b2, 1e-6, f32)
        bw = am.adaln_mlp_bwd(x, shift, scale, gate, w1.t(), w2.t(), fw[1], fw[2], gout, 1e-6, f32)
        whole = {"out": fw[0], "mlp": fw[2], "dx": bw[0], "dshift": bw[1], "dscale": bw[2], "dgate": bw[3]}
        sum_errs = {k: rel_err(sums[k], whole[k]) for k in sums}
        del fw, bw, whole, sums
        print(f"[{tag}] {name}: x=({n}, {t}, {d}) {stream}, {p} ranks of H {hs} (of {hdim}; the kernels at "
              f"{hp}, padded units' a, da, gelu(a), db1 exactly 0: {pads_zero}), bodies "
              f"{sorted(bodies)}; worst rank of "
              + " ".join(f"{k}={u:.2e}/{v:.2e}" for k, (u, v) in errs.items())
              + f" (bf16/f32 plain, of max; tol {TRAIN_TOL_BF16}/{TRAIN_TOL_F32}); the row's sums against the "
              "whole MLP half's f32 plain version " + " ".join(f"{k}={v:.2e}" for k, v in sum_errs.items())
              + f" (tol {TRAIN_TOL_F32})")
        want_body = ("sm90", BODY[stream], BODY[stream])
        check(bodies == {want_body}, f"{tag} {name}: bodies {bodies}, want {want_body}")
        check(pads_zero, f"{tag} {name}: a padded hidden unit's a, da, gelu(a) or db1 is not 0")
        for out, (e16, e32) in errs.items():
            check(e16 <= TRAIN_TOL_BF16, f"{tag} {name} {out}: {e16} > {TRAIN_TOL_BF16}")
            check(e32 <= TRAIN_TOL_F32, f"{tag} {name} {out}: {e32} > {TRAIN_TOL_F32}")
        for k, e in sum_errs.items():
            check(e <= TRAIN_TOL_F32, f"{tag} {name}: the row's sum of {k} is {e} of max from the whole MLP")
        if name in results:
            res = results[name]
            res["whole_rank_fwd_ms"] = whole_ms
            if "function" in res:
                print(f"[{tag}] {name}: AdalnMlp on rank 1's shard (H {hs}, padded to {hp} inside the call), "
                      "forward and backward against the plain versions at H " + str(hs) + ", error of max "
                      + "; ".join(f"{bwd}: " + " ".join(f"{k}={e:.2e}" for k, e in errs_.items())
                                  for bwd, errs_ in res["function"].items()) + f" (tol {TRAIN_TOL_BF16})")
                for bwd, errs_ in res["function"].items():
                    check(all(e <= TRAIN_TOL_BF16 for e in errs_.values()), f"{tag} {name} AdalnMlp {bwd}: {errs_}")
            print(f"[{tag}] {name} ({stream}, H {hs}, the kernels at {hp}; bounds at H {hs}): rank 1 (a partial): "
                  f"row 8 {res['ms']['fwd']:.4f} ms "
                  f"(rank 0, whole: {whole_ms:.4f}; in turns whole, partial, partial, whole; bound {res['bounds']['fwd']['bound_ms']:.4f}, "
                  f"{res['bounds']['fwd']['bound_by']}; plain f32 {res['plain_ms']['fwd']:.4f}; yardstick, not "
                  f"the same function: cuBLAS bf16 fc1 + fc2 ({n * t}, {d}) x ({d}, {hs}), ({n * t}, {hs}) x "
                  f"({hs}, {d}) {res['cublas_ms']['fwd']:.4f}), row 9a {res['ms']['pro']:.4f} ms (bound "
                  f"{res['bounds']['pro']['bound_ms']:.4f}, {res['bounds']['pro']['bound_by']}; plain f32 "
                  f"{res['plain_ms']['pro']:.4f}; cuBLAS bf16 ({n * t}, {d}) x ({d}, {hs}) "
                  f"{res['cublas_ms']['pro']:.4f}), row 9b {res['ms']['epi']:.4f} ms (bound "
                  f"{res['bounds']['epi']['bound_ms']:.4f}, {res['bounds']['epi']['bound_by']}; plain f32 "
                  f"{res['plain_ms']['epi']:.4f}; cuBLAS bf16 ({n * t}, {hs}) x ({hs}, {d}) "
                  f"{res['cublas_ms']['epi']:.4f})")
        torch.cuda.empty_cache()
    print(f"[{tag}] the phase took {time.perf_counter() - wall:.1f} s")
    return results


def adaln_mlp_function_errors(x, shift, scale, gate, fc1_w, b1, fc2_w, b2, gout) -> dict:
    """`AdalnMlp` (a partial rank's share, bf16 operands) on f32 weights
    of a shard width it pads, with each backward: {bwd: {output or
    gradient: error of max against the plain versions at the true width}}."""
    import torch
    from osu_diffusion_tpu_torch.ops import adaln_mlp as am

    bf16 = torch.bfloat16
    want, a, mlp = am.adaln_mlp_train_reference(x, shift, scale, gate, fc1_w.t(), b1, fc2_w.t(), b2, 1e-6, bf16,
                                                True)
    wants = dict(zip(("dx", "dshift", "dscale", "dgate", "dw1", "db1", "dw2", "db2"), am.adaln_mlp_bwd(
        x, shift, scale, gate, fc1_w, fc2_w, a, mlp, gout, 1e-6, bf16, True)))
    out = {}
    for bwd in ("xla", "fused"):
        ins = [v.detach().clone().requires_grad_() for v in (x, shift, scale, gate, fc1_w, b1, fc2_w, b2)]
        got = am.AdalnMlp.apply(*ins, 1e-6, bf16, bwd, True)
        got.backward(gout)
        out[bwd] = {"out": rel_err(got, want), **{k: rel_err(v.grad, wants[k]) for k, v in zip(wants, ins)}}
    return out


def int8pack_ms(h, wq, s) -> float | None:
    """torch._weight_int8pack_mm (x . (w_q * s)^T, bf16, no bias) timed on
    the card at one int8 product's shape, or None where it does not run on
    CUDA. The port never calls it."""
    import torch

    try:
        fn = lambda: torch._weight_int8pack_mm(h, wq, s.to(h.dtype))  # noqa: E731
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        print(f"[quant] torch._weight_int8pack_mm does not run here: {type(e).__name__}: "
              f"{str(e).splitlines()[0][:160]}")
        return None
    return cuda_ms(fn)


# [quant-xl]: rows 10-13 at DiT-XL's sampling shapes (x (2, 768, 1152),
# H 4608, qkv M 3456, the adaLN projection's 6912 columns over 2 rows)
QUANT_XL_CASES = {"int8_matmul": [("main", (2,), 1152, 6912, None)],
                  "int8_modulated_matmul": [("main", 2, 768, 1152, 3456)],
                  "int8_out_residual": [("main", 2, 768, 1152, 1152)],
                  "adaln_mlp_quant": [("main", 2, 768, 1152, 4608)]}


def phase_quant(dev, tag="quant", xl_cases=None):
    """Rows 10-13 against their plain versions (bf16 operands and int8
    codes, and the f32 dequantised math), the DiT-B sampling shape of each
    first; the same bits on a second call, and each call's body (row 13's
    the one `adaln_plan` names; row 12 takes o in bf16, as the banded
    attention writes it for the int8 block); at the main shape times (row
    13 warm and cold), bounds, the cuBLAS bf16 product of the same shape,
    torch._weight_int8pack_mm of rows 11-13's products, rows 10 and 11's
    kernels alone and the int8 GEMM builds' resources. `xl_cases`
    (QUANT_XL_CASES, under `tag` quant-xl) replace each row's cases."""
    import torch
    from osu_diffusion_tpu_torch.ops import adaln_mlp as am
    from osu_diffusion_tpu_torch.ops import quant as tq

    g = torch.Generator(device=dev).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    if xl_cases is None:
        print(f"[quant] int8 Hopper GEMM builds (ptxas): {mlp_sm90_resources(int8=True)}")
        print(f"[quant] int8_matmul skinny builds (ptxas): {skinny_resources()}")

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def weight(m, k):  # (codes (M, K), scale (M,)) of unit-variance outputs
        return tq.quantize_weight(rnd(m, k, std=k ** -0.5))

    def qkv_like(n, t, d, m):
        mod = rnd(n, 6 * d, std=0.3)
        return (rnd(n, t, d), mod[:, :d], mod[:, d:2 * d], *weight(m, d), rnd(m, std=0.02))

    def out_like(n, t, d, m):  # o in bf16, as row 1 writes it in the int8 block
        return (rnd(n, t, d).to(bf16), rnd(n, t, d), rnd(n, 6 * d, std=0.3)[:, 2 * d:3 * d],
                *weight(d, d), rnd(d, std=0.02))

    def mlp_like(n, t, d, m):  # fc1 (H, D) and fc2 (D, H) codes in torch's layout
        mod = rnd(n, 6 * d, std=0.3)
        (w1q, s1), (w2q, s2) = weight(4 * d, d), weight(d, 4 * d)
        return (rnd(n, t, d), mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:],
                w1q, s1, rnd(4 * d, std=0.02), w2q, s2, rnd(d, std=0.02))

    def adaln_like(lead, k, m, act):
        return (rnd(*lead, k), *weight(m, k), rnd(m, std=0.02), act)

    def mlp_plain(x, shift, scale, gate, w1q, s1, b1, w2q, s2, b2, matmul_dtype):
        return am.adaln_mlp_quant_reference(x, shift, scale, gate, w1q.t(), s1, b1, w2q.t(), s2, b2,
                                            1e-6, matmul_dtype)

    def matmul_plain(x, wq, s, b, act, matmul_dtype):
        return tq.int8_matmul_reference(x, wq, s, b, act, matmul_dtype)

    # name -> (kernel, plain(*args, matmul_dtype), inputs, cases (the main
    # path's shape first), the stage timing run (args, mask) and its stages
    # (rows 10 and 11))
    kernels = {
        "int8_matmul": (tq.int8_matmul, matmul_plain, adaln_like, [
            ("main", (2,), 768, 4608, None), ("r1", (1,), 768, 4608, None),
            ("ragged_rows_gelu", (3, 37), 768, 2304, "gelu_tanh"),
            ("m_not_64_gelu", (100,), 64, 96, "gelu_tanh"), ("k1024", (8, 128), 1024, 1000, None),
            ("r16_gelu", (16,), 768, 4608, "gelu_tanh"), ("r64", (64,), 768, 4608, None),
            ("r96", (96,), 768, 4608, None), ("r256", (256,), 768, 4608, None),
            ("dit_xl", (2,), 1152, 6912, None)],
            None),
        "int8_modulated_matmul": (
            tq.int8_modulated_matmul,
            lambda *a, matmul_dtype: tq.int8_modulated_matmul_reference(*a, 1e-6, matmul_dtype),
            qkv_like, [("main", 2, 768, 768, 2304), ("t757", 2, 757, 768, 2304),
                       ("ragged_t", 3, 50, 768, 2304), ("n8_d384", 8, 128, 384, 1152),
                       ("n6_d1024", 6, 128, 1024, 3072), ("m_not_64", 2, 40, 768, 1000)],
            (lambda args, mask: tq._modulated_launch(*args, 1e-6, bf16, stages=mask),
             (("modulate", 1), ("GEMM", 2)))),
        "int8_out_residual": (
            tq.int8_out_residual, tq.int8_out_residual_reference, out_like,
            [("main", 2, 768, 768, 768), ("t757", 2, 757, 768, 768), ("ragged_t", 3, 50, 768, 768),
             ("n8_d384", 8, 128, 384, 384), ("n6_d1024", 6, 128, 1024, 1024)], None),
        "adaln_mlp_quant": (am.adaln_mlp_quant, mlp_plain, mlp_like, [
            ("main", 2, 768, 768, 3072), ("t757", 2, 757, 768, 3072), ("ragged_t", 3, 50, 768, 3072),
            ("n8_d384", 8, 128, 384, 1536), ("n6_d1024", 6, 128, 1024, 4096)],
            (lambda args, mask: am._quant_launch(*args, 1e-6, bf16, stages=mask),
             (("modulate", 1), ("up", 2), ("down", 4)))),
    }
    results = {}
    for name, (kernel, plain, make, cases, staged) in kernels.items():
        for case, *shape in (cases if xl_cases is None else xl_cases[name]):
            args = make(*shape)
            got = kernel(*args)
            torch.cuda.synchronize()
            body, want_body, plan_note = kernel.body, "sm90", ""
            if name == "int8_matmul":
                x, wq = args[0], args[1]
                plan = tq.adaln_plan(x.numel() // x.shape[-1], x.shape[-1], wq.shape[0], sm_count)
                want_body = plan.body
                plan_note = (f" (plan: GEMM {plan.gemm.width}-wide tiles, {plan.gemm.grid} CTAs)"
                             if plan.gemm is not None else
                             f" (plan: {plan.cw}-column CTAs, row block "
                             f"{plan.row_block}, grid {plan.grid}, {plan.smem_bytes} B shared memory)")
                if plan.gemm is None:
                    lib_smem = tq._lib().int8_matmul_skinny_smem_bytes(plan.k, plan.cw, plan.row_block)
                    check(lib_smem == plan.smem_bytes,
                          f"{name} {case}: the kernel lays out {lib_smem} B, the plan {plan.smem_bytes}")
            # no atomics, one CTA per output tile: the same bits run to run
            same = torch.equal(kernel(*args), got)
            want16 = plain(*args, matmul_dtype=bf16)
            want32 = plain(*args, matmul_dtype=f32)
            e16, e32 = rel_err(got, want16), rel_err(got, want32)
            print(f"[{tag}] {name} {case}: {shape} body {body}{plan_note} max_abs_err bf16="
                  f"{max_err(got, want16):.3e} f32={max_err(got, want32):.3e}; of max |plain| "
                  f"bf16={e16:.2e} (tol {QUANT_TOL_BF16}) f32={e32:.2e} (tol {QUANT_TOL_F32}); "
                  f"same bits on a second call: {same}")
            check(got.shape == want16.shape and bool(torch.isfinite(got).all()),
                  f"{name} {case}: shape {tuple(got.shape)} or non-finite output")
            check(e16 <= QUANT_TOL_BF16, f"{name} {case}: {e16} > {QUANT_TOL_BF16}")
            check(e32 <= QUANT_TOL_F32, f"{name} {case}: {e32} > {QUANT_TOL_F32}")
            check(same, f"{name} {case}: a second call gave other bits")
            check(body == want_body, f"{name} {case}: body {body}, expected {want_body}")
            if case != "main":
                continue
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            if name == "adaln_mlp_quant":
                x, w1q = args[0], args[4]
                rows, d, h = x.shape[0] * x.shape[1], x.shape[2], w1q.shape[0]
                flops = 4 * rows * d * h
                products = [(rows, d, h), (rows, h, d)]
            else:
                wq = tensors[-3]
                rows, k, m = got.numel() // got.shape[-1], wq.shape[1], wq.shape[0]
                flops = 2 * rows * k * m
                products = [(rows, k, m)]
            moved = nbytes(*tensors, got)
            ms = cuda_ms(lambda: kernel(*args))
            launch_us = host_us(lambda: kernel(*args))
            plain_ms = cuda_ms(lambda: plain(*args, matmul_dtype=f32))
            mats = [(torch.randn(r, k, device=dev, dtype=bf16), torch.randn(k, c, device=dev, dtype=bf16))
                    for r, k, c in products]
            cublas_ms = cuda_ms(lambda: [torch.mm(a, b, out_dtype=f32) for a, b in mats])
            library_ms, stages = None, ""
            if staged is not None:
                launch, masks = staged
                stage_ms = {stage: cuda_ms(lambda m=mask: launch(args, m)) for stage, mask in masks}
                stages = (" (kernels alone: " + ", ".join(f"{k} {v:.4f}" for k, v in stage_ms.items())
                          + f"; sum {sum(stage_ms.values()):.4f})")
            if name == "adaln_mlp_quant":
                # the up and down GEMMs beside row 7's over the same codes as
                # bf16 weights (the upcast done ahead, in device memory), in
                # turns: what the on-chip upcast costs each GEMM
                x, shift, scale, gate, w1q, s1, b1, w2q, s2, b2 = args
                wide = (x, shift, scale, gate, w1q.to(bf16), b1, w2q.to(bf16), b2)
                turns = {}
                for kind in ("int8", "bf16", "bf16", "int8"):
                    for stage, mask in (("up", 2), ("down", 4)):
                        fn = ((lambda m=mask: am._quant_launch(*args, 1e-6, bf16, stages=m))
                              if kind == "int8" else
                              (lambda m=mask: am._launch(am.adaln_mlp, *wide, 1e-6, bf16,
                                                         residuals=False, stages=m)))
                        turns.setdefault(f"{kind} {stage}", []).append(cuda_ms(fn))
                print(f"[{tag}] adaln_mlp_quant main: GEMMs alone in turns (int8, bf16, bf16, int8), "
                      "int8 codes against row 7's bf16 weights: " + "; ".join(
                          f"{k} " + ", ".join(f"{v:.4f}" for v in vs) + " ms" for k, vs in turns.items()))
            # the product alone through PyTorch's int8 weight-only call
            if name == "int8_matmul":
                x, wq, s_q, b_q, act = args
                library_ms = int8pack_ms(x.to(bf16), wq, s_q)
                # cold: each call finds its weight copy out of L2
                copies = itertools.cycle([wq.clone() for _ in range(COLD_COPIES)])
                cold_ms = cuda_ms(lambda: kernel(x, next(copies), s_q, b_q, act), iters=2 * COLD_COPIES)
                stages = (f" warm (back to back), {cold_ms:.4f} ms cold (rotating over {COLD_COPIES} "
                          f"weight copies, {COLD_COPIES * wq.numel() / 1e6:.1f} MB)")
            if name == "int8_modulated_matmul":
                x, shift, scale, wq, s_q, _ = args
                hq = (am._layer_norm_f32(x, 1e-6)[0] * (1 + scale[:, None]) + shift[:, None])
                library_ms = int8pack_ms(hq.reshape(-1, hq.shape[-1]).to(bf16), wq, s_q)
            if name == "int8_out_residual":
                o, wq, s_q = args[0], args[3], args[4]
                library_ms = int8pack_ms(o.reshape(-1, o.shape[-1]), wq, s_q)
            b = bound(moved, flops)
            if name == "int8_out_residual":  # the bound before o came in bf16
                f32_o = bound(moved + args[0].numel() * 2, flops)["bound_ms"]
                stages = f" (bound with an f32 o, as before: {f32_o:.4f} ms)"
            library = ("none" if library_ms is None else
                       f"torch._weight_int8pack_mm of its product alone (bf16 out, no bias) {library_ms:.4f} ms")
            print(f"[{tag}] {name} main: kernel {ms:.4f} ms{stages}, plain f32 {plain_ms:.4f} ms, "
                  f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, {moved / 1e6:.2f} MB, "
                  f"{flops:.3e} FLOP); library: {library}; yardstick, not the same function: cuBLAS "
                  f"bf16 product(s) {products} alone {cublas_ms:.4f} ms; host {launch_us:.1f} us per call")
            results[name] = {"max_abs_err": max_err(got, want16), "ms": ms, "plain_ms": plain_ms,
                             **b, "library_ms": library_ms, "cublas_product_ms": cublas_ms}
            if name == "int8_matmul":
                results[name]["cold_ms"] = cold_ms
    return results


def random_state_dict(model, generator):
    """Seeded random weights, none zero: adaLN-Zero's zero adaLN and final
    layer would gate both kernels' outputs out of the result, so those get
    0.02-std normals, as the JAX package's chain tests perturb them."""
    import torch

    sd = {}
    for name, p in model.state_dict().items():
        if name.endswith("playfield_size"):
            sd[name] = p.clone()
        elif "adaLN" in name or "final_layer.linear" in name or p.ndim == 1:
            sd[name] = torch.randn(p.shape, generator=generator) * 0.02
        elif "embedding_table" in name:
            sd[name] = torch.randn(p.shape, generator=generator)
        else:  # (out, in) linear weights, unit-variance outputs
            sd[name] = torch.randn(p.shape, generator=generator) * p.shape[1] ** -0.5
    return sd


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def sample_argv(dev, ckpt_path, results_dir, model=MODEL, steps=STEPS) -> list[str]:
    """The sample CLI at `model` (DiT-B) on kimi: `steps` (STEPS) CFG steps,
    band BAND, seed SEED."""
    return ["--beatmap", BEATMAP, "--ckpt", ckpt_path, "--model", model,
            "--num-classes", str(NUM_CLASSES), "--num-sampling-steps", str(steps),
            "--cfg-scale", str(CFG_SCALE), "--seq-len", str(BAND), "--seed", str(SEED),
            "--device", dev, "--results-dir", results_dir]


def phase_slice(dev, ckpt_path, results_dir, quantize=False, model=MODEL, steps=STEPS, xl=False):
    """The sample CLI at `model` (DiT-B; f32, or int8 with
    --quantize-weights) over `steps` steps: launch counts, the written
    .osu, seconds per denoise step, a profile. `xl`: the [slice-xl] tags.
    Returns (launches of the path's kernels, sampler, its inputs, step ms
    of its replayed chain)."""
    import torch
    from osu_diffusion_tpu_torch.beatmap import Beatmap
    from osu_diffusion_tpu_torch import sampling
    from osu_diffusion_tpu_torch.cli import build_sample_parser, sample_main
    from osu_diffusion_tpu_torch.ops import quant as tq

    runs = []  # (sampler, inputs, output, chain ms, host enqueue ms) of the CLI's chain
    orig_call = sampling.Sampler.__call__

    def timed_call(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        host = time.perf_counter()
        out = orig_call(self, *args, **kwargs)  # the chain never waits for the card
        host = (time.perf_counter() - host) * 1000
        end.record()
        torch.cuda.synchronize()
        runs.append((self, args, out, start.elapsed_time(end), host))
        return out

    sampling.Sampler.__call__ = timed_call
    argv = sample_argv(dev, ckpt_path, results_dir, model, steps)
    tag = ("slice-xl" if xl else "slice") + "-int8" * quantize
    args = build_sample_parser().parse_args(argv + ["--quantize-weights"] * quantize)

    buf = io.StringIO()
    read_counts = reset_launch_counts()
    o_casts = tq.int8_out_residual.o_casts
    wall = time.perf_counter()
    try:
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            written = sample_main(args)
    finally:
        sampling.Sampler.__call__ = orig_call
    wall = time.perf_counter() - wall
    counts = read_counts()
    o_casts = tq.int8_out_residual.o_casts - o_casts
    sampler, call_args, samples, cli_ms, enqueue_ms = runs[-1]
    depth = len(sampler.model.blocks)
    path = (["banded_attention", "int8_matmul", "int8_modulated_matmul", "int8_out_residual",
             "adaln_mlp_quant"] if quantize else ["banded_attention", "adaln_mlp"])
    print(f"[{tag}] launches {counts} (expected {steps} steps x depth {depth} = "
          f"{steps * depth} for each of {path}, 0 for the others), wall {wall:.2f} s; "
          f"f32 o cast to bf16 before the out projection {o_casts} times (0 expected: row 1 "
          f"writes it in bf16)")
    check(o_casts == 0, f"{tag}: {o_casts} casts of o before the out projection")
    if quantize:
        print(f"[{tag}] int8_matmul (row 13) body {tq.int8_matmul.body}")
        check(tq.int8_matmul.body == "sm90_skinny", f"{tag}: row 13 took body {tq.int8_matmul.body}")
    check("seq len 757" in buf.getvalue(), "CLI did not report seq len 757")
    launches = dict.fromkeys(path, steps * depth)
    check(counts == {**dict.fromkeys(counts, 0), **launches}, f"sampling launches {counts}")
    launches = {name: counts[name] for name in launches}
    check(tuple(samples.shape) == (2, 757, 2), f"samples shape {tuple(samples.shape)}")
    check(bool(torch.isfinite(samples).all()), "non-finite coordinates")
    check(len(written) == 1, written)
    hit_objects = Beatmap.from_path(written[0]).hit_objects()
    check(len(hit_objects) > 0, "the written .osu has no hit objects")
    print(f"[{tag}] wrote {written[0]} ({len(hit_objects)} hit objects), "
          f"coords range [{samples.min().item():.3f}, {samples.max().item():.3f}]")

    # the CLI's chain (timed with CUDA events) includes its new Sampler's
    # warm-up step and capture; the steady state is that sampler's chain
    # again, replays of its captured step
    replayed = [chain_ms(dev, sampler, call_args)[1] for _ in range(2)]
    step_ms = min(replayed)
    print(f"[{tag}] denoise chain of the CLI run {cli_ms:.2f} ms (its Sampler's warm-up step and capture "
          f"included), {cli_ms / steps / 1000:.6f} s per denoise step; the host enqueued it in "
          f"{enqueue_ms:.2f} ms. Its sampler's chain replayed: " + ", ".join(
              f"{ms / 1000:.6f}" for ms in replayed) + f" s per denoise step, {1000 / step_ms:.2f} denoise "
          f"steps/s at the better ({model}, T=757 padded to 768, CFG batch 2)")

    # device time by kernel over one more chain
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sampler(*call_args, generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
    # device-side entries only (kernels, copies, memsets): no double counting
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events)
    ptag = ("profile-xl" if xl else "profile") + "-int8" * quantize
    print(f"[{ptag}] device time {device_us / 1000:.2f} ms over {steps} steps, "
          f"{device_us / 1000 / steps:.3f} ms per denoise step ({len(events)} kinds of device op); "
          f"busy {100 * device_us / 1000 / (step_ms * steps):.1f}% of the replayed chain")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[{ptag}]   {e.self_device_time_total / 1000:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    # kernel B's own device time (its Hopper body: MLP_SM90_KERNELS); in the
    # int8 chain the same kernels also run row 11, split by the GEMM's epilogue
    mlp_us = sum(e.self_device_time_total for e in events if any(k in e.key for k in MLP_SM90_KERNELS))
    what = "rows 10, 11 and 12" if quantize else "kernel B"
    print(f"[{tag}] {what} ({', '.join(MLP_SM90_KERNELS)}) {mlp_us / 1000 / steps:.3f} ms of device "
          f"time per denoise step, {100 * mlp_us / max(device_us, 1e-9):.1f}% of the chain's")
    attn_us = sum(e.self_device_time_total for e in events if ATTN_FWD_KERNEL in e.key)
    print(f"[{ptag}] row 1 ({ATTN_FWD_KERNEL}) {attn_us / 1000 / steps:.3f} ms of device time per "
          f"denoise step")
    if quantize:
        skinny_us = sum(e.self_device_time_total for e in events if ADALN_SKINNY_KERNEL in e.key)
        print(f"[{ptag}] row 13 ({ADALN_SKINNY_KERNEL}) {skinny_us / 1000 / steps:.3f} ms of device "
              f"time per denoise step")
        parts = {"modulate passes (rows 10 and 11)": 0.0, "up + down GEMMs (row 10)": 0.0,
                 "qkv GEMM (row 11)": 0.0, "out GEMM (row 12)": 0.0,
                 "cast + ada GEMM (row 13's wide body)": 0.0, "GEMMs of an unread name": 0.0}
        for e in events:
            if MLP_SM90_KERNELS[0] in e.key:
                parts["modulate passes (rows 10 and 11)"] += e.self_device_time_total
            elif "adaln_mlp_cast_kernel" in e.key:
                parts["cast + ada GEMM (row 13's wide body)"] += e.self_device_time_total
            elif MLP_SM90_KERNELS[1] in e.key:
                epi = gemm_epilogue(e.key)
                part = {None: "GEMMs of an unread name", 2: "qkv GEMM (row 11)", 3: "out GEMM (row 12)",
                        4: "cast + ada GEMM (row 13's wide body)"}.get(epi, "up + down GEMMs (row 10)")
                parts[part] += e.self_device_time_total
        print(f"[{ptag}] int8 Hopper bodies, device ms per denoise step: " + ", ".join(
            f"{k} {v / 1000 / steps:.3f}" for k, v in parts.items()))
    return launches, sampler, call_args, step_ms


XL_MODEL = "DiT-XL"
XL_STEPS = 5  # the CLI's sampling steps at XL ([slice-xl], [slice-xl-int8])


@contextlib.contextmanager
def plain_kernels(operands=None):
    """While in use, every kernel wrapper the model calls (rows 1, 7 and
    10-13) is its plain version at bf16 operands (the kernels' contract;
    `operands` another type) with f32 arithmetic, on whatever device its
    tensors lie: the XL forward's reference on the card (TF32 is off in
    main)."""
    import torch
    from osu_diffusion_tpu_torch.models import dit
    from osu_diffusion_tpu_torch.ops import adaln_mlp as am
    from osu_diffusion_tpu_torch.ops import attention as attention_ops
    from osu_diffusion_tpu_torch.ops import banded_attention as ba
    from osu_diffusion_tpu_torch.ops import quant as tq

    bf16 = operands or torch.bfloat16
    plain = {
        (attention_ops, "banded_attention"):
            lambda q, k, v, band, valid_len=None, matmul_dtype=None, out_dtype=None: ba.banded_attention_reference(
                q, k, v, band, q.shape[-2] if valid_len is None else valid_len, bf16).to(out_dtype or q.dtype),
        (dit, "adaln_mlp"): lambda x, shift, scale, gate, w1, b1, w2, b2, eps, matmul_dtype: am.adaln_mlp_reference(
            x, shift, scale, gate, w1.t(), b1, w2.t(), b2, eps, bf16),
        (dit, "adaln_mlp_quant"):
            lambda x, shift, scale, gate, w1q, s1, b1, w2q, s2, b2, eps, matmul_dtype: am.adaln_mlp_quant_reference(
                x, shift, scale, gate, w1q.t(), s1, b1, w2q.t(), s2, b2, eps, bf16),
        (dit, "int8_matmul"): lambda x, w_q, s, b, activation=None, matmul_dtype=None: tq.int8_matmul_reference(
            x, w_q, s, b, activation, bf16),
        (attention_ops, "int8_modulated_matmul"):
            lambda x, shift, scale, w_q, s, b, eps=1e-6, matmul_dtype=None: tq.int8_modulated_matmul_reference(
                x, shift, scale, w_q, s, b, eps, bf16),
        (attention_ops, "int8_out_residual"):
            lambda o, res, gate, w_q, s, b, matmul_dtype=None: tq.int8_out_residual_reference(
                o, res, gate, w_q, s, b, bf16),
    }
    kept = {key: getattr(*key) for key in plain}
    try:
        for (module, name), fn in plain.items():
            setattr(module, name, fn)
        yield
    finally:
        for (module, name), fn in kept.items():
            setattr(module, name, fn)


def phase_xl_forward(dev, sampler, call_args, tag, dtype=None):
    """One XL forward_with_cfg at `sampler`'s inputs (kimi, T 757 padded to
    768, band BAND, t = 500) on the kernels against the same forward with
    every kernel's plain version (bf16 operands, f32 arithmetic) on the
    card, in the same stream: within FORWARD_REL_TOL of max |plain| in the
    f32 stream (the f32 or the int8 model), within BF16_FORWARD_TOL
    absolute for `dtype` bf16, where both forwards' gaps to the plain f32
    stream are printed too (the bf16 stream's own rounding over 28 blocks:
    [slice-bf16] holds DiT-B's to the f32 stream at BF16_FORWARD_TOL). Each
    path kernel launched depth times by the kernels' forward, no kernel by
    the plain one."""
    import torch
    from osu_diffusion_tpu_torch.sampling import _bucketed, _pad_time

    f32 = torch.float32
    z, o, c, y = call_args
    t_real = z.shape[1]
    t_pad = _bucketed(t_real, sampler.bucket)
    t = torch.full((z.shape[0],), 500, dtype=torch.long, device=dev)
    x, op, cp = (_pad_time(a.to(dev), t_pad) for a in (z, o, c))
    depth = len(sampler.model.blocks)

    def forward(stream):
        with torch.no_grad():
            out = sampler.model.forward_with_cfg(x, t, op, cp, y.to(dev), sampler.cfg_scale, band=sampler.band,
                                                 valid_len=t_real, dtype=stream)
        return out[:, :t_real].float()

    read_counts = reset_launch_counts()
    got = forward(dtype or f32)
    torch.cuda.synchronize()
    counts = read_counts()
    path = (["banded_attention", "int8_matmul", "int8_modulated_matmul", "int8_out_residual", "adaln_mlp_quant"]
            if sampler.model.quant else ["banded_attention", "adaln_mlp"])
    check(counts == {**dict.fromkeys(counts, 0), **dict.fromkeys(path, depth)}, f"{tag}: launches {counts}")
    read_counts = reset_launch_counts()
    with plain_kernels():
        want = forward(dtype or f32)
        want32 = forward(f32) if dtype == torch.bfloat16 else want
    check(not any(read_counts().values()), f"{tag}: the plain forward launched a kernel")
    err = max_err(got, want)
    rel = err / want.abs().max().item()
    stream = "bf16 stream" if dtype == torch.bfloat16 else "f32 stream"
    what = f"{XL_MODEL} {'int8 ' * sampler.model.quant}forward_with_cfg"
    tol = f"max_abs tol {BF16_FORWARD_TOL}" if dtype == torch.bfloat16 else f"relative tol {FORWARD_REL_TOL}"
    print(f"[{tag}] {what}, {stream}, at batch {z.shape[0]} x {t_pad} (valid_len {t_real}, band "
          f"{sampler.band}, t 500, depth {depth}), kernels ({depth} launches of each of {path}) vs their "
          f"plain versions on the card in the same stream (bf16 operands, f32 arithmetic, TF32 off): "
          f"max_abs_err {err:.3e}, relative to max |out| {rel:.3e} ({tol}); finite "
          f"{bool(torch.isfinite(got).all())}")
    if dtype == torch.bfloat16:
        gap, plain_gap = max_err(got, want32), max_err(want, want32)
        print(f"[{tag}] against the plain f32 stream (the bf16 stream's own rounding, not a check): "
              f"kernels max_abs {gap:.3e} ({gap / want32.abs().max().item():.3e} of max), plain versions "
              f"max_abs {plain_gap:.3e} ({plain_gap / want32.abs().max().item():.3e} of max)")
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    if dtype == torch.bfloat16:
        check(err <= BF16_FORWARD_TOL, f"{tag}: forward {err} > {BF16_FORWARD_TOL}")
    else:
        check(rel <= FORWARD_REL_TOL, f"{tag}: forward disagrees: {rel} > {FORWARD_REL_TOL}")


XL_TRAIN_STEPS = 6  # [xl-train], [xl-train-fused]: the train CLI's optimizer steps at XL
XL_TRAIN_TIMED = range(2, 4)  # its steady steps timed by CUDA events
XL_TRAIN_PROFILED = range(4, 6)  # and traced by torch.profiler
XL_TRAIN_LOG_EVERY = 2  # a Train Loss line (the mean of 2 steps' losses) every 2 steps
XL_TRAIN_RUNS = ("xla", "fused")  # [xl-train], [xl-train-fused]: one run each
XL_STEP_DEPTH = 4  # [xl-train-step]: DiT-XL's widths at this depth (the CPU side's time)
# [xl-train-cp]: the train CLI at XL on CP_RANKS gloo ranks sharing the card
# (seq-len CP_SEQ, band BAND, --mlp-bwd fused) beside one process: both
# ranks hold the whole model, AdamW and EMA (~15 GB each), so the batch is
# DiT-B's CP batch; step 1 to step 2 is timed
XL_CP_BATCH = CP_BATCH
XL_CP_STEPS = 3
XL_CP_DEPTH = XL_STEP_DEPTH  # [xl-train-cp]'s ranks and one process: XL's widths at this depth


@contextlib.contextmanager
def xl_at_depth(depth: int):
    """DiT_models[XL_MODEL] built `depth` blocks deep inside the block, its
    widths whole (hidden 1152, 16 heads): the train CLI's XL paths at a
    cut depth."""
    from osu_diffusion_tpu_torch.models.dit import DiT, DiT_models

    whole = DiT_models[XL_MODEL]
    DiT_models[XL_MODEL] = lambda **kw: DiT(depth=depth, hidden_size=1152, num_heads=16, **kw)
    try:
        yield
    finally:
        DiT_models[XL_MODEL] = whole


def xl_train_argv(tmp, dev, *flags) -> list[str]:
    """The train CLI at --model DiT-XL and its defaults (global batch
    TRAIN_BATCH, seq-len TRAIN_SEQ, bf16 stream, remat, --mlp-bwd xla) on
    the kimi Track dataset, NUM_CLASSES classes, no checkpoint, plus
    `flags`."""
    return ["--data-path", train_dataset(tmp), "--data-start", "0", "--data-end", "2", "--model", XL_MODEL,
            "--num-classes", str(NUM_CLASSES), "--global-batch-size", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--stride", "16", "--num-workers", "2",
            "--ckpt-every", str(10 ** 9), "--results-dir", os.path.join(tmp, "train-xl"), "--device", dev,
            *flags]


def xl_f32_step(tmp, dev, tag, mlp_bwd, per_block) -> None:
    """One optimizer step of the train CLI at --model DiT-XL, its depth cut
    to XL_STEP_DEPTH (the widths and the CLI's path whole), with
    --no-use-bf16 and --mlp-bwd `mlp_bwd` (the f32 stream: dq and
    dk/dv, and with fused the MLP backward, on their WMMA bodies): a finite
    loss and `per_block`'s launches times the depth."""
    import torch
    from osu_diffusion_tpu_torch.cli import build_train_parser, train_main
    from osu_diffusion_tpu_torch.ops import adaln_mlp as am
    from osu_diffusion_tpu_torch.ops import banded_attention as ba

    read_counts = reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    with xl_at_depth(XL_STEP_DEPTH), contextlib.redirect_stdout(io.StringIO()):
        run = train_main(build_train_parser().parse_args(xl_train_argv(
            tmp, dev, "--no-use-bf16", "--mlp-bwd", mlp_bwd, "--max-steps", "1", "--log-every", "1")))
    per_step = {k: v * XL_STEP_DEPTH for k, v in per_block.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = read_counts()
    bodies = {"dq": ba.banded_attention_bwd_dq.body, "dk/dv": ba.banded_attention_bwd_dkv.body}
    if mlp_bwd == "fused":
        bodies.update(prologue=am.adaln_mlp_bwd_prologue.body, epilogue=am.adaln_mlp_bwd_epilogue.body)
    print(f"[{tag}] --no-use-bf16 at depth {XL_STEP_DEPTH}: step {run['final_step']}, loss {run['last_loss']:.6f}, "
          f"launches {({k: v for k, v in counts.items() if v})}, bodies {bodies}; the run (model set-up, "
          f"loader and the one step) {wall:.1f} s wall, peak device memory allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(run["final_step"] == 1 and math.isfinite(run["last_loss"]), f"{tag} f32: {run}")
    check(set(bodies.values()) == {"wmma"}, f"{tag} f32: bodies {bodies}, expected wmma")
    check(counts == {**dict.fromkeys(counts, 0), **per_step}, f"{tag} f32: launches {counts}")
    del run
    torch.cuda.empty_cache()


def phase_xl_train(dev, tmp):
    """[xl-train] and [xl-train-fused]: the train CLI at --model DiT-XL and
    its defaults, and with --mlp-bwd fused, XL_TRAIN_STEPS optimizer steps
    each, one run each (default, then fused; run_train_cli: every
    logged loss finite; per optimizer step 56 launches of rows 2 and 8, 28
    of rows 3 and 4, with fused 28 of rows 9a and 9b and no plain MLP
    backward, none of another kernel; s per step start to start and inside
    train_step, busy share, peak device memory); then one step of each
    with --no-use-bf16 at depth XL_STEP_DEPTH (xl_f32_step: the f32
    stream, dq, dk/dv and rows 9a/9b on their WMMA bodies, the same
    launches a block, a finite loss)."""
    import torch
    from osu_diffusion_tpu_torch.models.dit import DiT_models
    from osu_diffusion_tpu_torch.ops import adaln_mlp as am
    from osu_diffusion_tpu_torch.ops import banded_attention as ba

    wall = time.perf_counter()
    with torch.device("meta"):  # the depth only
        depth = len(DiT_models[XL_MODEL](num_classes=2).blocks)
    per_step = {"xla": {"banded_attention_fwd_lse": 2 * depth, "adaln_mlp_train": 2 * depth,
                        "banded_attention_bwd_dq": depth, "banded_attention_bwd_dkv": depth}}
    per_step["fused"] = {**per_step["xla"], "adaln_mlp_bwd_prologue": depth, "adaln_mlp_bwd_epilogue": depth}
    runs = {"xla": [], "fused": []}
    for mlp_bwd in XL_TRAIN_RUNS:
        tag = "xl-train" if mlp_bwd == "xla" else "xl-train-fused"
        summary, launches, numbers = run_train_cli(
            tag, xl_train_argv(tmp, dev, "--log-every", str(XL_TRAIN_LOG_EVERY), "--mlp-bwd", mlp_bwd),
            XL_TRAIN_STEPS, mlp_bwd, profiled=XL_TRAIN_PROFILED, model=XL_MODEL, timed=XL_TRAIN_TIMED,
            log_every=XL_TRAIN_LOG_EVERY)
        bodies = {"forward": ba.banded_attention_fwd_lse.body, "dq": ba.banded_attention_bwd_dq.body,
                  "dk/dv": ba.banded_attention_bwd_dkv.body}
        if mlp_bwd == "fused":
            bodies.update(prologue=am.adaln_mlp_bwd_prologue.body, epilogue=am.adaln_mlp_bwd_epilogue.body)
        print(f"[{tag}] launches per optimizer step: "
              + ", ".join(f"{k} {launches[k] / XL_TRAIN_STEPS:g}" for k in per_step[mlp_bwd])
              + f" (expected {per_step[mlp_bwd]}); bodies {bodies}")
        check(set(bodies.values()) == {"sm90"}, f"{tag}: the bf16 stream's bodies {bodies}")
        runs[mlp_bwd].append(numbers)
        del summary
        torch.cuda.empty_cache()
    for mlp_bwd in ("xla", "fused"):
        xl_f32_step(tmp, dev, "xl-train" if mlp_bwd == "xla" else "xl-train-fused", mlp_bwd,
                    {k: v // depth for k, v in per_step[mlp_bwd].items()})

    def each(key, scale=1.0, fmt=".6f"):
        return {k: ", ".join(f"{v[key] * scale:{fmt}}" for v in r) for k, r in runs.items()}

    period, inside = each("period_ms", 1e-3), each("step_ms", 1e-3)
    device, busy, peak = each("device_ms", fmt=".2f"), each("busy", fmt=".1f"), each("peak_gb", fmt=".2f")
    print(f"[xl-train-fused] {XL_MODEL} train CLI ({depth} blocks, batch {TRAIN_BATCH} x {TRAIN_SEQ}), runs "
          f"{XL_TRAIN_RUNS}: s per optimizer step start to start, fused {period['fused']} "
          f"against default {period['xla']}; inside train_step fused {inside['fused']} against "
          f"{inside['xla']}; device ms a step fused {device['fused']} against {device['xla']}; busy % "
          f"fused {busy['fused']} against {busy['xla']}; peak GB fused {peak['fused']} against "
          f"{peak['xla']}; the phase took {time.perf_counter() - wall:.1f} s")
    return runs


def phase_xl_train_cp(dev, tmp, card):
    """[xl-train-cp]: the train CLI at --model DiT-XL with --num-model 2
    --context-parallel --dist gloo --mlp-bwd fused on CP_RANKS ranks
    sharing the card (this script with --cp-rank, train only; the weights
    sharded over them, as the trainer holds them with model ranks) beside
    one process of the same seed, flags and batch, both at XL's widths with
    the depth cut to XL_CP_DEPTH: every logged loss finite and within
    CP_LOSS_REL_TOL of the one process's; per optimizer step on every rank
    2 x depth launches of row 5 with LSE and of row 8, depth of row 6's dq
    and dk/dv and of rows 9a/9b, none of rows 2-4; s per step and each
    rank's peak of allocated device memory."""
    wall = time.perf_counter()
    workdir = os.path.join(tmp, "cp-xl")
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "job.json"), "w") as f:
        json.dump({"data": train_dataset(tmp), "train_only": True, "model": XL_MODEL, "batch": XL_CP_BATCH,
                   "steps": XL_CP_STEPS, "flags": ["--mlp-bwd", "fused"], "xl_depth": XL_CP_DEPTH}, f)
    ranks = run_cp_ranks(workdir, CP_RANKS, "xl-train-cp")
    cp_wall = time.perf_counter() - wall
    single = run_cp_ranks(workdir, 1, "xl-train-cp")[0]
    depth = XL_CP_DEPTH
    steps = XL_CP_STEPS
    fused = {"adaln_mlp_train": steps * depth * 2, "adaln_mlp_bwd_prologue": steps * depth,
             "adaln_mlp_bwd_epilogue": steps * depth}
    expected_cp = {**dict.fromkeys(ranks[0]["train_launches"], 0), **fused,
                   "banded_attention_ranged_fwd_lse": steps * depth * 2,  # forward + remat recompute
                   "banded_attention_ranged_bwd_dq": steps * depth,
                   "banded_attention_ranged_bwd_dkv": steps * depth}
    expected_one = {**dict.fromkeys(expected_cp, 0), **fused, "banded_attention_fwd_lse": steps * depth * 2,
                    "banded_attention_bwd_dq": steps * depth, "banded_attention_bwd_dkv": steps * depth}
    for rank, r in enumerate(ranks):
        print(f"[xl-train-cp] rank {rank} of {CP_RANKS}: {r['final_step']} steps, launches {r['train_launches']}, "
              f"peak device memory allocated {r['peak_gb']:.2f} GB")
        check(r["final_step"] == steps and r["train_launches"] == expected_cp,
              f"xl-train-cp rank {rank}: {r['final_step']} steps, launches {r['train_launches']}")
    print(f"[xl-train-cp] one process: launches {single['train_launches']}, peak {single['peak_gb']:.2f} GB")
    check(single["train_launches"] == expected_one, f"xl-train-cp one process launches {single['train_launches']}")
    cp_losses, one_losses = ranks[0]["losses"], single["losses"]
    diffs = [abs(a - b) / abs(b) for a, b in zip(cp_losses, one_losses)]
    print(f"[xl-train-cp] losses CP {cp_losses}; one process {one_losses}; relative differences "
          + ", ".join(f"{d:.2e}" for d in diffs) + f" (tol {CP_LOSS_REL_TOL})")
    check(len(cp_losses) == len(one_losses) == steps and all(math.isfinite(v) for v in cp_losses + one_losses),
          f"xl-train-cp losses {cp_losses} {one_losses}")
    check(max(diffs) <= CP_LOSS_REL_TOL, f"xl-train-cp losses differ: {diffs}")
    check(ranks[0]["done"] and ranks[0]["mesh_line"], "xl-train-cp: no Done! or no mesh line in rank 0's log")
    print(f"[xl-train-cp] {card}: {XL_MODEL} widths at depth {depth} (batch {XL_CP_BATCH} x {CP_SEQ}, band {BAND}, bf16 "
          f"stream, remat, --mlp-bwd fused): {ranks[0]['period_ms'] / 1000:.6f} s per optimizer step start to "
          f"start with {CP_RANKS} gloo ranks sharing the card (rank 1 {ranks[1]['period_ms'] / 1000:.6f}), "
          f"{single['period_ms'] / 1000:.6f} s in one process; peak device memory allocated "
          + " + ".join(f"{r['peak_gb']:.2f}" for r in ranks) + f" = {sum(r['peak_gb'] for r in ranks):.2f} GB on "
          f"the card, one process {single['peak_gb']:.2f} GB; wall {ranks[0]['wall_s']:.1f} s and "
          f"{single['wall_s']:.1f} s for {steps} steps; the CP ranks' run took {cp_wall:.1f} s, the phase "
          f"{time.perf_counter() - wall:.1f} s")
    return ranks[0]["train_launches"]


def phase_xl(dev, tmp, card):
    """DiT-XL serving: a seeded random-weight XL checkpoint (52670 classes),
    the sample CLI at --model DiT-XL on kimi over XL_STEPS steps, f32
    ([slice-xl]) and --quantize-weights ([slice-xl-int8]): launch counts
    (XL_STEPS x 28 of rows 1 and 7, or of rows 1 and 10-13), the .osu
    reparsed, s per denoise step, device ms per step and the busy share;
    one XL forward of each stream against its plain versions on the card
    ([xl-forward], [xl-bf16-forward], [xl-int8-forward]). DiT-XL training:
    one step's loss and gradients card against CPU at XL's widths, depth
    cut to XL_STEP_DEPTH ([xl-train-step]), the train CLI at --model DiT-XL
    and with --mlp-bwd fused ([xl-train], [xl-train-fused]: phase_xl_train)
    and under context parallelism ([xl-train-cp]: phase_xl_train_cp)."""
    import torch
    from osu_diffusion_tpu_torch.models.dit import DiT, DiT_models
    from osu_diffusion_tpu_torch.sampling import Sampler

    wall = time.perf_counter()
    model = DiT_models[XL_MODEL](num_classes=NUM_CLASSES)
    sd = random_state_dict(model, torch.Generator().manual_seed(SEED))
    ckpt = os.path.join(tmp, "dit_xl_random.pt")
    torch.save({"ema": sd}, ckpt)
    params = sum(p.numel() for p in sd.values())
    del model, sd
    print(f"[slice-xl] random {XL_MODEL} checkpoint: {params / 1e6:.1f} M values, "
          f"{os.path.getsize(ckpt) / 1e9:.2f} GB, written in {time.perf_counter() - wall:.1f} s")
    launches, sampler, call_args, f32_ms = phase_slice(dev, ckpt, os.path.join(tmp, "results-xl"),
                                                       model=XL_MODEL, steps=XL_STEPS, xl=True)
    phase_xl_forward(dev, sampler, call_args, "xl-forward")
    phase_xl_forward(dev, sampler, call_args, "xl-bf16-forward", dtype=torch.bfloat16)
    # [graph-xl]: the CLI's graphed chain against the same chain eager, in turns
    eager = Sampler(sampler.model, sampler.diffusion, cfg_scale=CFG_SCALE, band=BAND, cuda_graph=False)
    chains = {name: (lambda s=s: s(*call_args, generator=torch.Generator(device=dev).manual_seed(SEED)))
              for name, s in (("graph", sampler), ("eager", eager))}
    chains["eager"]()  # its warm-up (the graphed sampler's chain is captured)
    turns = ms_per_step_in_turns(chains, XL_STEPS, GRAPH_ROUNDS)
    device = {name: device_ms_per_step(run, XL_STEPS) for name, run in chains.items()}
    ms = {k: statistics.median(v) for k, v in turns.items()}
    print(f"[graph-xl] {card}: {XL_MODEL} f32 chain on kimi (T 757 -> 768, CFG 2, band {BAND}), s per denoise "
          f"step in turns (graph, eager, eager, graph): graph " + ", ".join(f"{v / 1000:.6f}" for v in turns["graph"])
          + " against eager " + ", ".join(f"{v / 1000:.6f}" for v in turns["eager"])
          + f"; medians {ms['graph'] / 1000:.6f} against {ms['eager'] / 1000:.6f} ({ms['eager'] / ms['graph']:.3f}x); "
          f"device ms a step {device['graph']:.3f} against {device['eager']:.3f}, busy "
          f"{100 * device['graph'] / ms['graph']:.1f}% against {100 * device['eager'] / ms['eager']:.1f}%")
    del sampler, eager, chains
    int8_launches, qsampler, _, int8_ms = phase_slice(dev, ckpt, os.path.join(tmp, "results-xl-int8"),
                                                      quantize=True, model=XL_MODEL, steps=XL_STEPS, xl=True)
    phase_xl_forward(dev, qsampler, call_args, "xl-int8-forward")
    del qsampler
    os.remove(ckpt)
    step_wall = time.perf_counter()
    phase_train_step_vs_plain(dev, tag="xl-train-step", model=DiT(
        depth=XL_STEP_DEPTH, hidden_size=1152, num_heads=16, num_classes=NUM_CLASSES, class_dropout_prob=0.2),
        what=f"{XL_MODEL} widths at depth {XL_STEP_DEPTH}")
    print(f"[xl-train-step] {time.perf_counter() - step_wall:.1f} s")
    phase_xl_train(dev, tmp)
    phase_xl_train_cp(dev, tmp, card)
    print(f"[slice-xl] {card}: {XL_MODEL} on kimi (T 757 -> 768, CFG batch 2, band {BAND}), "
          f"{f32_ms / 1000:.6f} s per denoise step f32, {int8_ms / 1000:.6f} int8 (--quantize-weights); "
          f"launches per chain f32 {launches}, int8 {int8_launches}; the phase took "
          f"{time.perf_counter() - wall:.1f} s")


def gemm_epilogue(name: str) -> int | None:
    """The epilogue (0 up, 1 down, 2 qkv, 3 out, 4 ada) of an adaln_mlp_gemm_kernel build
    from its name in a profile (demangled or not), or None."""
    m = re.search(r"adaln_mlp_gemm_kernel(?:<\d+, (\d)|ILi\d+ELi(\d)E)", name)
    return None if m is None else int(m[1] or m[2])


def phase_forward_vs_plain(dev, sampler, call_args, tag="forward", f32_model=None, use_cfg=True,
                           step=500):
    """One DiT-B forward at `sampler`'s inputs call_args (z, o, c, y), padded
    to its bucket with the real length as valid_len, at its band and at
    timestep `step`, on the card (kernels) and on the CPU (plain bf16
    versions), same weights: the whole model against its plain versions, at
    the shapes its path gives the kernels (kimi: forward_with_cfg, T padded
    to 768, valid 757; the evals: the plain forward at batch 100 over the
    128-row bucket). (A whole chain is no fair check: at t near T the x0
    prediction is x / sqrt(alpha_bar) - ..., a ~1e4 gain that makes the
    clamp to [-1, 2] decide on ulp-level eps differences.) Returns the
    outputs by where they ran ("cpu": the CPU's f32-stream forward)."""
    import copy

    import torch
    from osu_diffusion_tpu_torch.sampling import _bucketed, _pad_time

    z, o, c, y = call_args
    t_real = z.shape[1]
    t_pad = _bucketed(t_real, sampler.bucket)
    t = torch.full((z.shape[0],), step, dtype=torch.long)
    kwargs = dict(band=sampler.band, valid_len=t_real)
    what = "forward_with_cfg" if use_cfg else "forward"
    outs = {}
    # name -> (model, device): the card's kernels, the CPU's plain versions,
    # and the f32 model on the card for the quantisation error
    runs = {dev: (sampler.model, dev), "cpu": (copy.deepcopy(sampler.model).to("cpu"), "cpu")}
    if f32_model is not None:
        runs["f32"] = (f32_model, dev)
    with torch.no_grad():
        for where, (model, on) in runs.items():
            x, op, cp = (_pad_time(a.to(on), t_pad) for a in (z, o, c))
            out = (model.forward_with_cfg(x, t.to(on), op, cp, y.to(on), sampler.cfg_scale, **kwargs)
                   if use_cfg else model.forward(x, t.to(on), op, cp, y.to(on), **kwargs))
            outs[where] = out[:, :t_real].cpu()
    err = max_err(outs[dev], outs["cpu"])
    rel = err / outs["cpu"].abs().max().item()
    print(f"[{tag}] DiT-B {what} at batch {z.shape[0]} x {t_pad} (valid_len {t_real}, band "
          f"{sampler.band}, t {step}), card kernels vs CPU plain bf16: max_abs_err {err:.3e}, "
          f"relative to max |out| {rel:.3e} (tol {FORWARD_REL_TOL})")
    check(rel <= FORWARD_REL_TOL and bool(torch.isfinite(outs[dev]).all()),
          f"{tag}: forward disagrees: {rel} > {FORWARD_REL_TOL}")
    if f32_model is not None:
        # the host's cost of one block call, f32 and int8, at these inputs
        x = _pad_time(z.to(dev), t_pad)
        with torch.no_grad():
            h = sampler.model.xoc_embedder(x, _pad_time(o.to(dev), t_pad), _pad_time(c.to(dev), t_pad))
            cond = sampler.model.t_embedder(t.to(dev)) + sampler.model.y_embedder(y.to(dev))
            per_block = {name: host_us(lambda m=m: m.blocks[0](h, cond, sampler.band, t_real, m.matmul_dtype))
                         for name, m in (("f32", f32_model), ("int8", sampler.model))}
        print(f"[{tag}] host per block call: f32 {per_block['f32']:.1f} us, int8 {per_block['int8']:.1f} us")
        gap = max_err(outs[dev], outs["f32"])
        print(f"[{tag}] quantisation error on the card, int8 vs f32 forward (same weights): "
              f"max_abs {gap:.3e}, relative to max |f32 out| "
              f"{gap / outs['f32'].abs().max().item():.3e} (printed, not a kernel check)")
    return outs


class RecordingCalls:
    """While in use, records every call of the Sampler methods `names`
    ("__call__", "refine") in `calls`: (name, sampler, args, kwargs,
    output, wall seconds with the card waited for)."""

    def __init__(self, *names):
        from osu_diffusion_tpu_torch import sampling

        self.cls, self.calls = sampling.Sampler, []
        self.originals = {name: getattr(self.cls, name) for name in names}

    def __enter__(self):
        import torch

        def recording(name, orig):
            def call(sampler, *args, **kwargs):
                torch.cuda.synchronize()
                wall = time.perf_counter()
                out = orig(sampler, *args, **kwargs)
                torch.cuda.synchronize()
                self.calls.append((name, sampler, args, kwargs, out, time.perf_counter() - wall))
                return out
            return call

        for name, orig in self.originals.items():
            setattr(self.cls, name, recording(name, orig))
        return self

    def __exit__(self, *exc):
        for name, orig in self.originals.items():
            setattr(self.cls, name, orig)


def run_cli(dev, ckpt_path, results_dir, flags):
    """One sample CLI run at DiT-B on kimi with extra `flags`: (each
    kernel's launches in it, the paths written, the (name, sampler, args,
    kwargs) of each Sampler call and refine pass it made)."""
    from osu_diffusion_tpu_torch.cli import build_sample_parser, sample_main

    args = build_sample_parser().parse_args(sample_argv(dev, ckpt_path, results_dir) + list(flags))
    read_counts = reset_launch_counts()
    with RecordingCalls("__call__", "refine") as rec, contextlib.redirect_stdout(io.StringIO()):
        written = sample_main(args)
    return read_counts(), written, [call[:4] for call in rec.calls]


def check_written(tag, written, n, suffix=""):
    """The CLI wrote `n` .osu files, the last ending in `suffix`.osu, each of
    which reparses with hit objects."""
    from osu_diffusion_tpu_torch.beatmap import Beatmap

    check(len(written) == n and written[-1].endswith(f"{suffix}.osu"), f"{tag}: wrote {written}")
    for path in written:
        check(len(Beatmap.from_path(path).hit_objects()) > 0, f"{tag}: {path} has no hit objects")


def check_launches(tag, counts, expected):
    """Each kernel in `expected` launched that many times, every other 0."""
    print(f"[{tag}] launches {({k: v for k, v in counts.items() if v})} (expected {expected}, "
          f"0 for the others)")
    check(counts == {**dict.fromkeys(counts, 0), **expected}, f"{tag}: launches {counts}")


def chain_ms(dev, sampler, call_args, **kwargs):
    """(output, ms per denoise step) of one chain of `sampler` on call_args
    with a fresh generator of SEED, CUDA events around it."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = sampler(*call_args, generator=torch.Generator(device=dev).manual_seed(SEED), **kwargs)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / sampler.diffusion.num_timesteps


def chain_profile(dev, sampler, call_args, host_ops=True, **kwargs):
    """Device ms per denoise step of one more chain, by device op (kernels,
    copies, memsets; torch.profiler, without recording host ops unless
    `host_ops`): (total, [(ms per step, calls, name)] largest first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        sampler(*call_args, generator=torch.Generator(device=dev).manual_seed(SEED), **kwargs)
        torch.cuda.synchronize()
    steps = sampler.diffusion.num_timesteps
    ops = sorted(((e.self_device_time_total / 1000 / steps, e.count, e.key) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
                 reverse=True)
    check(len(ops) > 0, "the profiler saw no device op")
    return sum(op[0] for op in ops), ops


def chains_in_turns(dev, tag, samplers, call_args, rounds=3):
    """Ms per denoise step of each sampler's chain, every sampler once a
    round, the order reversed each round (the host's speed drifts within a
    call): {name: [ms of each round]}, printed with the medians."""
    order = list(samplers)
    turns = {name: [] for name in order}
    for r in range(rounds):
        for name in order[::-1] if r % 2 else order:
            turns[name].append(chain_ms(dev, samplers[name], call_args)[1])
    print(f"[{tag}] in turns ({rounds} rounds, order reversed each round), s per denoise step: " + "; ".join(
        f"{name} " + ", ".join(f"{ms / 1000:.6f}" for ms in v) for name, v in turns.items()))
    return turns


GRAPH_INTERVAL = 3  # [graph]: the fixed Δ-cache's interval
GRAPH_SHORT_T = 700  # [graph]: a second kimi length in the 768-row bucket
GRAPH_ROUNDS = 2  # [graph]: rounds of graph against eager in turns


def device_ms_per_step(run, steps) -> float:
    """Device ms per step of one more run() (kernels, copies, memsets by
    torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0)
    check(us > 0, "the profiler saw no device op")
    return us / 1000 / steps


def ms_per_step_in_turns(runs: dict, steps: int, rounds: int) -> dict:
    """{name: [ms per step of each round]}: every run once a round, the
    order reversed each round, CUDA events around each."""
    import torch

    order, out = list(runs), {name: [] for name in runs}
    for r in range(rounds):
        for name in order[::-1] if r % 2 else order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            runs[name]()
            end.record()
            torch.cuda.synchronize()
            out[name].append(start.elapsed_time(end) / steps)
    return out


@contextlib.contextmanager
def no_host_sync():
    """torch.cuda.set_sync_debug_mode("error") over the block (a host sync
    raises), but for the adaptive Δ-cache's one read of its full steps at a
    chain's end (`Chain.full_steps`)."""
    import torch
    from osu_diffusion_tpu_torch import sampling

    orig = sampling.Chain.full_steps

    def read_at_the_end(chain, steps):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return orig(chain, steps)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    sampling.Chain.full_steps = read_at_the_end
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        sampling.Chain.full_steps = orig


def eager_drifts(model, diffusion, call_args, **kw) -> dict:
    """{drift mode: [each step's drift]} of a tau-0 adaptive chain (every
    step full: each drift is one step's) on a cuda_graph=False sampler, both
    modes read at every step (an .item() cannot run inside a capture)."""
    import torch
    from osu_diffusion_tpu_torch import sampling

    drifts = {mode: [] for mode in sampling.ACCEL_DRIFTS}
    orig = sampling.drift

    def recorded(x, x_ref, per_sample_max):
        for mode in drifts:
            drifts[mode].append(orig(x, x_ref, mode == "per_sample_max").item())
        return orig(x, x_ref, per_sample_max)

    sampler = sampling.Sampler(model, diffusion, cfg_scale=CFG_SCALE, band=BAND, accel_tau=0.0,
                               cuda_graph=False, **kw)
    sampling.drift = recorded
    try:
        sampler(*call_args, generator=torch.Generator(device=call_args[0].device).manual_seed(SEED))
    finally:
        sampling.drift = orig
    return drifts


def phase_graph(dev, samplers, call_args, card):
    """[graph] (25): each chain kind on the graphed Sampler against the same
    chain eager, for the models of `samplers` ({"f32": ..., "int8": ...},
    the [slice] samplers: their models and diffusion)."""
    import torch
    from osu_diffusion_tpu_torch.sampling import Sampler

    wall = time.perf_counter()
    z, o, c, y = call_args
    g = torch.Generator(device=dev).manual_seed(4)
    known_x = torch.rand(z.shape, generator=g, device=dev)
    free = torch.ones(z.shape, dtype=torch.bool, device=dev)
    free[:, z.shape[1] // 2:] = False  # False: pinned to known_x
    lengths = {z.shape[1]: call_args, GRAPH_SHORT_T: tuple(a[:, :GRAPH_SHORT_T] for a in (z, o, c)) + (y,)}
    chains = [("ancestral", {}), ("ddim", dict(method="ddim")),
              (f"fixed Δ-cache interval {GRAPH_INTERVAL}", dict(accel_interval=GRAPH_INTERVAL, accel_span=ACCEL_SPAN)),
              ("in-painting", {}), ("refine", {})]
    for stream, base in samplers.items():
        model, diffusion = base.model, base.diffusion
        depth = len(model.blocks)
        kernels = (["banded_attention", "int8_matmul", "int8_modulated_matmul", "int8_out_residual",
                    "adaln_mlp_quant"] if model.quant else ["banded_attention", "adaln_mlp"])
        # the adaptive Δ-cache at the median of the one-step drifts, so both bodies run
        drifts = eager_drifts(model, diffusion, call_args, accel_span=ACCEL_SPAN)
        adaptive = [(f"adaptive Δ-cache {mode} tau {statistics.median(d[1:-1]):.4f} (median one-step drift)",
                     dict(accel_tau=statistics.median(d[1:-1]), accel_drift=mode, accel_span=ACCEL_SPAN))
                    for mode, d in drifts.items()]
        for name, kw in chains + adaptive:
            tag = f"[graph] {stream} {name}"
            graph, eager = (Sampler(model, diffusion, cfg_scale=CFG_SCALE, band=BAND, cuda_graph=on, **kw)
                            for on in (True, False))
            steps = REFINE_ITERS if name == "refine" else STEPS
            is_adaptive = "accel_tau" in kw

            def run(sampler, t):
                args = lengths[t]
                gen = torch.Generator(device=dev).manual_seed(SEED)
                if name == "refine":
                    return sampler.refine(*args, REFINE_ITERS, generator=gen)
                extra = dict(known_x=known_x[:, :t], known_mask=free[:, :t]) if name == "in-painting" else {}
                return sampler(*args, generator=gen, **extra)

            def expected(full):
                return accel_launches(kernels, full, steps - full, depth) if full is not None else \
                    dict.fromkeys(kernels, steps * depth)

            out, full = {}, {}
            read_counts = reset_launch_counts()
            first = time.perf_counter()
            for t in lengths:
                out["graph", t] = run(graph, t)
                full["graph", t] = graph.last_full_model_steps
            torch.cuda.synchronize()
            first = time.perf_counter() - first
            first_counts = read_counts()
            # twice the schedule; the adaptive warm-up also ran each body once
            want = {k: sum(expected(full["graph", t])[k] for t in lengths)
                    + is_adaptive * accel_launches(kernels, 1, 1, depth)[k] for k in kernels}
            # the replayed chain: no host sync may happen inside it
            read_counts = reset_launch_counts()
            with no_host_sync():
                replayed = run(graph, z.shape[1])
            torch.cuda.synchronize()
            replay_counts, replay_full = read_counts(), graph.last_full_model_steps
            for t in lengths:
                out["eager", t] = run(eager, t)
                full["eager", t] = eager.last_full_model_steps
            torch.cuda.synchronize()
            entries = list(graph._cache.values())
            captures = [e.captures for e in entries]
            graphs = [gr for e in entries for gr in e.graphs.values()]
            same = {t: torch.equal(out["graph", t], out["eager", t]) for t in lengths}
            same_full = (all(full["graph", t] == full["eager", t] for t in lengths)
                         and replay_full == full["graph", z.shape[1]])
            same_replay = torch.equal(replayed, out["graph", z.shape[1]])
            finite = all(bool(torch.isfinite(v).all()) for v in out.values())
            fulls = (f"; full steps graph, eager at T {', '.join(f'{t}: {full['graph', t]}, {full['eager', t]}' for t in lengths)}, "
                     f"replayed {replay_full}" if is_adaptive else "")
            print(f"{tag}: graph against eager bit for bit at T {', '.join(f'{t}: {v}' for t, v in same.items())}; "
                  f"the replayed chain's bits the first's: {same_replay}{fulls}; cache entries {len(entries)}, captures "
                  f"{captures}; launches in the two first chains {({k: v for k, v in first_counts.items() if v})} "
                  f"(expected {want}), in the replayed chain "
                  f"{({k: v for k, v in replay_counts.items() if v})} (expected {expected(replay_full)}), no host sync "
                  f"in it (sync debug mode 'error'{', but the read of n_full at its end' * is_adaptive}); capture "
                  f"{sum(gr.capture_ms for gr in graphs):.1f} ms, "
                  f"pool {sum(gr.pool_bytes for gr in graphs) / 2 ** 20:.1f} MiB; the two first chains "
                  f"{first:.2f} s")
            check(finite and all(same.values()) and same_replay and same_full,
                  f"{tag}: graph against eager {same}, replay {same_replay}, full steps {full} {replay_full}, "
                  f"finite {finite}")
            check(len(entries) == 1 and all(n == 1 for n in captures[0].values()), f"{tag}: captures {captures}")
            check(first_counts == {**dict.fromkeys(first_counts, 0), **want}, f"{tag}: first launches {first_counts}")
            check(replay_counts == {**dict.fromkeys(replay_counts, 0), **expected(replay_full)},
                  f"{tag}: replayed launches {replay_counts}")
            t = z.shape[1]
            turns = ms_per_step_in_turns({"graph": lambda: run(graph, t), "eager": lambda: run(eager, t)},
                                         steps, GRAPH_ROUNDS)
            ms = {k: statistics.median(v) for k, v in turns.items()}
            device = {k: device_ms_per_step(lambda s=s: run(s, t), steps) for k, s in
                      (("graph", graph), ("eager", eager))}
            print(f"{tag}: {card}: s per denoise step in turns (graph, eager, eager, graph) graph "
                  + ", ".join(f"{v / 1000:.6f}" for v in turns["graph"]) + " against eager "
                  + ", ".join(f"{v / 1000:.6f}" for v in turns["eager"])
                  + f"; medians {ms['graph'] / 1000:.6f} against {ms['eager'] / 1000:.6f} "
                  f"({ms['eager'] / ms['graph']:.3f}x); device ms a step {device['graph']:.3f} against "
                  f"{device['eager']:.3f}, busy {100 * device['graph'] / ms['graph']:.1f}% against "
                  f"{100 * device['eager'] / ms['eager']:.1f}%")
            del graph, eager, out, replayed
            torch.cuda.empty_cache()
    print(f"[graph] the phase took {time.perf_counter() - wall:.1f} s")


def phase_slice_ddim(dev, ckpt_path, tmp):
    """[slice-ddim]: the sample CLI with --sampling-method ddim: rows 1 and
    7 launched steps x depth times, the .osu reparses. Returns its sampler."""
    counts, written, calls = run_cli(dev, ckpt_path, os.path.join(tmp, "results-ddim"),
                                     ["--sampling-method", "ddim"])
    _, sampler, args, _ = calls[-1]
    depth = len(sampler.model.blocks)
    check(sampler.method == "ddim", f"slice-ddim: method {sampler.method}")
    check_launches("slice-ddim", counts, dict.fromkeys(("banded_attention", "adaln_mlp"), STEPS * depth))
    check_written("slice-ddim", written, 1)
    device_ms, _ = chain_profile(dev, sampler, args, host_ops=False)
    print(f"[slice-ddim] wrote {os.path.basename(written[0])}; device {device_ms:.3f} ms per step")
    return sampler, device_ms


def phase_slice_bf16(dev, ckpt_path, tmp, call_args, cpu_out):
    """[slice-bf16]: the sample CLI with --compute-dtype bf16: rows 1 and 7
    launched steps x depth times on the bf16 stream, the .osu reparses; s
    per denoise step and the device time by kernel; one bf16 forward on the
    card against the CPU's f32-stream forward (`cpu_out`, at
    phase_forward_vs_plain's inputs: call_args at t = 500); rows 1 and 7 on
    bf16 inputs at the sampling shape against their plain versions.
    Returns its sampler and device ms per step."""
    import torch
    from osu_diffusion_tpu_torch.ops.adaln_mlp import adaln_mlp, adaln_mlp_reference
    from osu_diffusion_tpu_torch.ops.banded_attention import banded_attention, banded_attention_reference
    from osu_diffusion_tpu_torch.sampling import _bucketed, _pad_time

    bf16 = torch.bfloat16
    counts, written, calls = run_cli(dev, ckpt_path, os.path.join(tmp, "results-bf16"),
                                     ["--compute-dtype", "bf16"])
    _, sampler, args, _ = calls[-1]
    depth = len(sampler.model.blocks)
    print(f"[slice-bf16] row 1 body {banded_attention.body}, row 7 body {adaln_mlp.body}")
    check(sampler.compute_dtype == bf16, f"slice-bf16: stream {sampler.compute_dtype}")
    check(banded_attention.body == adaln_mlp.body == "sm90",
          f"slice-bf16: bodies {banded_attention.body}, {adaln_mlp.body}")
    check_launches("slice-bf16", counts, dict.fromkeys(("banded_attention", "adaln_mlp"), STEPS * depth))
    check_written("slice-bf16", written, 1)
    out, _ = chain_ms(dev, sampler, args)
    check(out.dtype == torch.float32 and bool(torch.isfinite(out).all()), "slice-bf16: samples")
    device_ms, ops = chain_profile(dev, sampler, args)
    print(f"[slice-bf16] device {device_ms:.3f} ms per step ({len(ops)} kinds of device op)")
    for ms, n, name in ops[:8]:
        print(f"[slice-bf16]   {ms:9.4f} ms per step  {n:6d}x  {name[:90]}")
    row1 = sum(ms for ms, _, name in ops if ATTN_FWD_KERNEL in name)
    row7 = sum(ms for ms, _, name in ops if any(k in name for k in MLP_SM90_KERNELS))
    print(f"[slice-bf16] row 1 {row1:.3f} ms, kernel B {row7:.3f} ms of device time per denoise step")

    # one forward, bf16 stream on the card against the f32 stream on the CPU
    z, o, c, y = call_args
    t_real = z.shape[1]
    t_pad = _bucketed(t_real, sampler.bucket)
    t = torch.full((z.shape[0],), 500, dtype=torch.long, device=dev)
    with torch.no_grad():
        got = sampler.model.forward_with_cfg(
            _pad_time(z, t_pad), t, _pad_time(o, t_pad), _pad_time(c, t_pad), y, sampler.cfg_scale,
            band=sampler.band, valid_len=t_real, dtype=bf16)[:, :t_real].cpu()
    err = max_err(got, cpu_out)
    print(f"[slice-bf16] DiT-B forward_with_cfg, bf16 stream on the card vs the f32 stream on the CPU: "
          f"max_abs {err:.3e} (tol {BF16_FORWARD_TOL}), relative to max |out| "
          f"{err / cpu_out.abs().max().item():.3e}")
    check(got.dtype == torch.float32 and err <= BF16_FORWARD_TOL, f"slice-bf16: forward {err}")

    # rows 1 and 7 on bf16 inputs at the sampling shape ([attn]/[mlp] hold their f32 calls)
    g = torch.Generator(device=dev).manual_seed(3)
    n, h, d = z.shape[0], 12, 768
    qkv = torch.randn((n, t_pad, 3 * d), generator=g, device=dev).to(bf16)
    q, k, v = (a.view(n, t_pad, h, 64).transpose(1, 2) for a in qkv.split(d, dim=-1))
    attn = banded_attention(q, k, v, BAND, t_real)
    e_attn = rel_err(attn, banded_attention_reference(q, k, v, BAND, t_real, bf16))
    x = torch.randn((n, t_pad, d), generator=g, device=dev).to(bf16)
    mod = torch.randn((n, 3 * d), generator=g, device=dev) * 0.3
    shift, scale, gate = mod[:, :d], mod[:, d:2 * d], mod[:, 2 * d:]
    w1 = torch.randn((4 * d, d), generator=g, device=dev).mul(d ** -0.5).to(bf16)
    w2 = torch.randn((d, 4 * d), generator=g, device=dev).mul((4 * d) ** -0.5).to(bf16)
    b1, b2 = (torch.randn(m, generator=g, device=dev) * 0.02 for m in (4 * d, d))
    mlp = adaln_mlp(x, shift, scale, gate, w1, b1, w2, b2)
    e_mlp = rel_err(mlp, adaln_mlp_reference(x, shift, scale, gate, w1.t(), b1, w2.t(), b2, 1e-6, bf16))
    attn_ms = cuda_ms(lambda: banded_attention(q, k, v, BAND, t_real))
    mlp_ms = cuda_ms(lambda: adaln_mlp(x, shift, scale, gate, w1, b1, w2, b2))
    print(f"[slice-bf16] row 1 on bf16 q/k/v {tuple(q.shape)} (body {banded_attention.body}): "
          f"{e_attn:.3e} of max from its plain version, {attn_ms:.4f} ms; row 7 on bf16 x "
          f"{tuple(x.shape)} (body {adaln_mlp.body}): {e_mlp:.3e}, {mlp_ms:.4f} ms "
          f"(tol {TRAIN_TOL_BF16} of max: a bf16 output rounds to 2^-8 of itself)")
    check(attn.dtype == mlp.dtype == bf16, f"slice-bf16: outputs {attn.dtype}, {mlp.dtype}")
    check(e_attn <= TRAIN_TOL_BF16 and e_mlp <= TRAIN_TOL_BF16, f"slice-bf16: rows 1/7 {e_attn}, {e_mlp}")
    return sampler, device_ms


def phase_inpaint(dev, sampler, call_args):
    """[inpaint]: the f32 Sampler with the second half of the sequence known:
    those rows end at known_x, the others are sampled; rows 1 and 7 launched
    steps x depth times."""
    import torch

    z = call_args[0]
    g = torch.Generator(device=dev).manual_seed(4)
    known_x = torch.rand(z.shape, generator=g, device=dev)
    free = torch.ones(z.shape, dtype=torch.bool, device=dev)
    free[:, z.shape[1] // 2:] = False  # False: pinned to known_x
    read_counts = reset_launch_counts()
    out, step_ms = chain_ms(dev, sampler, call_args, known_x=known_x, known_mask=free)
    depth = len(sampler.model.blocks)
    check_launches("inpaint", read_counts(), dict.fromkeys(("banded_attention", "adaln_mlp"), STEPS * depth))
    err = max_err(out[~free], known_x[~free])
    moved = max_err(out[free], known_x[free])
    print(f"[inpaint] {int((~free).sum()) // 2} of {z.numel() // 2} points known: their max |out - "
          f"known_x| {err:.3e} (tol {INPAINT_TOL}); the free points' {moved:.3f}; "
          f"{step_ms / 1000:.6f} s per denoise step")
    check(err <= INPAINT_TOL and moved > 1e-2 and bool(torch.isfinite(out).all()),
          f"inpaint: known rows {err}, free rows {moved}")


def accel_launches(kernels, steps_full: int, steps_skipped: int, depth: int) -> dict:
    """Each kernel of the path once a block: every block on a full step,
    the blocks outside ACCEL_SPAN on a skipped one."""
    span = ACCEL_SPAN[1] - ACCEL_SPAN[0]
    return dict.fromkeys(kernels, steps_full * depth + steps_skipped * (depth - span))


def delta_roundtrip(tag, sampler, args) -> None:
    """One forward_with_cfg at the chain's x_T and a middle step, off, then
    "record", then "apply" with the recorded Δ, on the card: "record" gives
    the full forward's bits and leaves block lo's input (the Δ snapshot) as
    it was, and "apply" gives the full forward within DELTA_APPLY_REL_TOL of
    max |out|."""
    import torch

    x, model_fn, _, _, finish = sampler._setup(*args, None, None, True, None, None)
    t = sampler.diffusion.timestep_map[torch.full((x.shape[0],), STEPS // 2, device=x.device)]
    span = dict(delta_span=ACCEL_SPAN)
    snapshot = {}

    def keep_input(module, inputs):
        snapshot["x"], snapshot["copy"] = inputs[0], inputs[0].clone()

    with torch.no_grad():
        full = model_fn(x, t)
        hook = sampler.model.blocks[ACCEL_SPAN[0]].register_forward_pre_hook(keep_input)
        try:
            recorded, delta = model_fn(x, t, delta_mode="record", **span)
        finally:
            hook.remove()
        applied, _ = model_fn(x, t, delta_mode="apply", delta=delta, **span)
    kept = torch.equal(snapshot["x"], snapshot["copy"])
    same = torch.equal(recorded, full)
    rel = max_err(finish(applied), finish(full)) / finish(full).abs().max().item()
    print(f"[{tag}] Δ round trip at step {STEPS // 2}: record gives the full forward's bits: {same}; "
          f"block {ACCEL_SPAN[0]}'s input unchanged by it: {kept}; apply against the full forward "
          f"{rel:.3e} of max |out| (tol {DELTA_APPLY_REL_TOL}); |Δ| max {delta.abs().max().item():.3e}")
    check(same and kept and rel <= DELTA_APPLY_REL_TOL and bool(torch.isfinite(applied).all()),
          f"{tag}: Δ round trip: record bits {same}, snapshot kept {kept}, apply {rel}")


def fixed_full_steps(interval: int, steps: int) -> int:
    """Full steps of the fixed Δ-cache: every interval-th and the last."""
    return len(range(0, steps, interval)) + ((steps - 1) % interval != 0)


def phase_slice_accel(dev, ckpt_path, tmp, quantize=False):
    """[slice-accel] (f32) or [slice-accel-int8] (--quantize-weights): the
    sample CLI with --accel-interval 2 (launches from the schedule, the .osu
    reparses); tau 0 bit-equal to the exact chain with every step full,
    graphed and eager; a record-then-apply round trip of one forward
    (`delta_roundtrip`); a sweep through the Sampler (intervals, taus on
    both drift modes from a cuda_graph=False record of one-step drifts):
    full steps, launches, device ms per step and the gap to the exact
    chain; then s per denoise step in turns with the busy share: each
    graphed adaptive chain against its eager form, the exact chain, tau 0
    and the fixed interval with the nearest count of full steps."""
    import torch
    from osu_diffusion_tpu_torch import sampling

    tag = "slice-accel-int8" if quantize else "slice-accel"
    kernels = (["banded_attention", "int8_matmul", "int8_modulated_matmul", "int8_out_residual",
                "adaln_mlp_quant"] if quantize else ["banded_attention", "adaln_mlp"])
    counts, written, calls = run_cli(dev, ckpt_path, os.path.join(tmp, f"results-{tag}"),
                                     ["--accel-interval", "2"] + ["--quantize-weights"] * quantize)
    _, cli_sampler, args, _ = calls[-1]
    model, diffusion = cli_sampler.model, cli_sampler.diffusion
    depth = len(model.blocks)
    check(cli_sampler.accel_span == ACCEL_SPAN, f"{tag}: span {cli_sampler.accel_span}")
    full = cli_sampler.last_full_model_steps
    check(full == STEPS // 2 + 1, f"{tag}: {full} full steps at interval 2")
    check_launches(tag, counts, accel_launches(kernels, full, STEPS - full, depth))
    check_written(tag, written, 1)

    def make(**kw):
        return sampling.Sampler(model, diffusion, cfg_scale=CFG_SCALE, band=BAND, **kw)

    # tau 0: every step full (the drift is > 0 after the first), the exact chain's bits
    exact = make()
    exact_out, _ = chain_ms(dev, exact, args)
    drifts = eager_drifts(model, diffusion, args)["global"]
    tau0, tau0_eager = make(accel_tau=0.0), make(accel_tau=0.0, cuda_graph=False)
    same = {}
    for name, sampler in (("graphed", tau0), ("eager", tau0_eager)):
        out, _ = chain_ms(dev, sampler, args)
        same[name] = torch.equal(out, exact_out) and sampler.last_full_model_steps == STEPS
    print(f"[{tag}] tau 0: {tau0.last_full_model_steps} full steps of {STEPS}, bit-equal to the exact "
          f"chain (graphed, eager): {same}")
    check(all(same.values()), f"{tag}: tau 0 chains {same}")
    delta_roundtrip(tag, exact, args)
    # the sweep's taus: quantiles of the one-step drifts (the exact chain's)
    taus = [float(torch.tensor(drifts[1:-1]).quantile(q)) for q in ACCEL_TAU_QUANTILES]
    settings = [("exact (interval 1)", {})]
    settings += [(f"interval {k}", dict(accel_interval=k)) for k in ACCEL_INTERVALS]
    adaptive = [(f"tau {tau:.4f} ({q:.0%} of one-step drifts) {mode}", dict(accel_tau=tau, accel_drift=mode))
                for q, tau in zip(ACCEL_TAU_QUANTILES, taus) for mode in sampling.ACCEL_DRIFTS]
    samplers, device, ms, fulls, outs = {}, {}, {}, {}, {}

    def sweep(name, kw):
        samplers[name] = sampler = make(**kw)
        read_counts = reset_launch_counts()
        outs[name] = out = chain_ms(dev, sampler, args)[0]
        fulls[name] = full = STEPS if sampler.last_full_model_steps is None else sampler.last_full_model_steps
        want = accel_launches(kernels, full, STEPS - full, depth)
        if "accel_tau" in kw and kw.get("cuda_graph", True):  # the warm-up ran each body once
            want = {k: v + accel_launches(kernels, 1, 1, depth)[k] for k, v in want.items()}
        check_launches(tag, read_counts(), want)
        device[name], _ = chain_profile(dev, sampler, args, host_ops=False)
        diff = (out - exact_out).abs()
        print(f"[{tag}] {name}: {full} full steps of {STEPS}, device {device[name]:.3f} ms per step; "
              f"gap to the exact chain max {diff.max().item():.3e}, median {diff.median().item():.3e}")

    for name, kw in settings + adaptive:
        sweep(name, kw)
    for name, kw in adaptive:
        # its eager form, and the fixed interval with the nearest count of full steps
        sweep(f"{name} eager", dict(kw, cuda_graph=False))
        check(torch.equal(outs[name], outs[f"{name} eager"]) and fulls[f"{name} eager"] == fulls[name],
              f"{tag}: {name} graphed against eager")
        k = min(range(2, STEPS + 1), key=lambda k: (abs(fixed_full_steps(k, STEPS) - fulls[name]), k))
        if f"interval {k}" not in samplers:
            sweep(f"interval {k}", dict(accel_interval=k))
    samplers["tau 0"], samplers["tau 0 eager"] = tau0, tau0_eager
    ops = {}
    for name in ("tau 0", "tau 0 eager", settings[0][0]):
        device[name], ops[name] = chain_profile(dev, samplers[name], args, host_ops=False)
    # what the graphed tau-0 chain runs beyond the exact chain's ops: the decide part, the IF nodes' setters
    exact_ops = {key: (ms, n) for ms, n, key in ops[settings[0][0]]}
    extra = sorted(((ms - exact_ops.get(key, (0.0, 0))[0], n - exact_ops.get(key, (0.0, 0))[1], key)
                    for ms, n, key in ops["tau 0"] if n > exact_ops.get(key, (0.0, 0))[1]), reverse=True)
    print(f"[{tag}] tau 0 graphed against exact, device ms a step {device['tau 0']:.3f} against "
          f"{device[settings[0][0]]:.3f}; device ops beyond the exact chain's (ms a step, launches a chain): "
          + "; ".join(f"{ms:.4f} {n}x {key[:70]}" for ms, n, key in extra[:10]))
    for name, v in chains_in_turns(dev, tag, samplers, args).items():
        ms[name] = statistics.median(v)
    print(f"[{tag}] medians, s per denoise step (busy share of the device time): " + "; ".join(
        f"{name} {v / 1000:.6f} ({100 * device[name] / v:.1f}%)" for name, v in ms.items()))
    exact_ms = ms[settings[0][0]]
    print(f"[{tag}] s per step against the two chains that run every block (exact, tau 0 graphed): " + "; ".join(
        f"{name} {v / exact_ms:.3f}x, {v / ms['tau 0']:.3f}x" for name, v in ms.items()
        if name not in (settings[0][0], "tau 0")))
    for name, _ in adaptive:
        k = min(range(2, STEPS + 1), key=lambda k: (abs(fixed_full_steps(k, STEPS) - fulls[name]), k))
        print(f"[{tag}] {name} ({fulls[name]} full steps): graphed {ms[name] / 1000:.6f} against its eager "
              f"form {ms[f'{name} eager'] / 1000:.6f} ({ms[f'{name} eager'] / ms[name]:.3f}x), the exact "
              f"chain {exact_ms / 1000:.6f} ({exact_ms / ms[name]:.3f}x) and interval {k} "
              f"({fixed_full_steps(k, STEPS)} full steps) {ms[f'interval {k}'] / 1000:.6f} "
              f"({ms[name] / ms[f'interval {k}']:.3f} of it) s per denoise step")
    print(f"[{tag}] tau 0 (every step full, the exact chain's device work): graphed {ms['tau 0'] / 1000:.6f}, "
          f"eager {ms['tau 0 eager'] / 1000:.6f}, exact {exact_ms / 1000:.6f} s per denoise step; graphed minus "
          f"exact {ms['tau 0'] - exact_ms:+.4f} ms a step (the decide part and the IF nodes)")


def phase_refine(dev, ckpt_path, tmp):
    """[refine]: the sample CLI with --refine-ckpt (the same checkpoint) and
    --refine-iters REFINE_ITERS: a second .osu that reparses, and
    REFINE_ITERS x depth more launches of rows 1 and 7."""
    import torch

    counts, written, calls = run_cli(dev, ckpt_path, os.path.join(tmp, "results-refine"),
                                     ["--refine-ckpt", ckpt_path, "--refine-iters", str(REFINE_ITERS)])
    (_, refiner, args, _), = [call for call in calls if call[0] == "refine"]
    depth = len(refiner.model.blocks)
    check_launches("refine", counts, dict.fromkeys(("banded_attention", "adaln_mlp"),
                                                   (STEPS + REFINE_ITERS) * depth))
    check_written("refine", written, 2, f" {REFINE_ITERS}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    refiner.refine(*args, generator=torch.Generator(device=dev).manual_seed(SEED))
    end.record()
    torch.cuda.synchronize()
    print(f"[refine] wrote {os.path.basename(written[-1])}; "
          f"{start.elapsed_time(end) / REFINE_ITERS / 1000:.6f} s per refine step")


def phase_serving(dev, tmp, ckpt_path, sampler, call_args, cpu_out):
    """The serving paths beyond the main chain (14): DDIM, the bf16 stream
    (each in turns with the f32 ancestral chain), in-painting, the Δ-cache
    on f32 and int8 blocks, and the refine pass."""
    wall = time.perf_counter()
    ddim, ddim_device_ms = phase_slice_ddim(dev, ckpt_path, tmp)
    bf16, bf16_device_ms = phase_slice_bf16(dev, ckpt_path, tmp, call_args, cpu_out)
    f32_device_ms, _ = chain_profile(dev, sampler, call_args, host_ops=False)
    turns = chains_in_turns(dev, "serving", {"f32 ancestral": sampler, "ddim": ddim, "bf16": bf16},
                            call_args)
    ms = {name: statistics.median(v) for name, v in turns.items()}
    device = {"f32 ancestral": f32_device_ms, "ddim": ddim_device_ms, "bf16": bf16_device_ms}
    print("[serving] medians, s per denoise step (device ms per step, busy share): " + "; ".join(
        f"{name} {ms[name] / 1000:.6f} ({device[name]:.3f}, {100 * device[name] / ms[name]:.1f}%)"
        for name in ms))
    del ddim, bf16
    phase_inpaint(dev, sampler, call_args)
    phase_slice_accel(dev, ckpt_path, tmp)
    phase_slice_accel(dev, ckpt_path, tmp, quantize=True)
    phase_refine(dev, ckpt_path, tmp)
    print(f"[serving] the serving phases took {time.perf_counter() - wall:.1f} s")



def phase_toy(dev, ckpt_path):
    """[toy] (15): evals/toy.py's main at DiT-B on TOY_SUITE, f32 then with
    --quantize-weights: launches by the schedule (rows 1 and 7, or rows 1
    and 10-13, steps x depth x fixtures), row 13 on its wide body (100 rows),
    every pinned row exactly its known_x and every prediction finite; one
    forward at the first fixture's inputs (batch 100 x 128, the null class,
    no CFG) on the card against the plain versions on the CPU; the accuracy
    (random weights: not a gate), s per fixture, and one fixture's chain
    profiled (device ms per step, busy share). Then main --generate on one
    fixture, whose printed lines parse as hit objects."""
    import torch
    from osu_diffusion_tpu_torch.beatmap.parser import parse_beatmap
    from osu_diffusion_tpu_torch.evals import toy
    from osu_diffusion_tpu_torch.ops import quant as tq

    wall = time.perf_counter()
    fixtures = sorted(os.listdir(os.path.join(toy._toy_root(), TOY_SUITE)))
    argv = ["--ckpt", ckpt_path, "--model", MODEL, "--num-classes", str(NUM_CLASSES),
            "--num-sampling-steps", str(TOY_STEPS), "--num-predictions", str(TOY_PREDICTIONS),
            "--seq-len", str(TOY_SEQ), "--seed", str(SEED), "--device", dev]
    print(f"[toy] cut: {TOY_STEPS} sampling steps (the protocol runs 1000); {TOY_PREDICTIONS} "
          f"predictions, seq_len and band {TOY_SEQ}, the null class, no CFG, on the "
          f"{len(fixtures)} {TOY_SUITE} fixtures")
    for quantize in (False, True):
        tag = "toy-int8" if quantize else "toy"
        read_counts = reset_launch_counts()
        buf = io.StringIO()
        with RecordingCalls("__call__") as rec, contextlib.redirect_stdout(buf):
            toy.main(argv + ["--tests", TOY_SUITE] + ["--quantize-weights"] * quantize)
        counts = read_counts()
        depth = len(rec.calls[0][1].model.blocks)
        n = TOY_STEPS * depth * len(fixtures)
        path = (("banded_attention", "int8_matmul", "int8_modulated_matmul", "int8_out_residual",
                 "adaln_mlp_quant") if quantize else ("banded_attention", "adaln_mlp"))
        check_launches(tag, counts, dict.fromkeys(path, n))
        check(len(rec.calls) == len(fixtures), f"{tag}: {len(rec.calls)} chains")
        pinned = finite = True
        for _, _, _, kwargs, out, _ in rec.calls:
            free, known_x = kwargs["known_mask"], kwargs["known_x"]
            check(tuple(out.shape) == (TOY_PREDICTIONS, TOY_SEQ, 2) and int(free.sum()) == 2 * TOY_PREDICTIONS,
                  f"{tag}: output {tuple(out.shape)}, {int(free.sum())} free values")
            pinned &= torch.equal(out[~free], known_x[~free])
            finite &= bool(torch.isfinite(out).all())
        check(pinned and finite, f"{tag}: pinned rows equal known_x {pinned}, finite {finite}")
        if quantize:
            check(tq.int8_matmul.body == "sm90",
                  f"{tag}: row 13 at {TOY_PREDICTIONS} rows took body {tq.int8_matmul.body}")
        per_fixture = statistics.mean(c[-1] for c in rec.calls)
        _, sampler, args, kwargs, _, _ = rec.calls[0]
        phase_forward_vs_plain(dev, sampler, args, f"{tag}-forward", use_cfg=False)
        inpaint = {k: kwargs[k] for k in ("known_x", "known_mask", "use_cfg")}
        _, step_ms = chain_ms(dev, sampler, args, **inpaint)
        device_ms, ops = chain_profile(dev, sampler, args, host_ops=False, **inpaint)
        result = buf.getvalue().strip().splitlines()
        print(f"[{tag}] {result[-1]} (random weights: not a gate); pinned rows exactly known_x, "
              f"all finite; {per_fixture:.3f} s per fixture ({TOY_STEPS} steps at batch "
              f"{TOY_PREDICTIONS} x {TOY_SEQ}); one fixture's chain {step_ms / 1000:.6f} s per "
              f"step, device {device_ms:.3f} ms per step (torch.profiler), busy "
              f"{100 * device_ms / step_ms:.1f}%" + (f"; row 13 body {tq.int8_matmul.body}"
                                                         if quantize else ""))
        for ms, calls, name in ops[:6]:
            print(f"[{tag}-profile]   {ms:9.3f} ms/step  {calls // TOY_STEPS:6d}x/step  {name[:90]}")
        del rec, sampler, args, kwargs

    fixture = os.path.join(TOY_SUITE, fixtures[0])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        toy.main(argv + ["--generate", fixture])
    lines = buf.getvalue().strip().splitlines()
    with open(os.path.join(toy._toy_root(), fixture)) as f:
        text = f.read()
    reparsed = parse_beatmap(text[:text.index("[HitObjects]")] + "[HitObjects]\n" + "\n".join(lines[1:]) + "\n")
    print(f"[toy] --generate {fixture}: {lines[0]}; {len(reparsed.hit_objects())} printed lines "
          f"reparse as hit objects, the first {lines[1]!r}")
    check(lines[0].startswith("Generate example correct predictions = ")
          and len(lines) == TOY_PREDICTIONS + 1 and len(reparsed.hit_objects()) == TOY_PREDICTIONS,
          f"--generate printed {lines[:3]}...")
    print(f"[toy] the phase took {time.perf_counter() - wall:.1f} s")


def phase_unfuck(dev, ckpt_path):
    """[unfuck] (16): evals/unfuck.py's main at DiT-B on UNFUCK_SUITE:
    rows 1 and 7 launched steps x depth x fixtures times, the rows outside
    each span equal to their input bit for bit, both distances finite; one
    t = 0 forward at the shortest fixture's inputs (batch 100, valid_len
    well below the 128-row bucket) on the card against the plain versions
    on the CPU."""
    import torch
    from osu_diffusion_tpu_torch.evals import toy, unfuck

    wall = time.perf_counter()
    fixtures = sorted(os.listdir(os.path.join(toy._toy_root(), UNFUCK_SUITE)))
    print(f"[unfuck] cut: {UNFUCK_STEPS} t = 0 steps (the protocol runs 1000); {TOY_PREDICTIONS} "
          f"predictions, magnitude {UNFUCK_MAGNITUDE} px, band 128, on the {len(fixtures)} "
          f"{UNFUCK_SUITE} fixtures")
    read_counts = reset_launch_counts()
    buf = io.StringIO()
    with RecordingCalls("refine") as rec, contextlib.redirect_stdout(buf):
        unfuck.main(["--ckpt", ckpt_path, "--model", MODEL, "--num-classes", str(NUM_CLASSES),
                     "--num-sampling-steps", str(UNFUCK_STEPS), "--num-predictions", str(TOY_PREDICTIONS),
                     "--tests", UNFUCK_SUITE, "--fucking-magnitude", str(UNFUCK_MAGNITUDE),
                     "--seed", str(SEED), "--device", dev])
    counts = read_counts()
    depth = len(rec.calls[0][1].model.blocks)
    check_launches("unfuck", counts, dict.fromkeys(("banded_attention", "adaln_mlp"),
                                                   UNFUCK_STEPS * depth * len(fixtures)))
    kept = True
    for _, _, args, kwargs, out, _ in rec.calls:
        x, free = args[0], kwargs["known_mask"]
        kept &= torch.equal(out[~free], x[~free]) and bool(torch.isfinite(out).all())
    lines = buf.getvalue().strip().splitlines()
    before, after = (float(re.search(r"= (\S+) units", line).group(1)) for line in lines[1:3])
    print(f"[unfuck] mean distance before {before:.4f} px, after {after:.4f} px over "
          f"{re.search(r'out of (\d+)', lines[1]).group(1)} points (random weights: not a gate); "
          f"rows outside the spans kept bit for bit: {kept}; "
          f"{statistics.mean(c[-1] for c in rec.calls):.3f} s per fixture")
    check(kept and math.isfinite(before) and math.isfinite(after) and len(rec.calls) == len(fixtures),
          f"unfuck: kept {kept}, distances {before}, {after}, {len(rec.calls)} chains")
    _, sampler, args, _, _, _ = min(rec.calls, key=lambda call: call[2][0].shape[1])
    check(args[0].shape[1] <= TOY_SEQ // 4, f"unfuck: the shortest fixture has {args[0].shape[1]} rows")
    phase_forward_vs_plain(dev, sampler, args[:4], "unfuck-forward", use_cfg=False, step=0)
    print(f"[unfuck] the phase took {time.perf_counter() - wall:.1f} s")


def longrun_argv(workdir) -> list[str]:
    return ["--model", LONGRUN_MODEL, "--total-steps", str(2 * LONGRUN_CHUNK),
            "--chunk", str(LONGRUN_CHUNK), "--batch", "64", "--seq-len", "128", "--stride", "16",
            "--pad-rows", "160", "--num-predictions", str(LONGRUN_PREDICTIONS),
            "--num-sampling-steps", str(LONGRUN_SAMPLING_STEPS), "--suites", LONGRUN_SUITE,
            "--results-dir", os.path.join(workdir, "results"),
            "--data-dir", os.path.join(workdir, "data"),
            "--log", os.path.join(workdir, "evals.jsonl"), "--device", "cuda"]


def longrun_child_main(workdir) -> int:
    """The child of [longrun]: tools/longrun_toy.py's main, each kernel's
    launches counted over the training chunks and the eval rounds apart,
    written to <workdir>/launches.json."""
    from osu_diffusion_tpu_torch.evals import toy
    from osu_diffusion_tpu_torch.tools import longrun_toy

    read_counts = reset_launch_counts()
    evals = {}
    evaluate_suite = toy.evaluate_suite

    def counted(*args, **kwargs):
        before = read_counts()
        out = evaluate_suite(*args, **kwargs)
        for name, n in read_counts().items():
            evals[name] = evals.get(name, 0) + n - before[name]
        return out

    toy.evaluate_suite = counted  # longrun_toy's main imports it when it starts
    longrun_toy.main(longrun_argv(workdir))
    total = read_counts()
    with open(os.path.join(workdir, "launches.json"), "w") as f:
        json.dump({"train": {k: v - evals.get(k, 0) for k, v in total.items()}, "eval": evals}, f)
    return 0


def phase_longrun(tmp):
    """[longrun] (17): tools/longrun_toy.py at DiT-S in a child process
    (this script with --longrun-child): two chunks of LONGRUN_CHUNK steps,
    the second resumed from the first's checkpoint, an eval round after
    each; the training rows 2, 3, 4 and 8 and the eval's rows 1 and 7
    launched by the schedule."""
    wall = time.perf_counter()
    workdir = os.path.join(tmp, "longrun")
    os.makedirs(workdir)
    print(f"[longrun] cut: {2 * LONGRUN_CHUNK} training steps in two chunks, each eval round "
          f"{LONGRUN_PREDICTIONS} predictions of {LONGRUN_SAMPLING_STEPS} sampling steps on "
          f"{LONGRUN_SUITE} (the protocol: 100 of 1000 on four suites); {LONGRUN_MODEL}, batch 64, "
          f"seq-len 128, stride 16, --pad-rows 160")
    log_path = os.path.join(workdir, "child.log")
    with open(log_path, "w") as log:
        try:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--longrun-child", workdir],
                                stdout=log, stderr=subprocess.STDOUT, timeout=LONGRUN_TIMEOUT).returncode
        except subprocess.TimeoutExpired:  # run() has killed the child
            rc = "killed at the time limit"
    with open(log_path) as f:
        tail = f.read()[-3000:]
    check(rc == 0, f"longrun child exited {rc}:\n{tail}")
    with open(os.path.join(workdir, "evals.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(workdir, "launches.json")) as f:
        launches = json.load(f)
    results = os.path.join(workdir, "results")
    exps = sorted(os.listdir(results))
    first_ckpt = os.path.join(results, exps[0], "checkpoints", f"{LONGRUN_CHUNK:07d}.pt")
    with open(os.path.join(results, exps[-1], "log.txt")) as f:
        resumed = f"Restored from checkpoint at {first_ckpt}" in f.read()
    for rec in recs:
        print(f"[longrun] {json.dumps(rec)}")
    print(f"[longrun] the second chunk resumed from step {LONGRUN_CHUNK}'s checkpoint: {resumed}; "
          f"launches in training {({k: v for k, v in launches['train'].items() if v})}, in the eval "
          f"rounds {({k: v for k, v in launches['eval'].items() if v})}")
    check(len(recs) == 2 and [r["step"] for r in recs] == [LONGRUN_CHUNK, 2 * LONGRUN_CHUNK]
          and all(0.0 <= r[LONGRUN_SUITE] <= 1.0 for r in recs), f"longrun eval lines {recs}")
    check(len(exps) == 2 and resumed, f"longrun: experiments {exps}, resumed {resumed}")
    from osu_diffusion_tpu_torch.models.dit import DiT_models

    depth, steps = len(DiT_models[LONGRUN_MODEL](num_classes=2).blocks), 2 * LONGRUN_CHUNK
    fixtures = len(os.listdir(os.path.join("assets", "toy_datasets", LONGRUN_SUITE)))
    check_launches("longrun-train", launches["train"], {
        "banded_attention_fwd_lse": steps * depth * 2, "adaln_mlp_train": steps * depth * 2,
        "banded_attention_bwd_dq": steps * depth, "banded_attention_bwd_dkv": steps * depth})
    check_launches("longrun-eval", launches["eval"], dict.fromkeys(
        ("banded_attention", "adaln_mlp"), 2 * fixtures * LONGRUN_SAMPLING_STEPS * depth))
    print(f"[longrun] the phase took {time.perf_counter() - wall:.1f} s")


# (tool, argv, kernels it must launch): each tool's smallest setting
ATTN_TRAIN_KERNELS = ("banded_attention_fwd_lse", "banded_attention_bwd_dq", "banded_attention_bwd_dkv")
BENCH_TOOL_RUNS = [
    ("bench_sample", ["--model", "DiT-B", "--steps", "10", "--groups", "2", "--runs", "2"],
     ("banded_attention", "adaln_mlp")),
    ("bench_accel", ["--intervals", "1,2", "--taus", "0.05", "--groups", "1", "--runs", "1"],
     ("banded_attention", "adaln_mlp")),
    ("bench_quant", ["--groups", "1", "--runs", "1"],
     ("banded_attention", "adaln_mlp", "int8_matmul", "int8_modulated_matmul", "int8_out_residual",
      "adaln_mlp_quant")),
    ("bench_train", ["--batch", "32", "--calls", "2"], ATTN_TRAIN_KERNELS + ("adaln_mlp_train",)),
    ("bench_train", ["--batch", "32", "--calls", "2", "--steps-per-call", "8"],
     ATTN_TRAIN_KERNELS + ("adaln_mlp_train",)),
    ("bench_flash", ["--iters", "2", "6"], ATTN_TRAIN_KERNELS),
]


def bench_rates(name: str, out) -> list[float]:
    """The rates (steps/s, ms per iteration) a bench tool returned."""
    if name == "bench_sample":
        return [out["steps_per_sec_best"], *out["per_group"]]
    if name in ("bench_accel", "bench_quant"):
        return [r["steps_per_sec_best"] for r in out["results"].values() if isinstance(r, dict)]
    if name == "bench_train":
        return [out["steps_per_sec"], out["samples_per_sec"]]
    return [row[k] for row in out if "fwd_ms" in row for k in ("fwd_ms", "fwd_bwd_ms")]


def phase_bench_tools():
    """Each bench tool's main(argv) in this process at its smallest setting:
    finite positive rates, the card's line in its JSON, and the launches of
    the kernels it drives."""
    import importlib

    for name, argv, kernels in BENCH_TOOL_RUNS:
        tool = importlib.import_module(f"osu_diffusion_tpu_torch.tools.{name}")
        read = reset_launch_counts()
        wall = time.perf_counter()
        out = tool.main(argv)
        wall = time.perf_counter() - wall
        counts = read()
        rates = bench_rates(name, out)
        card = (out[-1] if isinstance(out, list) else out)["card"]
        check(card == device_line(), f"[bench-tools] {name} names the card {card!r}")
        check(rates and all(math.isfinite(r) and r > 0 for r in rates),
              f"[bench-tools] {name} rates {rates}")
        check(all(counts[k] > 0 for k in kernels),
              f"[bench-tools] {name} launches {({k: counts[k] for k in kernels})}")
        if "--steps-per-call" in argv:  # its calls are graphs: the warm-up call captured one
            check(out["capture_ms"] is not None and out["capture_ms"] > 0,
                  f"[bench-tools] {name} capture_ms {out['capture_ms']}")
        print(f"[bench-tools] {name} {' '.join(argv)}: {wall:.1f} s; rates {rates}; launches "
              f"{ {k: counts[k] for k in kernels} }", flush=True)


def reset_launch_counts():
    """Every kernel wrapper's launch count to 0; returns a reader of them."""
    from osu_diffusion_tpu_torch.ops import adaln_mlp as am
    from osu_diffusion_tpu_torch.ops import banded_attention as ba
    from osu_diffusion_tpu_torch.ops import quant as tq

    wrappers = {"banded_attention": ba.banded_attention,
                "banded_attention_fwd_lse": ba.banded_attention_fwd_lse,
                "banded_attention_bwd_dq": ba.banded_attention_bwd_dq,
                "banded_attention_bwd_dkv": ba.banded_attention_bwd_dkv,
                "banded_attention_ranged": ba.banded_attention_ranged,
                "banded_attention_ranged_fwd_lse": ba.banded_attention_ranged_fwd_lse,
                "banded_attention_ranged_bwd_dq": ba.banded_attention_ranged_bwd_dq,
                "banded_attention_ranged_bwd_dkv": ba.banded_attention_ranged_bwd_dkv,
                "adaln_mlp": am.adaln_mlp, "adaln_mlp_train": am.adaln_mlp_train,
                "adaln_mlp_bwd_prologue": am.adaln_mlp_bwd_prologue,
                "adaln_mlp_bwd_epilogue": am.adaln_mlp_bwd_epilogue,
                "int8_matmul": tq.int8_matmul, "int8_modulated_matmul": tq.int8_modulated_matmul,
                "int8_out_residual": tq.int8_out_residual, "adaln_mlp_quant": am.adaln_mlp_quant}
    for fn in wrappers.values():
        fn.launches = 0
    return lambda: {name: fn.launches for name, fn in wrappers.items()}


def train_step_launches(steps: int, depth: int, mlp_bwd: str = "xla") -> dict:
    """The training kernels' launches in `steps` optimizer steps of a model
    `depth` blocks deep: rows 2 and 8 in the forward and the remat
    recompute, rows 3 and 4 once a block, and with the fused MLP backward
    rows 9a/9b once a block (remat recomputes the forward only)."""
    out = {"banded_attention_fwd_lse": steps * depth * 2, "adaln_mlp_train": steps * depth * 2,
           "banded_attention_bwd_dq": steps * depth, "banded_attention_bwd_dkv": steps * depth}
    if mlp_bwd == "fused":
        out.update(dict.fromkeys(("adaln_mlp_bwd_prologue", "adaln_mlp_bwd_epilogue"), steps * depth))
    return out


def run_train_cli(tag, argv, steps, mlp_bwd="xla", profiled=PROFILED_STEPS, model=MODEL,
                  timed=TIMED_STEPS, log_every=5):
    """The train CLI (`argv`: its flags, --model `model` among them, bf16
    stream and remat) for `steps` steps with --mlp-bwd `mlp_bwd`: launch
    counts (and the calls of the plain MLP backward: one a block and step
    with --mlp-bwd xla, none with fused), finite losses (logged every
    `log_every` steps), seconds per step over the steps `timed`, the
    device's busy share over the steps `profiled`, and the peak of
    allocated device memory. Returns (summary, launches, {period_ms,
    step_ms, busy, device_ms, peak_gb})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from osu_diffusion_tpu_torch.cli import build_train_parser, train_main
    from osu_diffusion_tpu_torch.models.dit import DiT_models
    from osu_diffusion_tpu_torch.ops import adaln_mlp as am
    from osu_diffusion_tpu_torch.train import trainer

    events = []  # (start, end) CUDA events around each train_step call
    prof = {}
    orig_step = trainer.train_step

    def timed_step(*args, **kwargs):
        i = len(events)
        if i == profiled.start:
            torch.cuda.synchronize()
            prof["p"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof["p"].start()
            prof["wall"] = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig_step(*args, **kwargs)
        end.record()
        events.append((start, end))
        if i == profiled.stop - 1:
            torch.cuda.synchronize()
            prof["wall"] = time.perf_counter() - prof["wall"]
            prof["p"].stop()
        return out

    plain_bwd = []  # calls of the plain MLP backward (AdalnMlp's bwd_impl "xla")
    orig_bwd = am.adaln_mlp_bwd

    def counted_bwd(*args, **kwargs):
        plain_bwd.append(1)
        return orig_bwd(*args, **kwargs)

    trainer.train_step = timed_step
    am.adaln_mlp_bwd = counted_bwd
    read_counts = reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    wall = time.perf_counter()
    try:
        summary = train_main(build_train_parser().parse_args(argv + ["--max-steps", str(steps)]))
    finally:
        trainer.train_step = orig_step
        am.adaln_mlp_bwd = orig_bwd
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with torch.device("meta"):  # the depth only
        depth = len(DiT_models[model](num_classes=2).blocks)
    with open(os.path.join(summary["experiment_dir"], "log.txt")) as f:
        log = f.read()
    losses = [float(v) for v in re.findall(r"Train Loss: ([^,]+),", log)]
    print(f"[{tag}] {summary['final_step']} steps in {wall:.1f} s wall; losses {losses}; "
          f"launches {launches}; plain MLP backward calls {len(plain_bwd)}")
    check(summary["final_step"] == steps, f"stopped at step {summary['final_step']}")
    check(len(losses) == steps // log_every and all(math.isfinite(v) for v in losses),
          f"Train Loss lines: {losses}")
    check("Done!" in log, "no Done! in the log")
    expected = {**dict.fromkeys(launches, 0), **train_step_launches(steps, depth, mlp_bwd)}
    check(launches == expected, f"launches {launches}, expected {expected}")
    want_plain = 0 if mlp_bwd == "fused" else steps * depth
    check(len(plain_bwd) == want_plain, f"{tag}: {len(plain_bwd)} plain MLP backward calls, expected {want_plain}")

    # steady state: the train_step calls in `timed`, by CUDA events
    first, last = timed.start, timed.stop - 1
    step_ms = sum(events[i][0].elapsed_time(events[i][1]) for i in timed) / len(timed)
    period_ms = events[first][0].elapsed_time(events[last][0]) / (last - first)
    print(f"[{tag}] steady state over steps {first}..{last}: {period_ms / 1000:.6f} s per optimizer "
          f"step start to start ({TRAIN_BATCH * TRAIN_SEQ / period_ms * 1000:.0f} tokens/s), "
          f"{step_ms / 1000:.6f} s inside train_step ({model}, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"bf16 stream, remat, --mlp-bwd {mlp_bwd}); peak device memory allocated {peak_gb:.2f} GB")
    events_dev = [e for e in prof["p"].key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events_dev)
    n_prof = len(profiled)
    busy = 100 * device_us / 1000 / (prof["wall"] * 1000)
    print(f"[{tag}-profile] device time {device_us / 1000:.2f} ms over {n_prof} steps "
          f"({len(events_dev)} kinds of device op); busy {busy:.1f}% "
          f"of {prof['wall'] * 1000:.2f} ms wall (profiler on)")
    for e in sorted(events_dev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[{tag}-profile]   {e.self_device_time_total / 1000 / n_prof:9.3f} ms/step  "
              f"{e.count // n_prof:6d}x/step  {e.key[:90]}")
    attn_us = {e.key: e.self_device_time_total for e in events_dev if "banded_attn" in e.key}
    print(f"[{tag}-profile] banded attention kernels {sum(attn_us.values()) / 1000 / n_prof:.3f} ms/step, "
          f"{100 * sum(attn_us.values()) / device_us:.1f}% of device time: " + ", ".join(
              f"{k[:60]} {v / 1000 / n_prof:.3f}" for k, v in sorted(attn_us.items(), key=lambda kv: -kv[1])))
    mlp_us = sum(e.self_device_time_total for e in events_dev if any(k in e.key for k in MLP_SM90_KERNELS))
    print(f"[{tag}] kernel B's training forward (the Hopper body: {', '.join(MLP_SM90_KERNELS)}) "
          f"{mlp_us / 1000 / n_prof:.3f} ms of {device_us / 1000 / n_prof:.2f} ms device time per step")
    bwd_us = {k: sum(e.self_device_time_total for e in events_dev if k in e.key) for k in MLP_BWD_SM90_KERNELS}
    print(f"[{tag}-profile] the fused MLP backward's Hopper body (rows 9a/9b) "
          f"{sum(bwd_us.values()) / 1000 / n_prof:.3f} ms of {device_us / 1000 / n_prof:.2f} ms device time "
          f"per step: " + ", ".join(f"{k} {v / 1000 / n_prof:.3f}" for k, v in bwd_us.items()))
    numbers = {"period_ms": period_ms, "step_ms": step_ms, "busy": busy,
               "device_ms": device_us / 1000 / n_prof, "peak_gb": peak_gb}
    return summary, launches, numbers


def phase_train(dev, tmp, mlp_bwd="xla"):
    """The train CLI at DiT-B width on kimi copies with --mlp-bwd `mlp_bwd`
    (run_train_cli); with the default backward also a checkpoint that
    resumes and the loader alone on both featurizers. Returns (launches,
    {period_ms, step_ms, busy, device_ms[, ckpt]})."""
    from osu_diffusion_tpu_torch.cli import build_train_parser, train_main
    from osu_diffusion_tpu_torch.data.dataset import featurizer_name
    from osu_diffusion_tpu_torch.train.checkpoint import latest_checkpoint, load_train_checkpoint

    default = mlp_bwd == "xla"
    tag = "train" if default else f"train-{mlp_bwd}"
    data = train_dataset(tmp)
    argv = ["--data-path", data, "--data-start", "0", "--data-end", "2", "--model", MODEL,
            "--num-classes", str(NUM_CLASSES), "--global-batch-size", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--stride", "16", "--num-workers", "2",
            "--log-every", "5", "--ckpt-every", str(TRAIN_CKPT_EVERY if default else 10 ** 9),
            "--results-dir", os.path.join(tmp, "train"), "--device", dev, "--mlp-bwd", mlp_bwd]
    print(f"[{tag}] the loader's featurizer: {featurizer_name()}")
    summary, launches, numbers = run_train_cli(tag, argv, TRAIN_STEPS, mlp_bwd)
    if not default:
        return launches, numbers

    ckpt_path = latest_checkpoint(summary["checkpoint_dir"])
    check(ckpt_path is not None and ckpt_path.endswith(f"{TRAIN_CKPT_EVERY:07d}.pt"),
          f"no checkpoint of step {TRAIN_CKPT_EVERY}: {ckpt_path}")
    ckpt = load_train_checkpoint(ckpt_path)
    check(set(ckpt) == {"model", "ema", "opt", "args", "step"} and ckpt["step"] == TRAIN_CKPT_EVERY,
          f"checkpoint layout {sorted(ckpt)} step {ckpt.get('step')}")
    del ckpt
    numbers["ckpt"] = ckpt_path

    # resume from the checkpoint for one more step
    summary2 = train_main(build_train_parser().parse_args(
        argv + ["--max-steps", str(TRAIN_CKPT_EVERY + 1), "--ckpt", ckpt_path, "--log-every", "1"]))
    with open(os.path.join(summary2["experiment_dir"], "log.txt")) as f:
        log2 = f.read()
    print(f"[train] resumed from {ckpt_path}: final step {summary2['final_step']}, "
          f"loss {summary2['last_loss']}")
    check("Restored from checkpoint" in log2, "the resumed run did not restore")
    check(summary2["final_step"] == TRAIN_CKPT_EVERY + 1 and math.isfinite(summary2["last_loss"]),
          f"resume: {summary2}")

    # the loader alone, as the trainer builds it, to split the step's period
    # between waiting for data and the step itself
    for name in FEATURIZERS:
        with featurizer(name):
            loader = train_loader(data, 2, 2)
            wall, batches = time.perf_counter(), 0
            for _ in range(3):
                batches += sum(1 for _ in loader)
            print(f"[train] the loader alone (2 threads, {name} featurizer): "
                  f"{(time.perf_counter() - wall) / batches:.6f} s per batch of {TRAIN_BATCH} "
                  f"over {batches} batches")
    return launches, numbers


TRAIN_GRAPH_K = 8  # [train-graph]: optimizer steps a call (the train CLI's --steps-per-call)
TRAIN_GRAPH_ROUNDS = 3  # its graphed and eager calls timed in turns (the median resists one slow round)
TRAIN_GRAPH_MAX_STEPS = 20  # its CLI run's --max-steps: the call boundary past it is step 24
TRAIN_GRAPH_CKPT_EVERY = 15  # and --ckpt-every: the checkpoint of the call boundary past it, 16
TRAIN_GRAPH_LOG_EVERY = 5  # and --log-every: a Train Loss line at every call boundary


def train_state_tensors(model, ema, optimizer) -> dict:
    """Every tensor an optimizer step moves, by name: the weights, AdamW's
    step counts and moments, the EMA."""
    out = {}
    for name, p in model.named_parameters():
        out[f"weight {name}"] = p
        out.update({f"{key} {name}": v for key, v in optimizer.state[p].items()})
    out.update({f"ema {name}": p for name, p in ema.named_parameters()})
    return out


def device_busy(run, steps) -> tuple[float, float]:
    """(device ms per step, busy %) of one run() from an idle card:
    torch.profiler's device time (kernels, copies, memsets) over the host's
    wall time up to a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0)
    check(us > 0, "the profiler saw no device op")
    return us / 1000 / steps, 100 * us / 1000 / (wall * 1000)


def graph_against_eager(tag, state, saved, graphed, got, want) -> None:
    """(a) of [train-graph]: the replayed call's metrics and every tensor
    it moved (`graphed`) against the eager steps' (`state` after them),
    from the same `saved` start. The same bits are expected (the kernels
    use no atomics); else the largest gap is printed and held to bounds:
    the loss mean within STEP_LOSS_REL_TOL, each weight and EMA tensor
    within STEP_GRAD_REL_TOL of the largest move of that tensor over the
    call, each moment within STEP_GRAD_REL_TOL of its largest value, and
    the step counts exact."""
    import torch

    same = [n for n, v in state.items() if torch.equal(graphed[n], v)]
    metrics_same = all(torch.equal(got[m], want[m]) for m in want)
    print(f"[{tag}] (a) the replayed call against {TRAIN_GRAPH_K} eager train_steps from one state: "
          f"metrics {({m: got[m].item() for m in got})} against {({m: want[m].item() for m in want})} "
          f"({'the same bits' if metrics_same else 'differ'}); {len(same)} of {len(state)} tensors "
          f"(weights, AdamW steps and moments, EMA) the same bits")
    if metrics_same and len(same) == len(state):
        return
    loss_rel = abs(got["loss"].item() - want["loss"].item()) / abs(want["loss"].item())
    worst = (0.0, None, 0.0, 0.0)  # (gap over bound, tensor, gap, bound)
    for n, v in state.items():
        gap = (graphed[n] - v).abs().max().item()
        kind = n.split(" ")[0]
        if kind == "step":
            bound = 0.0
        elif kind in ("weight", "ema"):
            bound = STEP_GRAD_REL_TOL * (v - saved[n]).abs().max().item()
        else:
            bound = STEP_GRAD_REL_TOL * v.abs().max().item()
        ratio = gap / bound if bound else (math.inf if gap else 0.0)
        worst = max(worst, (ratio, n, gap, bound), key=lambda w: w[0])
    print(f"[{tag}] (a) bounds: loss mean relative gap {loss_rel:.3e} (tol {STEP_LOSS_REL_TOL}); the largest "
          f"gap over its bound is {worst[1]}'s: {worst[2]:.3e} against {worst[3]:.3e}")
    check(loss_rel <= STEP_LOSS_REL_TOL, f"{tag}: loss mean {loss_rel} > {STEP_LOSS_REL_TOL}")
    check(worst[0] <= 1.0, f"{tag}: {worst[1]} differs by {worst[2]} > {worst[3]}")


def phase_train_graph(dev, tmp, card, mlp_bwd="xla"):
    """[train-graph]: the train step's CUDA graph (train_step.TrainCall, k =
    TRAIN_GRAPH_K) at DiT-B's full width, batch TRAIN_BATCH x TRAIN_SEQ,
    bf16 stream, remat, `mlp_bwd`, on k batches of [train]'s kimi copies:
    (a) from one state (weights, EMA, moments and generator, put back into
    the same tensors) one replayed call against k eager train_steps
    (graph_against_eager) and the generator's offset after both; (b) each
    call adds k steps' launches (the first, eager one too); (c) s per
    optimizer step graphed against eager in turns by CUDA events, device
    ms, busy share and the peak of allocated memory over one call of each,
    the capture's ms and pool bytes; (d) with the default backward, the
    train CLI with --steps-per-call k (train_graph_cli)."""
    import numpy as np
    import torch
    from osu_diffusion_tpu_torch import CONTEXT_SIZE
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.models.dit import DiT_models
    from osu_diffusion_tpu_torch.train.train_step import TrainCall, make_ema, make_optimizer, train_steps
    from osu_diffusion_tpu_torch.train.trainer import CLASS_DROPOUT_PROB

    tag = "train-graph" if mlp_bwd == "xla" else f"train-graph-{mlp_bwd}"
    k = TRAIN_GRAPH_K
    wall = time.perf_counter()
    loader, items = train_loader(train_dataset(tmp), 2, 2), []
    while len(items) < k:
        items.extend(loader)
    raw, prev_xy, y = (torch.from_numpy(np.stack(parts)).to(dev)
                       for parts in zip(*((w, p, label) for (w, p), label in items[:k])))
    batches = (raw, prev_xy, y.long())
    model = DiT_models[MODEL](num_classes=NUM_CLASSES, context_size=CONTEXT_SIZE,
                              class_dropout_prob=CLASS_DROPOUT_PROB, remat=True, mlp_bwd=mlp_bwd)
    model.initialize_weights(torch.Generator().manual_seed(SEED))
    ema = make_ema(model)
    model.to(dev).train()
    ema.to(dev).eval()
    opt = make_optimizer(model.parameters())
    diffusion = create_diffusion("", noise_schedule="squaredcos_cap_v2", use_l1=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kwargs = dict(band=TRAIN_SEQ, dtype=torch.bfloat16)
    depth = len(model.blocks)
    call = TrainCall(model, ema, opt, diffusion, generator=gen, graphed=True, **kwargs)

    def eager():
        return train_steps(model, ema, opt, diffusion, batches, generator=gen, **kwargs)

    # (b) the first call: k eager steps on a side stream, then the capture
    read = reset_launch_counts()
    call(batches)
    torch.cuda.synchronize()
    counts = {"first": read()}
    # (a) and (b): one replay against k eager steps from the same state
    state = train_state_tensors(model, ema, opt)
    saved = {n: v.clone() for n, v in state.items()}
    offset = gen.get_offset()
    read = reset_launch_counts()
    got = call(batches)
    torch.cuda.synchronize()
    counts["replay"] = read()
    graphed, graphed_offset = {n: v.clone() for n, v in state.items()}, gen.get_offset()
    with torch.no_grad():
        for n, v in state.items():
            v.copy_(saved[n])
    gen.set_offset(offset)
    want = eager()
    graph_against_eager(tag, state, saved, graphed, got, want)
    print(f"[{tag}] (a) the generator's offset {offset} -> {graphed_offset} replayed, {gen.get_offset()} eager")
    check(graphed_offset == gen.get_offset() > offset,
          f"{tag}: generator offset {graphed_offset} replayed, {gen.get_offset()} eager, from {offset}")
    del saved, graphed
    expected = train_step_launches(k, depth, mlp_bwd)
    for name, c in counts.items():
        print(f"[{tag}] (b) launches of the {name} call: { {n: v for n, v in c.items() if v} }")
        check(c == {**dict.fromkeys(c, 0), **expected}, f"{tag}: the {name} call's launches {c}, expected {expected}")

    # (c) s per optimizer step in turns, busy share, capture, pool, peak memory
    runs = {"graph": lambda: call(batches), "eager": eager}
    turns = ms_per_step_in_turns(runs, k, TRAIN_GRAPH_ROUNDS)
    busy, peak = {}, {}
    for name, run in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        busy[name] = device_busy(run, k)
        peak[name] = torch.cuda.max_memory_allocated() / 1e9
    ms = {name: statistics.median(v) for name, v in turns.items()}
    print(f"[{tag}] (c) {card}: {MODEL} ({depth} blocks, batch {TRAIN_BATCH} x {TRAIN_SEQ}, bf16 stream, "
          f"remat, --mlp-bwd {mlp_bwd}), {k} optimizer steps a call: s per optimizer step in "
          f"{TRAIN_GRAPH_ROUNDS} rounds of turns, the order reversed each round: graph " + ", ".join(f"{v / 1000:.6f}" for v in turns["graph"])
          + " against eager " + ", ".join(f"{v / 1000:.6f}" for v in turns["eager"])
          + f"; medians {ms['graph'] / 1000:.6f} against {ms['eager'] / 1000:.6f} "
          f"({ms['eager'] / ms['graph']:.4f}x); device ms a step {busy['graph'][0]:.3f} against "
          f"{busy['eager'][0]:.3f}, busy {busy['graph'][1]:.1f}% against {busy['eager'][1]:.1f}% over one "
          f"call; capture {call.graph.capture_ms:.1f} ms, pool {call.graph.pool_bytes / 2 ** 20:.0f} MiB; "
          f"peak allocated over a call {peak['graph']:.2f} GB graphed, {peak['eager']:.2f} GB eager")
    check(all(math.isfinite(v) and v > 0 for v in ms.values()), f"{tag}: s per step {ms}")
    del call, runs, model, ema, opt, state
    torch.cuda.empty_cache()
    if mlp_bwd == "xla":
        train_graph_cli(dev, tmp, tag, mlp_bwd, depth)
    print(f"[{tag}] the phase took {time.perf_counter() - wall:.1f} s")
    return ms


def train_graph_cli(dev, tmp, tag, mlp_bwd, depth) -> None:
    """(d) of [train-graph]: the train CLI at DiT-B with --steps-per-call
    TRAIN_GRAPH_K --max-steps 20 --log-every 5 --ckpt-every 15 stops at
    the call boundary past 20 (24), logs at 8, 16 and 24, saves only step
    16's checkpoint and launches 24 steps' kernels; a resume from that
    checkpoint with --max-steps 24 runs one call and ends at 24. Run with
    the default backward only (the fused one runs (a)-(c): the CLI's path
    is the same)."""
    import torch
    from osu_diffusion_tpu_torch.cli import build_train_parser, train_main

    k = TRAIN_GRAPH_K
    argv = ["--data-path", train_dataset(tmp), "--data-start", "0", "--data-end", "2", "--model", MODEL,
            "--num-classes", str(NUM_CLASSES), "--global-batch-size", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--stride", "16", "--num-workers", "2",
            "--log-every", str(TRAIN_GRAPH_LOG_EVERY), "--ckpt-every", str(TRAIN_GRAPH_CKPT_EVERY),
            "--results-dir", os.path.join(tmp, tag), "--device", dev, "--mlp-bwd", mlp_bwd,
            "--steps-per-call", str(k)]
    end = -(-TRAIN_GRAPH_MAX_STEPS // k) * k
    ckpt_step = -(-TRAIN_GRAPH_CKPT_EVERY // k) * k
    for start in (None, ckpt_step):
        read = reset_launch_counts()
        wall = time.perf_counter()
        flags = (["--max-steps", str(TRAIN_GRAPH_MAX_STEPS)] if start is None else
                 ["--max-steps", str(end), "--ckpt", os.path.join(ckpt_dir, f"{start:07d}.pt")])
        summary = train_main(build_train_parser().parse_args(argv + flags))
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
        launches = read()
        with open(os.path.join(summary["experiment_dir"], "log.txt")) as f:
            log = f.read()
        logged = [int(v) for v in re.findall(r"\(step=(\d+)\) Train Loss: ", log)]
        losses = [float(v) for v in re.findall(r"Train Loss: ([^,]+),", log)]
        saved = sorted(os.listdir(summary["checkpoint_dir"]))
        steps = end - (start or 0)
        print(f"[{tag}] (d) the train CLI with --steps-per-call {k}" + (f" resumed from step {start}" if start else "")
              + f": final step {summary['final_step']}, Train Loss at steps {logged} ({losses}), checkpoints "
              f"{saved}, {wall:.1f} s wall; launches { {n: v for n, v in launches.items() if v} }")
        # JAX's call-boundary tests
        bounds = range((start or 0) + k, end + 1, k)
        want_logged = [b for b in bounds if b % TRAIN_GRAPH_LOG_EVERY < k]
        want_saved = [f"{b:07d}.pt" for b in bounds
                      if b % TRAIN_GRAPH_CKPT_EVERY < k and b >= TRAIN_GRAPH_CKPT_EVERY]
        check(summary["final_step"] == end and logged == want_logged and saved == want_saved,
              f"{tag} (d): final {summary['final_step']}, logged {logged}, saved {saved}")
        check(all(math.isfinite(v) for v in losses), f"{tag} (d): losses {losses}")
        check(f"{k} optimizer steps a call, one CUDA graph" in log and "Done!" in log,
              f"{tag} (d): the log lacks the call line or Done!")
        check(start is None or "Restored from checkpoint" in log, f"{tag} (d): the resume did not restore")
        check(launches == {**dict.fromkeys(launches, 0), **train_step_launches(steps, depth, mlp_bwd)},
              f"{tag} (d): launches {launches}")
        ckpt_dir = summary["checkpoint_dir"]
        del summary
        torch.cuda.empty_cache()


FEATURIZERS = ("native", "python")


@contextlib.contextmanager
def featurizer(name):
    """The loader's featurizer inside the block: 'native'
    (OSU_DIFFUSION_NO_NATIVE unset) or 'python' (set); checked."""
    from osu_diffusion_tpu_torch.data.dataset import featurizer_name

    old = os.environ.pop("OSU_DIFFUSION_NO_NATIVE", None)
    if name == "python":
        os.environ["OSU_DIFFUSION_NO_NATIVE"] = "1"
    try:
        check(featurizer_name() == name, f"the loader's featurizer is {featurizer_name()}, not {name}")
        yield
    finally:
        os.environ.pop("OSU_DIFFUSION_NO_NATIVE", None)
        if old is not None:
            os.environ["OSU_DIFFUSION_NO_NATIVE"] = old


def train_loader(data, end, threads):
    """The loader as the trainer builds it (trainer.py: batch 256, seq-len
    128, stride 16, cycle_length 128, shuffled, seed 0) over Track [0, end)."""
    from osu_diffusion_tpu_torch.data.dataset import BeatmapDatasetIterableFactory, get_data_loader

    return get_data_loader(
        dataset_path=data, start=0, end=end,
        iterable_factory=BeatmapDatasetIterableFactory(TRAIN_SEQ, 16, seed=SEED),
        cycle_length=TRAIN_BATCH // 2, batch_size=TRAIN_BATCH, num_workers=threads,
        shuffle=True, drop_last=True, seed=SEED)


def loader_s_per_batch(data, end, threads, batches) -> float:
    """Seconds per batch of the trainer's loader with `threads` threads over
    `batches` batches, after max(2, threads) warm-up batches: the threads
    start together, so the first round of batches arrives at once (on the
    native featurizer) and is left out."""
    it = iter(train_loader(data, end, threads))
    try:
        for _ in range(max(2, threads)):
            next(it)
        start = time.perf_counter()
        for _ in range(batches):
            next(it)
        return (time.perf_counter() - start) / batches
    finally:
        it.close()


def make_corpus_module():
    """tools/make_corpus.py (standard library only), loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_corpus", os.path.join("tools", "make_corpus.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_loader(tmp):
    """The training input path on the card's host: the native featurizer
    (built in phase_build), its parity with the Python featurizer (the fixtures and
    CORPUS_PARITY_MAPS corpus maps), maps/s both ways on one thread, the
    trainer's loader at 2 and 4 threads on both featurizers, and the cached
    loader. Returns the corpus's path."""
    import numpy as np
    from osu_diffusion_tpu_torch import native
    from osu_diffusion_tpu_torch.beatmap.objects import Beatmap
    from osu_diffusion_tpu_torch.data.dataset import (
        BeatmapDatasetIterableFactory,
        cache_dataset,
        get_cached_data_loader,
    )
    from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence

    wall = time.perf_counter()
    check(native.available(), "no g++ on PATH: the native featurizer is not built")
    info = native.build_info
    built = f"built in {info['seconds']:.1f} s" if info["seconds"] else "reused"
    print(f"[loader] native featurizer: {info['compiler']}; {built}: {os.path.relpath(info['path'])}, "
          f"{time.perf_counter() - wall:.1f} s to load")

    corpus = os.path.join(tmp, "corpus")
    start = time.perf_counter()
    make_corpus_module().write_corpus(corpus, CORPUS_MAPS, CORPUS_MAPS_PER_TRACK, SEED,
                                      CORPUS_MIN_DATAPOINTS, progress_every=0)
    tracks = CORPUS_MAPS // CORPUS_MAPS_PER_TRACK
    files = sorted(glob.glob(os.path.join(corpus, "Track*", "beatmaps", "*.osu")))
    check(len(files) == CORPUS_MAPS, f"{len(files)} corpus maps")
    print(f"[loader] corpus: {CORPUS_MAPS} maps in {tracks} tracks of {CORPUS_MAPS_PER_TRACK}, seed {SEED}, "
          f"min datapoints {CORPUS_MIN_DATAPOINTS}, written in {time.perf_counter() - start:.1f} s")

    def python_rows(path):
        return beatmap_to_sequence(Beatmap.from_path(path))

    # parity, and maps/s on one thread
    fixtures = sorted(glob.glob(os.path.join("assets", "toy_datasets", "**", "*.osu"), recursive=True))
    for what, paths, tol in (("fixture", fixtures, NATIVE_FIXTURE_TOL),
                             ("corpus", files[:CORPUS_PARITY_MAPS], NATIVE_CORPUS_TOL)):
        worst, rows = 0.0, 0
        for path in paths:
            got, want = native.featurize_file(path), python_rows(path)
            check(got.shape == want.shape, f"{path}: native {got.shape}, python {want.shape}")
            rows += got.shape[0]
            if got.size:
                worst = max(worst, float(np.abs(got - want).max()))
        print(f"[loader] parity, {len(paths)} {what} maps ({rows} rows): max |native - python| "
              f"{worst:.3e} (tolerance {tol:g})")
        check(len(paths) > 0 and worst <= tol, f"{what} parity {worst} > {tol}")
    rates = {}  # the same maps both ways, native FEATURIZE_NATIVE_PASSES times over
    for name, fn, passes in (("native", native.featurize_file, FEATURIZE_NATIVE_PASSES),
                             ("python", python_rows, 1)):
        start = time.perf_counter()
        for _ in range(passes):
            for path in files[:FEATURIZE_MAPS]:
                fn(path)
        rates[name] = passes * FEATURIZE_MAPS / (time.perf_counter() - start)
    print(f"[loader] featurize on one thread, {FEATURIZE_MAPS} corpus maps: native {rates['native']:.1f} "
          f"maps/s ({FEATURIZE_NATIVE_PASSES} passes), python {rates['python']:.1f} maps/s (1 pass): "
          f"{rates['native'] / rates['python']:.1f}x")

    # the trainer's loader alone, both featurizers
    for name in FEATURIZERS:
        with featurizer(name):
            for threads in LOADER_THREADS:
                batches = LOADER_BATCHES[name]
                s = loader_s_per_batch(corpus, tracks, threads, batches)
                print(f"[loader] the trainer's loader ({name} featurizer, {threads} threads): "
                      f"{s:.6f} s per batch of {TRAIN_BATCH} x {TRAIN_SEQ} over {batches} batches "
                      f"after {max(2, threads)} warm-up")

    # the cached loader over CACHE_MAPS maps
    cache = os.path.join(tmp, "corpus-cache.pkl")
    start = time.perf_counter()
    cache_dataset(cache, dataset_path=corpus, start=0, end=CACHE_MAPS // CORPUS_MAPS_PER_TRACK,
                  iterable_factory=BeatmapDatasetIterableFactory(TRAIN_SEQ, 16, seed=SEED))
    cache_s = time.perf_counter() - start
    loader = get_cached_data_loader(cache, batch_size=TRAIN_BATCH, shuffle=True, drop_last=True, seed=SEED)
    check(len(loader) > 0, "an empty cache")
    start, batches = time.perf_counter(), 0
    while batches < LOADER_BATCHES["native"]:
        for (win, prev), y in loader:
            check(win.shape == (TRAIN_BATCH, TRAIN_SEQ, 19) and prev.shape == (TRAIN_BATCH, 2),
                  f"cached batch {win.shape} {prev.shape}")
            batches += 1
    print(f"[loader] cached loader: cache_dataset over {CACHE_MAPS} maps in {cache_s:.2f} s "
          f"({len(loader)} batches a pass, {os.path.getsize(cache) / 2 ** 20:.1f} MiB), then "
          f"{(time.perf_counter() - start) / batches:.6f} s per batch of {TRAIN_BATCH} over {batches} batches")
    print(f"[loader] {time.perf_counter() - wall:.1f} s wall")
    return corpus


def phase_train_corpus(dev, tmp, corpus):
    """The train CLI on the corpus at the trainer's defaults (4 threads, the
    native featurizer, bf16 stream, remat, --mlp-bwd xla) with
    --profile-dir: the trace written, the featurizer logged, and whether
    the loader still sets the pace (start to start against inside-step)."""
    profile_dir = os.path.join(tmp, "train-corpus-profile")
    argv = ["--data-path", corpus, "--data-start", "0", "--data-end",
            str(CORPUS_MAPS // CORPUS_MAPS_PER_TRACK), "--model", MODEL, "--num-classes", str(NUM_CLASSES),
            "--global-batch-size", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--log-every", "5",
            "--ckpt-every", str(10 ** 9), "--results-dir", os.path.join(tmp, "train-corpus"),
            "--device", dev, "--profile-dir", profile_dir]
    with featurizer("native"):
        summary, _, numbers = run_train_cli("train-corpus", argv, TRAIN_CORPUS_STEPS,
                                            profiled=TRAIN_CORPUS_PROFILED)
    with open(os.path.join(summary["experiment_dir"], "log.txt")) as f:
        log = f.read()
    check("Featurizer: native" in log, "the trainer did not log the native featurizer")
    trace = os.path.join(profile_dir, "trace-rank0.json")
    check(os.path.isfile(trace) and os.path.getsize(trace) > 0, f"no profiler trace at {trace}")
    check(f"Profiler trace written to {trace}" in log, "the trainer did not log its trace")
    print(f"[train-corpus] --profile-dir: {os.path.getsize(trace) / 2 ** 20:.1f} MiB trace of the "
          f"first 3 steps; start to start {numbers['period_ms'] / 1000:.6f} s against "
          f"{numbers['step_ms'] / 1000:.6f} s inside train_step "
          f"({numbers['period_ms'] / numbers['step_ms']:.3f}x), busy {numbers['busy']:.1f}% "
          f"over steps {TRAIN_CORPUS_PROFILED.start}..{TRAIN_CORPUS_PROFILED.stop - 1}")
    return numbers


def train_dataset(tmp):
    """A Track dataset of TRAIN_COPIES kimi copies under tmp (made once)."""
    data = os.path.join(tmp, "tracks")
    for i in range(TRAIN_COPIES):  # label i: the file name's integer prefix
        track = os.path.join(data, f"Track{i % 2:05d}", "beatmaps")
        os.makedirs(track, exist_ok=True)
        shutil.copy(BEATMAP, os.path.join(track, f"{i:06d} kimi.osu"))
    return data


def phase_train_step_vs_plain(dev, mlp_bwd="xla", tag=None, model=None, what=MODEL, diffusion_kw=None):
    """One training step's loss and parameter gradients at batch 4: the
    card's kernels against the CPU's plain versions, same weights and
    draws, with the MLP backward `mlp_bwd` (with "fused" the card runs the
    two backward kernels, once per block, and the CPU their plain stages;
    only the MSE gradients are compared then). `model`: the DiT (default
    DiT-B at NUM_CLASSES, label dropout 0.2), `what` its name in the
    lines. `diffusion_kw`: create_diffusion's flags of the process whose
    loss and gradients are compared (default: the MSE loss; the L1 loss's
    terms are compared first only then). Returns the phase's seconds."""
    import numpy as np
    import torch
    from osu_diffusion_tpu_torch.beatmap import Beatmap
    from osu_diffusion_tpu_torch.data.dataset import default_win_func
    from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.models.dit import DiT_models
    from osu_diffusion_tpu_torch.train.train_step import StepDraws, draw_step, loss_terms

    tag = tag or ("step" if mlp_bwd == "xla" else f"step-{mlp_bwd}")

    seq = beatmap_to_sequence(Beatmap.from_path(BEATMAP))
    wins = [default_win_func(seq, s, s + TRAIN_SEQ) for s in (0, 150, 300, 450)]
    batch = (torch.from_numpy(np.stack([w for w, _ in wins])),
             torch.from_numpy(np.stack([p for _, p in wins])),
             torch.tensor([3, 17, 100, NUM_CLASSES - 1]))
    if model is None:
        model = DiT_models[MODEL](num_classes=NUM_CLASSES, class_dropout_prob=0.2, mlp_bwd=mlp_bwd)
    wall = time.perf_counter()
    model.load_state_dict(random_state_dict(model, torch.Generator().manual_seed(SEED + 1)))
    draws = draw_step(4, TRAIN_SEQ, 1000, 0.2, "cpu", torch.Generator().manual_seed(SEED + 2))
    draws = draws._replace(drop=torch.tensor([True, False, False, False]))
    results, l1_terms = {}, {}
    for where in ("cpu", dev):
        m = copy.deepcopy(model).to(where).train()
        args = (tuple(a.to(where) for a in batch), StepDraws(*(a.to(where) for a in draws)))
        if mlp_bwd == "xla" and diffusion_kw is None:
            # the main path's L1 loss: its terms (forward with grad, as in training)
            diffusion = create_diffusion("", noise_schedule="squaredcos_cap_v2", use_l1=True, device=where)
            terms = loss_terms(m, diffusion, *args, band=TRAIN_SEQ, dtype=torch.bfloat16)
            l1_terms[where] = {k: v.mean().item() for k, v in terms.items()}
            del terms
        # MSE for the gradients (see STEP_GRAD_REL_TOL), or the process asked for
        diffusion = create_diffusion("", noise_schedule="squaredcos_cap_v2", device=where,
                                     **(dict(use_l1=False) if diffusion_kw is None else diffusion_kw))
        read_counts = reset_launch_counts()
        terms = loss_terms(m, diffusion, *args, band=TRAIN_SEQ, dtype=torch.bfloat16)
        loss = terms["loss"].mean()
        loss.backward()
        counts = read_counts()
        results[where] = (loss.item(), {n: p.grad.float().cpu() for n, p in m.named_parameters()})
        del m, terms, loss
    depth = len(model.blocks)
    fused = (counts["adaln_mlp_bwd_prologue"], counts["adaln_mlp_bwd_epilogue"])
    check(fused == ((depth, depth) if mlp_bwd == "fused" else (0, 0)),
          f"{tag}: backward kernel launches {fused} on the card")
    # rows 2 and 8 in the forward and the remat recompute, rows 3 and 4 once a block
    rows = {"banded_attention_fwd_lse": 2 * depth, "adaln_mlp_train": 2 * depth,
            "banded_attention_bwd_dq": depth, "banded_attention_bwd_dkv": depth}
    check({k: counts[k] for k in rows} == rows, f"{tag}: training kernel launches {counts}, expected {rows}")
    if l1_terms:
        l1_rel = {k: abs(l1_terms[dev][k] - v) / abs(v) for k, v in l1_terms["cpu"].items()}
        print(f"[{tag}] {what} L1 loss terms, batch 4 x {TRAIN_SEQ}, bf16 stream: card {l1_terms[dev]} "
              f"cpu {l1_terms['cpu']}; relative errors {l1_rel} (tol {STEP_LOSS_REL_TOL})")
        check(set(l1_rel) == {"loss", "l1", "vb"} and max(l1_rel.values()) <= STEP_LOSS_REL_TOL,
              f"L1 step terms: {l1_rel}")
    (loss_cpu, g_cpu), (loss_dev, g_dev) = results["cpu"], results[dev]
    loss_rel = abs(loss_dev - loss_cpu) / abs(loss_cpu)
    errs = sorted(((rel_err(g_dev[n], g_cpu[n]), n) for n in g_cpu), reverse=True)
    loss_name = "MSE" if diffusion_kw is None else " ".join(f"{k}={v}" for k, v in diffusion_kw.items())
    wall = time.perf_counter() - wall
    print(f"[{tag}] {what} --mlp-bwd {mlp_bwd} train step, batch 4 x {TRAIN_SEQ}, bf16 stream, {loss_name}: loss card {loss_dev:.6f} "
          f"cpu {loss_cpu:.6f} (rel {loss_rel:.2e}, tol {STEP_LOSS_REL_TOL}); gradient error of max, "
          f"worst {errs[0][0]:.2e} ({errs[0][1]}), median {errs[len(errs) // 2][0]:.2e} over "
          f"{len(errs)} tensors (tol {STEP_GRAD_REL_TOL}); backward kernel launches on the card {fused}; "
          f"the phase took {wall:.1f} s")
    check(loss_rel <= STEP_LOSS_REL_TOL, f"{tag} loss: {loss_rel} > {STEP_LOSS_REL_TOL}")
    check(errs[0][0] <= STEP_GRAD_REL_TOL, f"{tag} gradients: {errs[:5]}")
    return wall


BPD_STEPS = 50  # [bpd]: the squaredcos_cap_v2 process respaced to this many steps
BPD_STARTS = (0, 300)  # [bpd]: the two kimi windows' first rows, TRAIN_SEQ rows each
# [bpd], calc_bpd_loop with the kernels against the same loop through the
# plain versions (bf16 operands) on the card, same draws: total_bpd and each
# (N, S) array within this share of its max |plain|. Each entry is a
# function of one forward at its own t (no chain carries a difference from
# step to step), so one forward's FORWARD_REL_TOL bounds it; prior_bpd reads
# no model and must agree bit for bit.
BPD_REL_TOL = FORWARD_REL_TOL
# the t = 0 column (the decoder NLL, 1/255 bins) on its own, each entry
# within this share of itself: the NLL is -log of a bin's probability mass
# under N(mean, sigma) with sigma ~ 1e-2, so a mean that moves by one
# forward's error, ~1e-3 of sigma, moves it by ~1e-3 of itself
BPD_DECODER_REL_TOL = FORWARD_REL_TOL
FIXED_VAR_STEPS = 10  # [sample-fixed-var]: the CFG chain's steps


def phase_bpd(dev):
    """calc_bpd_loop at DiT-B (the [slice] weights) on two kimi windows of
    TRAIN_SEQ rows, BPD_STEPS respaced squaredcos steps, band BAND, the
    same per-step noise_fn draws: through the kernels captured and replayed
    (rows 1 and 7, depth x BPD_STEPS launches each, no other kernel), the
    same eager (bit for bit; s per step in turns, busy shares), and through
    their plain versions on the card (no launch). Returns the seconds."""
    import numpy as np
    import torch
    from osu_diffusion_tpu_torch.beatmap import Beatmap
    from osu_diffusion_tpu_torch.data.dataset import default_win_func
    from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence
    from osu_diffusion_tpu_torch.data.process import process_batch
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.models.dit import DiT_models

    wall = time.perf_counter()
    model = DiT_models[MODEL](num_classes=NUM_CLASSES)
    model.load_state_dict(random_state_dict(model, torch.Generator().manual_seed(SEED)))
    model = model.to(dev).eval()
    seq = beatmap_to_sequence(Beatmap.from_path(BEATMAP))
    wins = [default_win_func(seq, s, s + TRAIN_SEQ) for s in BPD_STARTS]
    raw, prev = (torch.from_numpy(np.stack([w[i] for w in wins])).to(dev) for i in (0, 1))
    x0, o, c = process_batch(raw, prev, augment=False, offset01=torch.zeros((2, 1), device=dev))
    y = torch.tensor([3, 17], device=dev)
    diffusion = create_diffusion(str(BPD_STEPS), noise_schedule="squaredcos_cap_v2", device=dev)
    g = torch.Generator().manual_seed(SEED + 3)
    draws = [torch.randn(tuple(x0.shape), generator=g).to(dev) for _ in range(BPD_STEPS)]

    def model_fn(x, t):
        return model(x, t, o, c, y, band=BAND)

    def bpd(path):
        return diffusion.calc_bpd_loop(model_fn, x0, noise_fn=lambda k, shape: draws[k],
                                       cuda_graph=path == "kernels")

    out, ms = {}, {}
    depth = len(model.blocks)
    # the kernels captured and replayed (the default), the same eager, and
    # the plain versions (eager: a patched wrapper never reaches a graph)
    for path in ("kernels", "eager", "plain"):
        read_counts = reset_launch_counts()
        start = time.perf_counter()
        with plain_kernels() if path == "plain" else contextlib.nullcontext():
            out[path] = bpd(path)
        torch.cuda.synchronize()
        ms[path] = (time.perf_counter() - start) * 1000
        counts = read_counts()
        want = dict.fromkeys(counts, 0)
        if path != "plain":
            want.update(banded_attention=depth * BPD_STEPS, adaln_mlp=depth * BPD_STEPS)
        check(counts == want, f"[bpd] {path} launches {counts}, expected {want}")
    same = all(torch.equal(out["kernels"][k], out["eager"][k]) for k in out["eager"])
    turns = ms_per_step_in_turns({"graph": lambda: bpd("kernels"), "eager": lambda: bpd("eager")},
                                 BPD_STEPS, 2)
    step_ms = {k: statistics.median(v) for k, v in turns.items()}
    busy = {k: 100 * device_ms_per_step(lambda p=p: bpd(p), BPD_STEPS) / step_ms[k]
            for k, p in (("graph", "kernels"), ("eager", "eager"))}
    print(f"[bpd] {device_line()}: graphed against eager, bit for bit {same}; s per step in turns (graph, "
          f"eager, eager, graph) graph {', '.join(f'{v / 1000:.6f}' for v in turns['graph'])} against eager "
          f"{', '.join(f'{v / 1000:.6f}' for v in turns['eager'])}; medians {step_ms['graph'] / 1000:.6f} "
          f"against {step_ms['eager'] / 1000:.6f} ({step_ms['eager'] / step_ms['graph']:.3f}x), busy "
          f"{busy['graph']:.1f}% against {busy['eager']:.1f}%")
    check(same, "[bpd] the graphed loop's entries differ from the eager loop's")
    got, plain = ({k: v.float().cpu() for k, v in out[p].items()} for p in ("kernels", "plain"))
    check(all(bool(torch.isfinite(v).all()) for v in got.values()), "[bpd] non-finite entries")
    check(tuple(got["vb"].shape) == (2, BPD_STEPS) and tuple(got["total_bpd"].shape) == (2,),
          f"[bpd] shapes {({k: tuple(v.shape) for k, v in got.items()})}")
    rels = {k: rel_err(got[k], plain[k]) for k in ("total_bpd", "vb", "xstart_mse", "mse")}
    decoder = ((got["vb"][:, -1] - plain["vb"][:, -1]).abs() / plain["vb"][:, -1].abs()).max().item()
    prior_equal = torch.equal(got["prior_bpd"], plain["prior_bpd"])
    wall = time.perf_counter() - wall
    print(f"[bpd] {MODEL} calc_bpd_loop, batch 2 x {TRAIN_SEQ} (kimi rows {BPD_STARTS}), {BPD_STEPS} "
          f"squaredcos steps, band {BAND}: total_bpd kernels {got['total_bpd'].tolist()} plain "
          f"{plain['total_bpd'].tolist()}, prior_bpd {got['prior_bpd'].tolist()} (equal bit for bit: "
          f"{prior_equal}); errors against the plain versions, share of max |plain| "
          f"{ {k: f'{v:.3e}' for k, v in rels.items()} } (tol {BPD_REL_TOL}); the t = 0 column (decoder "
          f"NLL) kernels {got['vb'][:, -1].tolist()} plain {plain['vb'][:, -1].tolist()} bits, "
          f"relative error {decoder:.3e} (tol {BPD_DECODER_REL_TOL}); launches {depth * BPD_STEPS} each of "
          f"rows 1 and 7; the loop {ms['kernels']:.1f} ms with the kernels (graphed; {ms['eager']:.1f} "
          f"eager), {ms['plain']:.1f} ms plain; "
          f"the phase took {wall:.1f} s")
    check(prior_equal, "[bpd] prior_bpd differs between the two runs")
    check(max(rels.values()) <= BPD_REL_TOL, f"[bpd] errors {rels}")
    check(decoder <= BPD_DECODER_REL_TOL, f"[bpd] decoder NLL error {decoder}")
    return wall


def phase_train_kl(dev):
    """One DiT-B train step card vs CPU (phase_train_step_vs_plain's checks
    and tolerances) under create_diffusion(use_kl=True), and under
    predict_xstart=True on a DiT with learn_sigma=False (C output channels,
    the fixed large variance) with --mlp-bwd fused. Returns the seconds."""
    from osu_diffusion_tpu_torch.models.dit import DiT_models

    wall = phase_train_step_vs_plain(dev, tag="train-kl", diffusion_kw=dict(use_kl=True))
    model = DiT_models[MODEL](num_classes=NUM_CLASSES, class_dropout_prob=0.2, mlp_bwd="fused",
                              learn_sigma=False)
    wall += phase_train_step_vs_plain(dev, "fused", tag="train-kl", model=model,
                                      what=f"{MODEL} learn_sigma=False",
                                      diffusion_kw=dict(predict_xstart=True, learn_sigma=False))
    return wall


def phase_sample_fixed_var(dev):
    """A FIXED_VAR_STEPS-step CFG chain through the Sampler on kimi's full
    window (T 757 padded to 768, band BAND) on a DiT-B with learn_sigma=False
    (the [slice] seed) under sigma_small (the fixed posterior variance).
    First one forward_with_cfg at t = 999, card kernels against the CPU's
    plain versions, within FORWARD_REL_TOL (phase_forward_vs_plain). Then
    the chain with the kernels (rows 1 and 7, steps x depth launches each)
    against the same chain through their plain versions on the card (bf16
    operands), gated at CP_CHAIN_FLOOR_MULTIPLE of the noise floor: the
    plain chain against itself with f32 operands (two correct chains; at t
    near T the x0 prediction amplifies any rounding difference before the
    clamp). Returns the seconds."""
    import torch
    from osu_diffusion_tpu_torch.beatmap import Beatmap
    from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence
    from osu_diffusion_tpu_torch.data.process import split_and_process_sequence_no_augment
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.models.dit import DiT_models
    from osu_diffusion_tpu_torch.sampling import Sampler, prepare_cfg_inputs

    wall = time.perf_counter()
    model = DiT_models[MODEL](num_classes=NUM_CLASSES, learn_sigma=False)
    model.load_state_dict(random_state_dict(model, torch.Generator().manual_seed(SEED)))
    model = model.to(dev).eval()
    seq = torch.from_numpy(beatmap_to_sequence(Beatmap.from_path(BEATMAP))).to(dev)
    (_, seq_o, seq_c), t_real = split_and_process_sequence_no_augment(seq)
    generator = torch.Generator(device=dev).manual_seed(SEED)
    call_args = prepare_cfg_inputs(seq_o - seq_o[0], seq_c, [3], NUM_CLASSES, generator)
    diffusion = create_diffusion(str(FIXED_VAR_STEPS), noise_schedule="squaredcos_cap_v2",
                                 learn_sigma=False, sigma_small=True, device=dev)
    check(diffusion.model_var_type == "fixed_small", f"variance type {diffusion.model_var_type}")
    sampler = Sampler(model, diffusion, cfg_scale=CFG_SCALE, band=BAND)
    phase_forward_vs_plain(dev, sampler, call_args, tag="sample-fixed-var-forward", step=999)

    chains = {}
    for path in ("kernels", "plain", "plain-f32"):
        read_counts = reset_launch_counts()
        operands = torch.float32 if path == "plain-f32" else None
        # the kernels' chain as the CLI runs it (graphed); the plain ones eager, as patched
        chain_sampler = sampler if path == "kernels" else Sampler(
            model, diffusion, cfg_scale=CFG_SCALE, band=BAND, cuda_graph=False)
        with plain_kernels(operands) if path != "kernels" else contextlib.nullcontext():
            chains[path] = chain_sampler(*call_args, generator=torch.Generator(device=dev).manual_seed(SEED + 4))
        counts = read_counts()
        depth = len(model.blocks)
        want = dict.fromkeys(counts, 0)
        if path == "kernels":
            want.update(banded_attention=depth * FIXED_VAR_STEPS, adaln_mlp=depth * FIXED_VAR_STEPS)
        check(counts == want, f"[sample-fixed-var] {path} launches {counts}, expected {want}")
        check(tuple(chains[path].shape) == (2, t_real, 2) and bool(torch.isfinite(chains[path]).all()),
              f"[sample-fixed-var] {path} chain {tuple(chains[path].shape)}")
    gap = (chains["kernels"] - chains["plain"]).abs()
    floor = (chains["plain"] - chains["plain-f32"]).abs()
    wall = time.perf_counter() - wall
    print(f"[sample-fixed-var] {MODEL} learn_sigma=False, fixed_small, {FIXED_VAR_STEPS} CFG steps on kimi "
          f"(T {t_real} padded to 768, band {BAND}): |kernels - plain| max {gap.max().item():.3e} median "
          f"{gap.median().item():.3e}; noise floor |plain - plain f32 operands| max {floor.max().item():.3e} "
          f"median {floor.median().item():.3e}; ratios max {gap.max().item() / max(floor.max().item(), 1e-30):.3f} "
          f"median {gap.median().item() / max(floor.median().item(), 1e-30):.3f} (tol {CP_CHAIN_FLOOR_MULTIPLE}); "
          f"launches {depth * FIXED_VAR_STEPS} each of rows 1 and 7; the phase took {wall:.1f} s")
    for stat in ("max", "median"):
        g, f = getattr(gap, stat)().item(), getattr(floor, stat)().item()
        check(g <= CP_CHAIN_FLOOR_MULTIPLE * f,
              f"[sample-fixed-var] chain gap {stat} {g} above {CP_CHAIN_FLOOR_MULTIPLE} x the floor's {f}")
    return wall


def phase_train_modes(dev, tmp, ckpt_path):
    """train_nodist_torch.py (the refine model: timestep 0 only) with
    --embed-only-epochs 1, resumed from the [train] run's checkpoint (from
    the adaLN-Zero init the label table gets no gradient until the zero-init
    layers move), 3 steps at DiT-B inside the frozen epoch (stride 8: ~4
    batches an epoch): every parameter but the label table keeps the
    checkpoint's value bit for bit, the table moves, losses are finite, and
    the log has the freeze line."""
    import runpy

    import torch
    from osu_diffusion_tpu_torch.train import trainer
    from osu_diffusion_tpu_torch.train.checkpoint import load_train_checkpoint

    data = train_dataset(tmp)
    start = int(load_train_checkpoint(ckpt_path)["step"])
    argv = ["--data-path", data, "--data-start", "0", "--data-end", "2", "--model", MODEL,
            "--num-classes", str(NUM_CLASSES), "--global-batch-size", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--stride", "8", "--num-workers", "2", "--log-every", "1",
            "--ckpt-every", str(10 ** 9), "--results-dir", os.path.join(tmp, "train-modes"),
            "--device", dev, "--embed-only-epochs", "1", "--ckpt", ckpt_path,
            "--max-steps", str(start + 3)]
    seen = {}
    orig_train, orig_step = trainer.train, trainer.train_step

    def spy_train(config):
        seen["config"] = config
        seen["summary"] = orig_train(config)
        return seen["summary"]

    def spy_step(model, *args, **kwargs):
        seen["model"] = model
        return orig_step(model, *args, **kwargs)

    trainer.train, trainer.train_step = spy_train, spy_step
    argv0 = sys.argv
    sys.argv = ["train_nodist_torch.py", *argv]
    try:
        runpy.run_path("train_nodist_torch.py", run_name="__main__")
    finally:
        trainer.train, trainer.train_step, sys.argv = orig_train, orig_step, argv0
    config, summary = seen["config"], seen["summary"]
    with open(os.path.join(summary["experiment_dir"], "log.txt")) as f:
        log = f.read()
    losses = [float(v) for v in re.findall(r"Train Loss: ([^,]+),", log)]
    before = load_train_checkpoint(ckpt_path)["model"]
    after = {k: v.cpu() for k, v in seen["model"].state_dict().items()}
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    print(f"[train-modes] train_nodist_torch.py, max_timestep {config.max_timestep}, --embed-only-epochs "
          f"{config.embed_only_epochs}, from step {start}: final step {summary['final_step']}, losses "
          f"{losses}; tensors that moved {moved} of {len(before)}")
    check(config.max_timestep == 1 and summary["final_step"] == start + 3, f"train modes: {summary}")
    check(len(losses) == 3 and all(math.isfinite(v) for v in losses), f"train modes losses {losses}")
    check("Freezing non-embedding layers for 1 epochs" in log and "Un-freezing" not in log,
          "train modes: the freeze line, or an epoch boundary inside the 3 steps")
    check(moved == [trainer.LABEL_TABLE], f"train modes: moved {moved}")


def phase_attention_cp(dev, tag="attn-cp", cases=ATTN_CP_CASES, dh=64):
    """Rows 5-6: the four ranged entries against their plain versions (bf16
    operands, and f32), every output on the rows it defines, at head dim
    `dh`; at the main shapes (the CP training shard's left edge, and at
    DiT-B the sampling shard) their times beside bounds, plain versions and
    SDPA with the band-and-bounds mask. [attn-cp-xl] prints the ranged
    builds at Dh 72, Hopper and WMMA (0 spill bytes required of each).
    Returns the numbers of the DiT-B main shapes."""
    import types

    import torch
    import torch.nn.functional as F
    from osu_diffusion_tpu_torch.ops import banded_attention as ba
    from osu_diffusion_tpu_torch.parallel.context import BLOCK, shard_bounds

    g = torch.Generator(device=dev).manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32
    results = {}
    if dh == 64:
        print_sm90_resources(tag, ("ranged fwd bf16", "ranged fwd f32", "ranged fwd f32->bf16", "ranged dq",
                                   "ranged dkv"))
    else:  # the builds XL under context parallelism runs: Hopper, and the f32 stream's WMMA dq and dk/dv
        print_sm90_resources(tag, ("ranged fwd bf16 dh72", "ranged fwd f32 dh72", "ranged fwd f32->bf16 dh72")
                             + SM90_BWD_CP_XL_BUILDS)
        wmma = {n_: r for n_, r in wmma_resources().items() if n_.startswith("wmma ranged") and n_.endswith("dh72")}
        print(f"[{tag}] WMMA bodies (ptxas): " + "; ".join(
            f"{n_} {r['registers']} registers, {r['spill_bytes']} spill bytes, {r['smem_bytes']} B shared "
            f"memory a CTA" for n_, r in sorted(wmma.items())))
        check(len(wmma) == 2 and all(r["spill_bytes"] == 0 for r in wmma.values()),
              f"{tag}: the ranged WMMA builds at Dh 72: {wmma}")
    for name, n, h, t_loc, band, idx, p, valid, stream in cases:
        dtype = f32 if stream == "f32" else bf16
        halo = -(-band // BLOCK) * BLOCK
        bounds = shard_bounds(t_loc, halo, types.SimpleNamespace(model_rank=idx, num_model=p), valid)
        k_lo, k_hi, q_lo, q_hi = bounds
        t = t_loc + 2 * halo
        # one contiguous layout for q/k/v, as parallel/context.py builds them
        q, k, v = (torch.randn((n, h, t, dh), generator=g, device=dev).to(dtype) for _ in range(3))
        do = torch.randn((n, t, h, dh), generator=g, device=dev).to(dtype).permute(0, 2, 1, 3)
        o_inf = ba.banded_attention_ranged(q, k, v, band, bounds)
        o, lse = ba.banded_attention_ranged_fwd_lse(q, k, v, band, bounds)
        dq = ba.banded_attention_ranged_bwd_dq(q, k, v, o, lse, do, band, bounds)
        dk, dv = ba.banded_attention_ranged_bwd_dkv(q, k, v, o, lse, do, band, bounds)
        torch.cuda.synchronize()
        body = {"no-lse": ba.banded_attention_ranged.body, "fwd": ba.banded_attention_ranged_fwd_lse.body,
                "dq": ba.banded_attention_ranged_bwd_dq.body, "dkv": ba.banded_attention_ranged_bwd_dkv.body}
        want = {"no-lse": FWD_BODY[stream], "fwd": FWD_BODY[stream], "dq": BODY[stream], "dkv": BODY[stream]}
        check(body == want, f"{tag} {name}: bodies {body}, want {want}")
        # the forward entries, no atomics: the same bits on a second call
        again = ba.banded_attention_ranged_fwd_lse(q, k, v, band, bounds)
        same = (torch.equal(ba.banded_attention_ranged(q, k, v, band, bounds), o_inf)
                and torch.equal(again[0], o) and torch.equal(again[1], lse))
        check(same, f"{tag} {name}: a second forward call gave other bits")
        rounded = None
        if stream == "f32":  # o in bf16 from the same f32 q/k/v (the int8 block's): the f32 o, rounded
            o_bf16 = ba.banded_attention_ranged(q, k, v, band, bounds, out_dtype=bf16)
            torch.cuda.synchronize()
            defined = slice(q_lo, q_hi)
            rounded = o_bf16.dtype == bf16 and torch.equal(o_bf16[:, :, defined], o_inf[:, :, defined].to(bf16))
            check(rounded and ba.banded_attention_ranged.body == "sm90",
                  f"{tag} {name}: the ranged bf16 o is not the rounded f32 o ({ba.banded_attention_ranged.body})")
        o16, lse16 = ba.banded_attention_fwd_lse_reference(q, k, v, band, t, bf16, bounds)
        grads16 = ba.banded_attention_bwd_reference(q, k, v, o, lse, do, band, t, bf16, bounds)
        o32, lse32 = ba.banded_attention_fwd_lse_reference(q, k, v, band, t, f32, bounds)
        grads32 = ba.banded_attention_bwd_reference(q, k, v, o32, lse32, do, band, t, f32, bounds)
        rows = slice(q_lo, q_hi)  # the rows the forward defines
        lse_r, lse16_r, lse32_r = (a.view(n, h, t)[:, :, rows] for a in (lse, lse16, lse32))
        has_key = lse16_r > -1e29
        errs = {"lse": (max_err(lse_r[has_key], lse16_r[has_key]), max_err(lse_r[has_key], lse32_r[has_key]))}
        for out, got, w16, w32 in (("o", o[:, :, rows], o16[:, :, rows], o32[:, :, rows]),
                                   ("o_inf", o_inf[:, :, rows], o16[:, :, rows], o32[:, :, rows]),
                                   *zip(("dq", "dk", "dv"), (dq, dk, dv), grads16, grads32)):
            check(bool(torch.isfinite(got).all()), f"{tag} {name}: non-finite {out}")
            errs[out] = (rel_err(got, w16), rel_err(got, w32))
        print(f"[{tag}] {name}: N={n} H={h} T_loc={t_loc} T_ext={t} Dh={dh} band={band} shard {idx} of {p} "
              f"valid={valid} bounds k [{k_lo}, {k_hi}) q [{q_lo}, {q_hi}) {stream} "
              f"body no-lse={body['no-lse']} fwd={body['fwd']} dq={body['dq']} dkv={body['dkv']} "
              f"(forward: same bits on a second call {same}; bf16 o the rounded f32 o: {rounded}) "
              + " ".join(f"{k_}={a:.2e}/{b:.2e}" for k_, (a, b) in errs.items())
              + f" (bf16/f32 plain; tol lse {LSE_TOL}/{LSE_TOL_F32} abs, "
              f"others {TRAIN_TOL_BF16}/{TRAIN_TOL_F32} of max)")
        check(errs["lse"][0] <= LSE_TOL and errs["lse"][1] <= LSE_TOL_F32, f"{tag} lse {name}: {errs['lse']}")
        check(bool((lse_r[~has_key] < -1e29).all()), f"{tag} lse {name}: rows without a key not ~-1e30")
        for out in ("o", "o_inf", "dq", "dk", "dv"):
            check(errs[out][0] <= TRAIN_TOL_BF16, f"{tag} {out} {name}: {errs[out][0]} > {TRAIN_TOL_BF16}")
            check(errs[out][1] <= TRAIN_TOL_F32, f"{tag} {out} {name}: {errs[out][1]} > {TRAIN_TOL_F32}")
        check(not dq[:, :, :q_lo].any() and not dq[:, :, q_hi:].any(), f"{tag} {name}: dq on pad query rows")
        check(not dk[:, :, :k_lo].any() and not dv[:, :, max(k_lo, k_hi):].any(),
              f"{tag} {name}: dk/dv on masked keys")
        if name not in ("train_left_edge", "sample_shard0"):
            continue
        # SDPA with the band and the key bounds as a boolean mask on the
        # query rows [q_lo, q_hi): the same function as the ranged entries
        idx_t = torch.arange(t, device=dev)
        keys = (idx_t >= k_lo) & (idx_t < k_hi)
        mask = (ba.banded_attention_mask(t, band, dev) & keys[None, :])[rows]
        q_rows = q[:, :, rows]
        allowed = ba._allowed(t, band, t, "cpu", query_valid=True, bounds=bounds)
        pairs = int(allowed.sum()) * n * h
        # the bytes the function needs: q, o, lse, do and dq on the rows
        # [q_lo, q_hi), k, v, dk and dv on the keys some query there reaches
        row_bytes = n * h * dh * q.element_size()
        n_q, n_k = q_hi - q_lo, int(allowed.any(dim=0).sum())
        lse_bytes = n_q * n * h * 4

        def ranged_bytes(q_tensors, k_tensors, with_lse=True):
            return row_bytes * (n_q * q_tensors + n_k * k_tensors) + (lse_bytes if with_lse else 0)

        if name == "sample_shard0":  # the sampling shard: the inference entry
            ms = cuda_ms(lambda: ba.banded_attention_ranged(q, k, v, band, bounds))
            ms16 = cuda_ms(lambda: ba.banded_attention_ranged(q, k, v, band, bounds, out_dtype=bf16))
            plain_ms = cuda_ms(lambda: ba.banded_attention_fwd_lse_reference(q, k, v, band, t, f32, bounds))
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q_rows, k, v, attn_mask=mask))
            b = bound(ranged_bytes(2, 2, with_lse=False), 4 * dh * pairs)  # q, o; k, v
            # with a bf16 o: q, k, v in f32, o in half the bytes
            b16 = bound(ranged_bytes(2, 2, with_lse=False) - n_q * n * h * dh * 2, 4 * dh * pairs)
            print(f"[{tag}] {name}: ranged (no LSE) {ms:.4f} ms (bf16 o, the int8 block's, {ms16:.4f} ms), "
                  f"plain f32 {plain_ms:.4f} ms, SDPA (masked) {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']}; bf16 o {b16['bound_ms']:.4f} ms)")
            results["banded_attention_ranged"] = {
                "max_abs_err": max_err(o_inf[:, :, rows], o16[:, :, rows]), "ms": ms,
                "plain_ms": plain_ms, **b, "library_ms": library_ms}
            continue
        check(torch.equal(dq, ba.banded_attention_ranged_bwd_dq(q, k, v, o, lse, do, band, bounds)),
              f"{tag} dq {name} differs run to run")
        fwd_ms = cuda_ms(lambda: ba.banded_attention_ranged_fwd_lse(q, k, v, band, bounds))
        dq_ms = cuda_ms(lambda: ba.banded_attention_ranged_bwd_dq(q, k, v, o, lse, do, band, bounds))
        dkv_ms = cuda_ms(lambda: ba.banded_attention_ranged_bwd_dkv(q, k, v, o, lse, do, band, bounds))
        fwd_plain_ms = cuda_ms(lambda: ba.banded_attention_fwd_lse_reference(q, k, v, band, t, f32, bounds))
        bwd_plain_ms = cuda_ms(lambda: ba.banded_attention_bwd_reference(
            q, k, v, o32, lse32, do, band, t, f32, bounds))
        ql, kl, vl = (a.detach().requires_grad_() for a in (q_rows, k, v))
        sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask))
        out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do[:, :, rows], retain_graph=True))
        bounds_ms = {"fwd_lse": bound(ranged_bytes(2, 2), 4 * dh * pairs),  # q, o; k, v
                     "dq": bound(ranged_bytes(4, 2), 6 * dh * pairs),  # q, o, do, dq; k, v
                     "dkv": bound(ranged_bytes(3, 4), 8 * dh * pairs)}  # q, o, do; k, v, dk, dv
        print(f"[{tag}] {name}: fwd+lse {fwd_ms:.4f} ms, dq {dq_ms:.4f} ms, dk/dv {dkv_ms:.4f} ms; "
              f"plain f32 fwd {fwd_plain_ms:.4f} ms, bwd (dq, dk, dv) {bwd_plain_ms:.4f} ms; SDPA (masked) "
              f"fwd {sdpa_fwd_ms:.4f} ms, bwd {sdpa_bwd_ms:.4f} ms; bounds "
              + ", ".join(f"{k_} {b['bound_ms']:.4f} ms ({b['bound_by']})" for k_, b in bounds_ms.items()))
        if tag != "attn-cp":
            continue
        results.update({
            "banded_attention_ranged_fwd_lse": {
                "max_abs_err": max_err(o[:, :, rows], o16[:, :, rows]), "ms": fwd_ms,
                "plain_ms": fwd_plain_ms, **bounds_ms["fwd_lse"], "library_ms": sdpa_fwd_ms},
            "banded_attention_ranged_bwd_dq": {
                "max_abs_err": max_err(dq, grads16[0]), "ms": dq_ms, "plain_ms": bwd_plain_ms,
                **bounds_ms["dq"], "library_ms": sdpa_bwd_ms},
            "banded_attention_ranged_bwd_dkv": {
                "max_abs_err": max(max_err(dk, grads16[1]), max_err(dv, grads16[2])), "ms": dkv_ms,
                "plain_ms": bwd_plain_ms, **bounds_ms["dkv"], "library_ms": sdpa_bwd_ms},
        })
    return results


def cp_step_inputs():
    """[step-cp]'s seeded DiT-B (52670 classes, dropout 0.2, random
    weights), a batch of 4 kimi windows of CP_SEQ rows and the step's draws,
    on the CPU."""
    import numpy as np
    import torch
    from osu_diffusion_tpu_torch.beatmap import Beatmap
    from osu_diffusion_tpu_torch.data.dataset import default_win_func
    from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence
    from osu_diffusion_tpu_torch.models.dit import DiT_models
    from osu_diffusion_tpu_torch.train.train_step import draw_step

    seq = beatmap_to_sequence(Beatmap.from_path(BEATMAP))
    wins = [default_win_func(seq, s, s + CP_SEQ) for s in (0, 80, 160, len(seq) - CP_SEQ)]
    batch = (torch.from_numpy(np.stack([w for w, _ in wins])),
             torch.from_numpy(np.stack([p for _, p in wins])),
             torch.tensor([3, 17, 100, NUM_CLASSES - 1]))
    model = DiT_models[MODEL](num_classes=NUM_CLASSES, class_dropout_prob=0.2)
    model.load_state_dict(random_state_dict(model, torch.Generator().manual_seed(SEED + 1)))
    draws = draw_step(4, CP_SEQ, 1000, 0.2, "cpu", torch.Generator().manual_seed(SEED + 2))
    return model, batch, draws._replace(drop=torch.tensor([True, False, False, False]))


def cp_step_grads(dev, mesh=None):
    """The MSE loss and every parameter gradient of one DiT-B step at
    cp_step_inputs, bf16 stream, band 128; over `mesh` each rank takes its
    rows and the gradients and loss are summed and averaged over the ranks."""
    import torch
    import torch.distributed as dist
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.train.train_step import StepDraws, all_reduce_grads, loss_terms

    model, batch, draws = cp_step_inputs()
    model = model.to(dev).train()
    diffusion = create_diffusion("", noise_schedule="squaredcos_cap_v2", use_l1=False, device=dev)
    world = 1 if mesh is None else mesh.world
    terms = loss_terms(model, diffusion, tuple(a.to(dev) for a in batch),
                       StepDraws(*(a.to(dev) for a in draws)), band=BAND, dtype=torch.bfloat16, cp=mesh)
    loss = terms["loss"].mean()
    (loss / world).backward()
    loss = loss.detach()
    if mesh is not None:
        all_reduce_grads(list(model.parameters()))
        dist.all_reduce(loss)
    return (loss / world).item(), {n: p.grad.float().cpu() for n, p in model.named_parameters()}


def cp_exchange_errors(dev, mesh) -> dict:
    """[attn-cp-exchange] on this rank: context_parallel_banded_attention
    on its rows against the one-device banded_attention on the whole
    sequence, both on the card: the output and the gradients of
    sum(sin(out)) over the rows below valid_len (the one-device backward
    gives the pad queries past valid_len no gradient; CP, as the JAX
    package, does), each as its error of max and whether it is finite."""
    import torch
    from osu_diffusion_tpu_torch.ops.banded_attention import banded_attention
    from osu_diffusion_tpu_torch.parallel.context import context_parallel_banded_attention, shard_rows

    out = {}
    for name, n, t, valid in CP_EXCHANGE_CASES:
        rows = shard_rows(t, mesh)
        keep = (torch.arange(t, device=dev) < (valid or t)).float()[:, None]
        for stream, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            g = torch.Generator(device=dev).manual_seed(SEED + 3)
            full = [torch.randn((n, 12, t, 64), generator=g, device=dev).to(dtype).requires_grad_()
                    for _ in range(3)]
            local = [a.detach()[:, :, rows].clone().requires_grad_() for a in full]
            o_cp = context_parallel_banded_attention(*local, BAND, mesh, valid)
            (torch.sin(o_cp.float()) * keep[rows]).sum().backward()
            o_one = banded_attention(*full, BAND, valid)
            (torch.sin(o_one.float()) * keep).sum().backward()
            got = {"out": o_cp, **{f"d{x}": a.grad for x, a in zip("qkv", local)}}
            want = {"out": o_one[:, :, rows], **{f"d{x}": a.grad[:, :, rows] for x, a in zip("qkv", full)}}
            out[f"{name}_{stream}"] = {key: (rel_err(got[key], want[key]), bool(torch.isfinite(got[key]).all()))
                                       for key in got}
    return out


def timed_train_cli(argv) -> tuple[dict, dict]:
    """The train CLI on `argv` in this process, a CUDA event recorded as
    each train_step call starts: (its summary, {wall_s, peak_gb (the peak
    of allocated device memory), launches, final_step, period_ms (start to
    start over the steps from the third on; in a run of 3 steps from the
    second, of 2 from the first), log (the run's log.txt, which only rank 0 writes, or
    None)})."""
    import torch
    from osu_diffusion_tpu_torch.cli import build_train_parser, train_main
    from osu_diffusion_tpu_torch.train import trainer

    events = []
    orig_step = trainer.train_step

    def timed_step(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        events.append(start)
        return orig_step(*args, **kwargs)

    trainer.train_step = timed_step
    read_counts = reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    wall = time.perf_counter()
    try:
        summary = train_main(build_train_parser().parse_args(argv))
    finally:
        trainer.train_step = orig_step
    torch.cuda.synchronize()
    log = os.path.join(summary["experiment_dir"], "log.txt")
    first = max(0, min(2, len(events) - 2))  # the third step, or the latest that leaves an interval
    return summary, {"wall_s": time.perf_counter() - wall, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": read_counts(), "final_step": summary["final_step"],
                     "period_ms": events[first].elapsed_time(events[-1]) / (len(events) - 1 - first),
                     "log": open(log).read() if os.path.exists(log) else None}


def logged_losses(log: str) -> list[float]:
    return [float(v) for v in re.findall(r"Train Loss: ([^,]+),", log)]


def cp_argv(job, results, num_model):
    """The train CLI at the job's model (DiT-B: MODEL; [xl-train-cp]:
    XL_MODEL), batch and steps (CP_BATCH, CP_STEPS at DiT-B) and extra
    flags on the kimi copies: seq-len 512, band 128, the loader thread-free
    (num-workers 0: the two runs then read the same batches in the same
    order)."""
    argv = ["--data-path", job["data"], "--data-start", "0", "--data-end", "2", "--model", job["model"],
            "--num-classes", str(NUM_CLASSES), "--global-batch-size", str(job["batch"]),
            "--seq-len", str(CP_SEQ), "--band", str(BAND), "--stride", "16", "--num-workers", "0",
            "--log-every", "1", "--ckpt-every", str(10 ** 9), "--results-dir", results,
            "--device", "cuda", "--max-steps", str(job["steps"]), "--num-model", str(num_model),
            *job["flags"]]
    return argv + (["--context-parallel", "--dist", "gloo"] if num_model > 1 else [])


def cp_rank_main(workdir) -> int:
    """One process of the CP phases, run by phase_context_parallel and
    phase_xl_train_cp: in torchrun's environment, one of CP_RANKS gloo ranks
    sharing the card ([forward-cp], [slice-int8-cp], [step-cp], unless the
    job is `train_only`, then the CP train CLI); without it, the
    one-process train CLI run. With the job's `tp_cp` ([train-tp-cp]) the
    train CLI runs again with --mlp-bwd fused and, with model ranks, both
    backwards with the weights whole on every rank (the trainer's
    `shard_model` a no-op for those runs, so that `train_step` takes the CP
    mesh over an unsharded model). Writes its numbers (with its peak of
    allocated device memory in the train CLI) to
    <workdir>/rank<RANK>_w<WORLD_SIZE>.json."""
    import datetime

    import torch
    import torch.distributed as dist
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.models.dit import DiT_models
    from osu_diffusion_tpu_torch.models.quantize import restore_quantized
    from osu_diffusion_tpu_torch.ops import quant as tq
    from osu_diffusion_tpu_torch.parallel import make_mesh
    from osu_diffusion_tpu_torch.parallel.context import gather_slots, shard_rows
    from osu_diffusion_tpu_torch.sampling import Sampler, _bucketed, _pad_time
    from osu_diffusion_tpu_torch.train import trainer
    from osu_diffusion_tpu_torch.train.checkpoint import load_checkpoint

    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    world, rank = int(os.environ.get("WORLD_SIZE", 1)), int(os.environ.get("RANK", 0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    out = {}
    if world > 1 and not job["train_only"]:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{job['check_port']}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(minutes=5))
        mesh = make_mesh(world)
        # [forward-cp]: one forward_with_cfg at the kimi inputs, then a chain
        model = DiT_models[MODEL](num_classes=NUM_CLASSES)
        model.load_state_dict(load_checkpoint(job["ckpt"]))
        model.to(dev).eval()
        z, o, c, y = (a.to(dev) for a in torch.load(job["inputs"]))
        t_real = z.shape[1]
        sampler = Sampler(model, create_diffusion(str(CP_SAMPLE_STEPS), noise_schedule="squaredcos_cap_v2",
                                                  device=dev), cfg_scale=CFG_SCALE, band=BAND, cp=mesh)
        t_pad = _bucketed(t_real, sampler.bucket)
        rows = shard_rows(t_pad, mesh)
        with torch.no_grad():
            x, op, cpad = (_pad_time(a, t_pad)[:, rows] for a in (z, o, c))
            fwd = model.forward_with_cfg(x, torch.full((z.shape[0],), 500, device=dev), op, cpad, y,
                                         CFG_SCALE, band=BAND, valid_len=t_real, cp=mesh)
            fwd = torch.cat(gather_slots(fwd, mesh).unbind(), dim=1)[:, :t_real]
        read_counts = reset_launch_counts()
        chain = sampler(z, o, c, y, generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        out["chain_launches"] = read_counts()
        del model, sampler
        # [slice-int8-cp]: the int8 model (quantized at load, as the sample CLI's
        # --quantize-weights) on this rank's rows; its launches from the first
        # chain, its time from a second
        qmodel = restore_quantized(job["ckpt"], DiT_models[MODEL], num_classes=NUM_CLASSES).to(dev).eval()
        qsampler = Sampler(qmodel, create_diffusion(str(CP_SAMPLE_STEPS), noise_schedule="squaredcos_cap_v2",
                                                    device=dev), cfg_scale=CFG_SCALE, band=BAND, cp=mesh)
        read_counts = reset_launch_counts()
        tq.int8_out_residual.o_casts = 0
        qchain = qsampler(z, o, c, y, generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        out["int8_chain_launches"], out["int8_o_casts"] = read_counts(), tq.int8_out_residual.o_casts
        out["int8_chain_s"] = chain_seconds(qsampler, (z, o, c, y))
        if rank == 0:
            torch.save({"forward": fwd.cpu(), "chain": chain.cpu(), "int8_chain": qchain.cpu()},
                       os.path.join(workdir, "forward.pt"))
        del qmodel, qsampler
        out["exchange"] = cp_exchange_errors(dev, mesh)
        # [step-cp]
        loss, grads = cp_step_grads(dev, mesh)
        if rank == 0:
            torch.save({"loss": loss, "grads": grads}, os.path.join(workdir, "step.pt"))
        n_params = sum(g.numel() for g in grads.values())
        del grads
        # the train step's two collectives alone, on the host's clock: the
        # gradient sum (one flat f32 buffer) and one block's k/v halo exchange
        # at the [train-cp] shard (batch 32, 256 rows, halo 128, bf16)
        flat = torch.zeros(n_params, device=dev)
        kv = torch.zeros((2, CP_BATCH, 12, CP_SEQ // CP_RANKS, 64), device=dev, dtype=torch.bfloat16)
        for name, fn in (("grad_all_reduce", lambda: dist.all_reduce(flat)),
                         ("halo_exchange", lambda: gather_slots(torch.stack((kv[..., :BAND, :], kv[..., -BAND:, :])),
                                                                mesh))):
            fn()
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            out[f"{name}_s"] = (time.perf_counter() - start) / 3
        out["grad_mb"] = flat.numel() * 4 / 1e6
        del flat, kv
        dist.barrier()
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    # [train-cp]: the train CLI (it joins its own process group under torchrun)
    gc.collect()
    torch.cuda.empty_cache()
    base_gb = torch.cuda.memory_allocated() / 1e9
    # [xl-train-cp]: XL's widths at the job's depth
    with xl_at_depth(job["xl_depth"]) if "xl_depth" in job else contextlib.nullcontext():
        summary, run = timed_train_cli(cp_argv(job, os.path.join(workdir, f"results_w{world}"), world))
    run.update(params=sum(p.numel() for p in summary["ema"].parameters()), base_gb=base_gb)
    del summary
    log = run.pop("log")
    run["train_launches"] = run.pop("launches")
    out.update(run)
    if rank == 0:
        out.update(losses=logged_losses(log), done="Done!" in log, mesh_line="context parallel, band" in log)
    if job.get("tp_cp"):
        # [train-tp-cp]: the fused backward; with model ranks, both backwards
        # again over whole weights on every rank (the replicated CP step)
        runs = [("fused", "fused", False)]
        if world > 1:
            runs += [("replicated_xla", "xla", True), ("replicated_fused", "fused", True)]
        orig_shard = trainer.shard_model
        for key, mlp_bwd, replicated in runs:
            gc.collect()
            torch.cuda.empty_cache()
            base_gb = torch.cuda.memory_allocated() / 1e9
            if replicated:
                trainer.shard_model = lambda model, mesh: None
            try:
                summary, r = timed_train_cli(cp_argv(job, os.path.join(workdir, f"results_{key}_w{world}"), world)
                                             + ["--mlp-bwd", mlp_bwd])
            finally:
                trainer.shard_model = orig_shard
            r.update(params=sum(p.numel() for p in summary["ema"].parameters()), base_gb=base_gb,
                     train_launches=r.pop("launches"))
            del summary
            log = r.pop("log")
            if rank == 0:
                r.update(losses=logged_losses(log), done="Done!" in log)
            out[key] = r
    with open(os.path.join(workdir, f"rank{rank}_w{world}.json"), "w") as f:
        json.dump(out, f)
    return 0


def chain_seconds(sampler, call_args) -> float:
    """Seconds a denoise step of one more chain of `sampler` at its
    inputs (host clock around the chain, which ends in a synchronize)."""
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    sampler(*call_args, generator=torch.Generator(device=call_args[0].device).manual_seed(SEED))
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / sampler.diffusion.num_timesteps


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_cp_ranks(workdir, world, tag="train-cp", mode="--cp-rank") -> list[dict]:
    """This script with `mode` (--cp-rank or --tp-rank), as `world` ranks in
    torchrun's environment (or one plain process); fails unless every rank
    exits 0."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    if world > 1:
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), WORLD_SIZE=str(world))
    procs = []
    for rank in range(world):
        renv = {**env, "RANK": str(rank), "LOCAL_RANK": str(rank)} if world > 1 else env
        log = open(os.path.join(workdir, f"rank{rank}_w{world}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, workdir],
                                       env=renv, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.time() + CP_TIMEOUT
    rcs = []
    try:
        for proc, _ in procs:
            rcs.append(proc.wait(timeout=max(1.0, deadline - time.time())))
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, rc in enumerate(rcs):
        with open(os.path.join(workdir, f"rank{rank}_w{world}.log")) as f:
            tail = f.read()[-3000:]
        for line in tail.splitlines():
            if line.startswith(("[cp]", "[rank")):
                print(f"[{tag}] rank {rank} of {world}: {line}")
        check(rc == 0, f"{tag} rank {rank} of {world} exited {rc}:\n{tail}")
    out = []
    for rank in range(world):
        with open(os.path.join(workdir, f"rank{rank}_w{world}.json")) as f:
            out.append(json.load(f))
    return out


def tp_argv(job, results, num_model, mlp_bwd) -> list[str]:
    """The train CLI at the job's model (default MODEL) on the kimi copies
    ([train-tp], [train-tp-whole-mlp]): batch TP_BATCH x TRAIN_SEQ, the
    job's steps (default TP_STEPS), the loader thread-free (the runs then
    read the same batches in the same order), and with model ranks
    --num-model and gloo, no --context-parallel."""
    argv = ["--data-path", job["data"], "--data-start", "0", "--data-end", "2", "--model",
            job.get("model", MODEL), "--num-classes", str(NUM_CLASSES), "--global-batch-size", str(TP_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--stride", "16", "--num-workers", "0", "--log-every", "1",
            "--ckpt-every", str(10 ** 9), "--results-dir", results, "--device", "cuda",
            "--max-steps", str(job.get("steps", TP_STEPS)), "--mlp-bwd", mlp_bwd]
    return argv + (["--num-model", str(num_model), "--dist", "gloo"] if num_model > 1 else [])


def tp_rank_main(workdir) -> int:
    """One process of [train-tp] or [train-tp-whole-mlp]: in torchrun's
    environment one of the gloo ranks sharing the card, else the
    one-process run. Joins the process group itself (the trainer then keeps
    it), runs the train CLI with each of the job's MLP backwards (default:
    the plain and the fused), and writes each run's launches, losses (rank
    0), s per step, peak allocated device memory and the parameters this
    rank holds to <workdir>/rank<RANK>_w<WORLD_SIZE>.json."""
    import datetime

    import torch
    import torch.distributed as dist

    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    world, rank = int(os.environ.get("WORLD_SIZE", 1)), int(os.environ.get("RANK", 0))
    if world > 1:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
        dist.init_process_group("gloo", timeout=datetime.timedelta(minutes=5))
    out = {}
    for mlp_bwd in job.get("bwds", ("xla", "fused")):
        torch.cuda.empty_cache()
        summary, r = timed_train_cli(
            tp_argv(job, os.path.join(workdir, f"results_{mlp_bwd}_w{world}"), world, mlp_bwd))
        r["params"] = sum(p.numel() for p in summary["ema"].parameters())
        log = r.pop("log")
        if rank == 0:
            r.update(losses=logged_losses(log), done="Done!" in log, mesh_line="tensor parallel" in log)
        out[mlp_bwd] = r
        del summary
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}_w{world}.json"), "w") as f:
        json.dump(out, f)
    return 0


def phase_train_tp(dev, tmp, card):
    """[train-tp]: the train CLI at DiT-B with --num-model TP_RANKS --dist
    gloo (tensor parallelism) on ranks sharing the card, with the default
    and the fused MLP backward, beside one process of the same seed and
    flags: every logged loss finite and within CP_LOSS_REL_TOL of the one
    process's; per optimizer step on every rank 24 launches of rows 2 and
    8 and 12 of rows 3 and 4 (with fused 12 of rows 9a and 9b), as in the
    one process; s per step, the parameters each rank holds and its peak
    allocated device memory. Returns rank 0's launches of the fused run."""
    import torch
    from osu_diffusion_tpu_torch.models.dit import DiT_models

    wall = time.perf_counter()
    workdir = os.path.join(tmp, "tp")
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "job.json"), "w") as f:
        json.dump({"data": train_dataset(tmp)}, f)
    ranks = run_cp_ranks(workdir, TP_RANKS, "train-tp", "--tp-rank")
    tp_wall = time.perf_counter() - wall
    single = run_cp_ranks(workdir, 1, "train-tp", "--tp-rank")[0]
    with torch.device("meta"):  # the depth only
        depth = len(DiT_models[MODEL](num_classes=2).blocks)
    steps = TP_STEPS
    for mlp_bwd in ("xla", "fused"):
        tag = "train-tp" if mlp_bwd == "xla" else "train-tp-fused"
        expected = {**dict.fromkeys(ranks[0][mlp_bwd]["launches"], 0),
                    "banded_attention_fwd_lse": steps * depth * 2,  # forward + remat recompute
                    "banded_attention_bwd_dq": steps * depth, "banded_attention_bwd_dkv": steps * depth,
                    "adaln_mlp_train": steps * depth * 2}
        if mlp_bwd == "fused":
            expected.update(adaln_mlp_bwd_prologue=steps * depth, adaln_mlp_bwd_epilogue=steps * depth)
        for rank, r in enumerate([*ranks, single]):
            r = r[mlp_bwd]
            who = f"rank {rank} of {TP_RANKS}" if rank < TP_RANKS else "one process"
            print(f"[{tag}] {who}: {r['final_step']} steps, launches {r['launches']}, {r['params']:,} "
                  f"parameters held, peak device memory allocated {r['peak_gb']:.2f} GB")
            check(r["final_step"] == steps and r["launches"] == expected,
                  f"{tag} {who}: {r['final_step']} steps, launches {r['launches']} (expected {expected})")
        tp_losses, one_losses = ranks[0][mlp_bwd]["losses"], single[mlp_bwd]["losses"]
        diffs = [abs(a - b) / abs(b) for a, b in zip(tp_losses, one_losses)]
        print(f"[{tag}] losses TP {tp_losses}; one process {one_losses}; relative differences "
              + ", ".join(f"{d:.2e}" for d in diffs) + f" (tol {CP_LOSS_REL_TOL})")
        check(len(tp_losses) == len(one_losses) == steps
              and all(math.isfinite(v) for v in tp_losses + one_losses), f"{tag} losses {tp_losses} {one_losses}")
        check(max(diffs) <= CP_LOSS_REL_TOL, f"{tag} losses differ: {diffs}")
        check(ranks[0][mlp_bwd]["done"] and ranks[0][mlp_bwd]["mesh_line"],
              f"{tag}: no Done! or no tensor-parallel mesh line in rank 0's log")
        check(all(r[mlp_bwd]["params"] < single[mlp_bwd]["params"] for r in ranks),
              f"{tag}: a rank holds the whole model")
        print(f"[{tag}] {card}: {MODEL} (batch {TP_BATCH} x {TRAIN_SEQ}, bf16 stream, remat, --mlp-bwd {mlp_bwd}): "
              f"{ranks[0][mlp_bwd]['period_ms'] / 1000:.6f} s per optimizer step start to start with {TP_RANKS} "
              f"gloo ranks sharing the card (rank 1 {ranks[1][mlp_bwd]['period_ms'] / 1000:.6f}), "
              f"{single[mlp_bwd]['period_ms'] / 1000:.6f} s in one process; parameters held a rank "
              + ", ".join(f"{r[mlp_bwd]['params']:,}" for r in ranks) + f" against {single[mlp_bwd]['params']:,} "
              "(params, grads, two AdamW moments and EMA at 20 B each: "
              + ", ".join(f"{r[mlp_bwd]['params'] * 20 / 1e9:.2f}" for r in ranks)
              + f" against {single[mlp_bwd]['params'] * 20 / 1e9:.2f} GB); peak device memory allocated "
              + ", ".join(f"{r[mlp_bwd]['peak_gb']:.2f}" for r in ranks) + f" GB a rank against "
              f"{single[mlp_bwd]['peak_gb']:.2f} GB in one process; wall {ranks[0][mlp_bwd]['wall_s']:.1f} s and "
              f"{single[mlp_bwd]['wall_s']:.1f} s for {steps} steps")
    print(f"[train-tp] the TP ranks' run took {tp_wall:.1f} s, the phase {time.perf_counter() - wall:.1f} s")
    return ranks[0]["fused"]["launches"]


def train_tp_cp(ranks, single, depth, card) -> None:
    """[train-tp-cp]: the CP train CLI at DiT-B over sharded weights (the
    trainer's default with model ranks: [train-cp]'s run, and one with
    --mlp-bwd fused) against the one process and against the same runs
    with the weights whole on every rank (the replicated CP step): losses
    within CP_LOSS_REL_TOL of both, the one-process launches of the CP
    path on every rank, fewer parameters and less peak memory a rank than
    the replicated runs."""
    for mlp_bwd in ("xla", "fused"):
        tag = "train-tp-cp" if mlp_bwd == "xla" else "train-tp-cp-fused"
        sharded = [r if mlp_bwd == "xla" else r["fused"] for r in ranks]
        replicated = [r[f"replicated_{mlp_bwd}"] for r in ranks]
        one = single if mlp_bwd == "xla" else single["fused"]
        expected = {**dict.fromkeys(replicated[0]["train_launches"], 0),
                    "banded_attention_ranged_fwd_lse": CP_STEPS * depth * 2,  # forward + remat recompute
                    "banded_attention_ranged_bwd_dq": CP_STEPS * depth,
                    "banded_attention_ranged_bwd_dkv": CP_STEPS * depth, "adaln_mlp_train": CP_STEPS * depth * 2}
        if mlp_bwd == "fused":
            expected.update(adaln_mlp_bwd_prologue=CP_STEPS * depth, adaln_mlp_bwd_epilogue=CP_STEPS * depth)
        for rank in range(CP_RANKS):
            for kind, r in (("sharded", sharded[rank]), ("replicated", replicated[rank])):
                launches = r["train_launches"]
                print(f"[{tag}] rank {rank} of {CP_RANKS}, weights {kind}: {r['final_step']} steps, launches "
                      f"{launches}, {r['params']:,} parameters held, peak device memory allocated "
                      f"{r['peak_gb']:.2f} GB (allocated at the start {r.get('base_gb', 0.0):.2f} GB), "
                      f"{r['period_ms'] / 1000:.6f} s per optimizer step start to start")
                check(r["final_step"] == CP_STEPS and launches == expected,
                      f"{tag} rank {rank} {kind}: {r['final_step']} steps, launches {launches} (expected {expected})")
            check(sharded[rank]["params"] < replicated[rank]["params"]
                  and sharded[rank]["peak_gb"] < replicated[rank]["peak_gb"],
                  f"{tag} rank {rank}: sharded {sharded[rank]['params']} parameters, {sharded[rank]['peak_gb']} GB "
                  f"against replicated {replicated[rank]['params']}, {replicated[rank]['peak_gb']} GB")
        losses = {"sharded": sharded[0]["losses"], "replicated": replicated[0]["losses"], "one process": one["losses"]}
        diffs = {k: [abs(a - b) / abs(b) for a, b in zip(losses["sharded"], losses[k])]
                 for k in ("replicated", "one process")}
        print(f"[{tag}] losses " + "; ".join(f"{k} {v}" for k, v in losses.items()) + "; sharded against "
              + "; ".join(f"{k}: " + ", ".join(f"{d:.2e}" for d in v) for k, v in diffs.items())
              + f" (tol {CP_LOSS_REL_TOL})")
        check(all(len(v) == CP_STEPS and all(math.isfinite(x) for x in v) for v in losses.values()),
              f"{tag} losses {losses}")
        check(all(max(v) <= CP_LOSS_REL_TOL for v in diffs.values()), f"{tag} losses differ: {diffs}")
        check(sharded[0]["done"], f"{tag}: no Done! in rank 0's log")
        print(f"[{tag}] {card}: {MODEL} (batch {CP_BATCH} x {CP_SEQ}, band {BAND}, bf16 stream, remat, --mlp-bwd "
              f"{mlp_bwd}) on {CP_RANKS} gloo ranks sharing the card: sharded {sharded[0]['period_ms'] / 1000:.6f} "
              f"s per optimizer step (rank 1 {sharded[1]['period_ms'] / 1000:.6f}), replicated "
              f"{replicated[0]['period_ms'] / 1000:.6f} (rank 1 {replicated[1]['period_ms'] / 1000:.6f}), one process "
              f"{one['period_ms'] / 1000:.6f}; parameters held a rank " + ", ".join(f"{r['params']:,}" for r in sharded)
              + f" against {replicated[0]['params']:,} replicated (params, grads, two AdamW moments and EMA at 20 B "
              f"each: {sharded[0]['params'] * 20 / 1e9:.2f} against {replicated[0]['params'] * 20 / 1e9:.2f} GB); peak "
              "device memory allocated " + ", ".join(f"{r['peak_gb']:.2f}" for r in sharded) + " GB a rank against "
              + ", ".join(f"{r['peak_gb']:.2f}" for r in replicated) + f" replicated and {one['peak_gb']:.2f} in one "
              "process")


def phase_train_tp_whole_mlp(dev, tmp, card):
    """[train-tp-whole-mlp]: the train CLI at TP_WHOLE_MLP_MODEL with
    --num-model TP_WHOLE_MLP_RANKS --dist gloo on ranks sharing the card, a
    degree that does not divide 4D (the MLP stays whole on every rank, as
    JAX's `_fit_spec` leaves it) and divides 6D (the block heads split):
    TP_WHOLE_MLP_STEPS steps, finite losses, on every rank the one-process
    launches (row 8 on the whole MLP), fewer parameters a rank than the
    model's, and each rank's peak memory."""
    import torch
    from osu_diffusion_tpu_torch.models.dit import DiT_models

    wall = time.perf_counter()
    workdir = os.path.join(tmp, "tp-whole-mlp")
    os.makedirs(workdir, exist_ok=True)
    steps = TP_WHOLE_MLP_STEPS
    with open(os.path.join(workdir, "job.json"), "w") as f:
        json.dump({"data": train_dataset(tmp), "model": TP_WHOLE_MLP_MODEL, "steps": steps, "bwds": ["xla"]}, f)
    ranks = run_cp_ranks(workdir, TP_WHOLE_MLP_RANKS, "train-tp-whole-mlp", "--tp-rank")
    with torch.device("meta"):
        whole = DiT_models[TP_WHOLE_MLP_MODEL](num_classes=NUM_CLASSES, class_dropout_prob=0.2)
        depth, params = len(whole.blocks), sum(p.numel() for p in whole.parameters())
        hidden = whole.blocks[0].mlp.fc1.out_features
    expected = {**dict.fromkeys(ranks[0]["xla"]["launches"], 0),
                "banded_attention_fwd_lse": steps * depth * 2,  # forward + remat recompute
                "banded_attention_bwd_dq": steps * depth, "banded_attention_bwd_dkv": steps * depth,
                "adaln_mlp_train": steps * depth * 2}
    for rank, r in enumerate(ranks):
        r = r["xla"]
        print(f"[train-tp-whole-mlp] rank {rank} of {TP_WHOLE_MLP_RANKS}: {r['final_step']} steps, launches "
              f"{r['launches']}, {r['params']:,} parameters held of {params:,}, peak device memory allocated "
              f"{r['peak_gb']:.2f} GB")
        check(r["final_step"] == steps and r["launches"] == expected,
              f"train-tp-whole-mlp rank {rank}: {r['final_step']} steps, launches {r['launches']} (expected {expected})")
        check(r["params"] < params, f"train-tp-whole-mlp rank {rank} holds the whole model")
    losses = ranks[0]["xla"]["losses"]
    print(f"[train-tp-whole-mlp] {card}: {TP_WHOLE_MLP_MODEL} (MLP {hidden} wide, {hidden % TP_WHOLE_MLP_RANKS} "
          f"left over by {TP_WHOLE_MLP_RANKS} ranks: whole on each) over {TP_WHOLE_MLP_RANKS} gloo ranks sharing the "
          f"card, batch {TP_BATCH} x {TRAIN_SEQ}: losses {losses}; the phase took {time.perf_counter() - wall:.1f} s")
    check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"train-tp-whole-mlp losses {losses}")
    check(ranks[0]["xla"]["done"] and ranks[0]["xla"]["mesh_line"],
          "train-tp-whole-mlp: no Done! or no tensor-parallel mesh line in rank 0's log")


def phase_context_parallel(dev, tmp, ckpt, sampler, call_args, card):
    """[forward-cp], [slice-int8-cp], [step-cp], [train-cp] and
    [train-tp-cp]: CP_RANKS gloo ranks on the card against one device.
    Returns the ranged kernels' launches on the CP main paths (rank 0's)."""
    import torch
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.models.dit import DiT_models
    from osu_diffusion_tpu_torch.models.quantize import restore_quantized
    from osu_diffusion_tpu_torch.sampling import Sampler, _bucketed, _pad_time

    workdir = os.path.join(tmp, "cp")
    os.makedirs(workdir, exist_ok=True)
    z, o, c, y = (a.cpu() for a in call_args)
    torch.save((z, o, c, y), os.path.join(workdir, "inputs.pt"))
    with open(os.path.join(workdir, "job.json"), "w") as f:
        json.dump({"ckpt": ckpt, "inputs": os.path.join(workdir, "inputs.pt"), "data": train_dataset(tmp),
                   "check_port": free_port(), "train_only": False, "model": MODEL, "batch": CP_BATCH,
                   "steps": CP_STEPS, "flags": [], "tp_cp": True}, f)
    wall = time.perf_counter()
    ranks = run_cp_ranks(workdir, CP_RANKS)
    cp_wall = time.perf_counter() - wall
    single = run_cp_ranks(workdir, 1)[0]
    depth = len(DiT_models[MODEL](num_classes=2).blocks)

    # [forward-cp]: the one-device forward and chain on the card, same weights and inputs
    got = torch.load(os.path.join(workdir, "forward.pt"))
    model, t_real = sampler.model, z.shape[1]
    t_pad = _bucketed(t_real, 128)
    with torch.no_grad():
        x, op, cpad = (_pad_time(a.to(dev), t_pad) for a in (z, o, c))
        want = model.forward_with_cfg(x, torch.full((z.shape[0],), 500, device=dev), op, cpad, y.to(dev),
                                      CFG_SCALE, band=BAND, valid_len=t_real)[:, :t_real].cpu()
    def one_device_chain(cuda_graph=True):
        sampler = Sampler(model, create_diffusion(str(CP_SAMPLE_STEPS), noise_schedule="squaredcos_cap_v2",
                                                  device=dev), cfg_scale=CFG_SCALE, band=BAND,
                          cuda_graph=cuda_graph)
        return sampler(*(a.to(dev) for a in (z, o, c, y)),
                       generator=torch.Generator(device=dev).manual_seed(SEED)).cpu()

    one = one_device_chain()
    # the noise floor of such a gap: the same one-device chain (same weights,
    # same noise) with the plain bf16 versions of rows 1 and 7 in place of
    # their kernels for this run only (eager: a graph replays what it
    # captured); two correct chains that differ only in the kernels'
    # rounding order
    with plain_kernels():
        plain = one_device_chain(cuda_graph=False)
    rel = rel_err(got["forward"], want)
    chain_diff = (got["chain"] - one).abs()
    floor = (plain - one).abs()
    print(f"[forward-cp] DiT-B forward_with_cfg at the kimi inputs (T 757 -> 768 over {CP_RANKS} ranks, band "
          f"{BAND}), CP vs one device on the card: {rel:.3e} of max (tol {CP_REL_TOL}); a {CP_SAMPLE_STEPS}-step "
          f"CP chain: shape {tuple(got['chain'].shape)}, |CP - one device| max {chain_diff.max().item():.3e}, "
          f"median {chain_diff.median().item():.3e}; noise floor, |one device with the plain bf16 rows 1 and "
          f"7 - with the kernels| max {floor.max().item():.3e}, median {floor.median().item():.3e}: CP gap / "
          f"floor max {chain_diff.max().item() / max(floor.max().item(), 1e-30):.3f}, median "
          f"{chain_diff.median().item() / max(floor.median().item(), 1e-30):.3f} (tol "
          f"{CP_CHAIN_FLOOR_MULTIPLE})")
    check(rel <= CP_REL_TOL and bool(torch.isfinite(got["forward"]).all()), f"forward-cp: {rel}")
    for stat in ("max", "median"):
        gap, noise = getattr(chain_diff, stat)().item(), getattr(floor, stat)().item()
        check(gap <= CP_CHAIN_FLOOR_MULTIPLE * noise,
              f"forward-cp chain: |CP - one device| {stat} {gap} above {CP_CHAIN_FLOOR_MULTIPLE} x the "
              f"noise floor's {noise}")
    check(tuple(got["chain"].shape) == (2, t_real, 2) and bool(torch.isfinite(got["chain"]).all()),
          "forward-cp chain: shape or non-finite")
    chain_expected = {**dict.fromkeys(ranks[0]["chain_launches"], 0),
                      "banded_attention_ranged": CP_SAMPLE_STEPS * depth, "adaln_mlp": CP_SAMPLE_STEPS * depth}
    for rank, r in enumerate(ranks):
        print(f"[forward-cp] rank {rank} chain launches {r['chain_launches']}")
        check(r["chain_launches"] == chain_expected, f"forward-cp rank {rank} launches {r['chain_launches']}")

    # [slice-int8-cp]: the one-process int8 chain on the card, same checkpoint, inputs and noise
    qmodel = restore_quantized(ckpt, DiT_models[MODEL], num_classes=NUM_CLASSES).to(dev).eval()
    qsampler = Sampler(qmodel, create_diffusion(str(CP_SAMPLE_STEPS), noise_schedule="squaredcos_cap_v2",
                                                device=dev), cfg_scale=CFG_SCALE, band=BAND)
    one_args = tuple(a.to(dev) for a in (z, o, c, y))
    q_one = qsampler(*one_args, generator=torch.Generator(device=dev).manual_seed(SEED)).cpu()
    q_one_s = chain_seconds(qsampler, one_args)
    # the noise floor: the same one-process int8 chain with the plain bf16
    # versions of rows 1 and 10-13 in place of their kernels (eager)
    qeager = Sampler(qmodel, qsampler.diffusion, cfg_scale=CFG_SCALE, band=BAND, cuda_graph=False)
    with plain_kernels():
        q_plain = qeager(*one_args, generator=torch.Generator(device=dev).manual_seed(SEED)).cpu()
    del qmodel, qsampler, qeager
    q_gap, q_floor = (got["int8_chain"] - q_one).abs(), (q_plain - q_one).abs()
    print(f"[slice-int8-cp] {card}: the int8 {MODEL} (quantized at load) {CP_SAMPLE_STEPS}-step chain at the kimi "
          f"inputs (T 757 -> 768 over {CP_RANKS} gloo ranks sharing the card, band {BAND}): shape "
          f"{tuple(got['int8_chain'].shape)}, |CP - one process| max {q_gap.max().item():.3e}, median "
          f"{q_gap.median().item():.3e}; noise floor, |one process with the plain bf16 rows 1 and 10-13 - with the "
          f"kernels| max {q_floor.max().item():.3e}, median {q_floor.median().item():.3e}: gap / floor max "
          f"{q_gap.max().item() / max(q_floor.max().item(), 1e-30):.3f}, median "
          f"{q_gap.median().item() / max(q_floor.median().item(), 1e-30):.3f} (tol {CP_CHAIN_FLOOR_MULTIPLE}); "
          f"s per denoise step {ranks[0]['int8_chain_s']:.6f} (rank 1 {ranks[1]['int8_chain_s']:.6f}) against "
          f"{q_one_s:.6f} in one process")
    check(tuple(got["int8_chain"].shape) == (2, t_real, 2) and bool(torch.isfinite(got["int8_chain"]).all()),
          "slice-int8-cp chain: shape or non-finite")
    for stat in ("max", "median"):
        gap, noise = getattr(q_gap, stat)().item(), getattr(q_floor, stat)().item()
        check(gap <= CP_CHAIN_FLOOR_MULTIPLE * noise,
              f"slice-int8-cp chain: |CP - one process| {stat} {gap} above {CP_CHAIN_FLOOR_MULTIPLE} x the "
              f"noise floor's {noise}")
    int8_expected = {**dict.fromkeys(ranks[0]["int8_chain_launches"], 0),
                     **dict.fromkeys(("banded_attention_ranged", "int8_matmul", "int8_modulated_matmul",
                                      "int8_out_residual", "adaln_mlp_quant"), CP_SAMPLE_STEPS * depth)}
    for rank, r in enumerate(ranks):
        shown = {k: r["int8_chain_launches"][k] for k in ("banded_attention_ranged", "adaln_mlp_quant",
                                                           "int8_modulated_matmul", "int8_out_residual",
                                                           "int8_matmul")}
        print(f"[slice-int8-cp] rank {rank} of {CP_RANKS}: launches of rows 5, 10, 11, 12, 13 {shown}; every "
              f"other kernel 0: {r['int8_chain_launches'] == int8_expected}; f32 o cast for row 12: "
              f"{r['int8_o_casts']}")
        check(r["int8_chain_launches"] == int8_expected and r["int8_o_casts"] == 0,
              f"slice-int8-cp rank {rank}: launches {r['int8_chain_launches']}, o casts {r['int8_o_casts']}")

    # [attn-cp-exchange]: each rank's errors against the one-device kernels
    for rank, r in enumerate(ranks):
        for case, errs in r["exchange"].items():
            tol = CP_EXCHANGE_TOL[case.rsplit("_", 1)[1]]
            print(f"[attn-cp-exchange] rank {rank} of {CP_RANKS}, {case} (band {BAND}): CP against one device, "
                  "error of max " + " ".join(f"{k}={e:.2e}" for k, (e, _) in errs.items()) + f" (tol {tol})")
            check(all(ok and e <= tol for e, ok in errs.values()), f"attn-cp-exchange rank {rank} {case}: {errs}")

    # [step-cp]: the one-device step on the card, same weights, batch and draws
    step = torch.load(os.path.join(workdir, "step.pt"))
    loss_one, grads_one = cp_step_grads(dev)
    loss_rel = abs(step["loss"] - loss_one) / abs(loss_one)
    errs = sorted(((rel_err(step["grads"][n], grads_one[n]), n) for n in grads_one), reverse=True)
    print(f"[step-cp] {MODEL} train step, batch 4 x {CP_SEQ} over {CP_RANKS} ranks, band {BAND}, bf16 stream, "
          f"MSE: loss CP {step['loss']:.6f} one device {loss_one:.6f} (rel {loss_rel:.2e}); gradient error of "
          f"max, worst {errs[0][0]:.2e} ({errs[0][1]}), median {errs[len(errs) // 2][0]:.2e} over {len(errs)} "
          f"tensors (tol {CP_REL_TOL})")
    check(loss_rel <= CP_REL_TOL, f"step-cp loss: {loss_rel}")
    check(errs[0][0] <= CP_REL_TOL, f"step-cp gradients: {errs[:5]}")
    del step, grads_one

    # [train-cp]
    expected_cp = {**dict.fromkeys(ranks[0]["train_launches"], 0),
                   "banded_attention_ranged_fwd_lse": CP_STEPS * depth * 2,  # forward + remat recompute
                   "banded_attention_ranged_bwd_dq": CP_STEPS * depth,
                   "banded_attention_ranged_bwd_dkv": CP_STEPS * depth,
                   "adaln_mlp_train": CP_STEPS * depth * 2}
    expected_one = {**dict.fromkeys(expected_cp, 0), "banded_attention_fwd_lse": CP_STEPS * depth * 2,
                    "banded_attention_bwd_dq": CP_STEPS * depth, "banded_attention_bwd_dkv": CP_STEPS * depth,
                    "adaln_mlp_train": CP_STEPS * depth * 2}
    for rank, r in enumerate(ranks):
        print(f"[train-cp] rank {rank} of {CP_RANKS}: {r['final_step']} steps, launches {r['train_launches']}")
        check(r["final_step"] == CP_STEPS and r["train_launches"] == expected_cp,
              f"train-cp rank {rank}: {r['final_step']} steps, launches {r['train_launches']}")
    print(f"[train-cp] one process: launches {single['train_launches']}")
    check(single["train_launches"] == expected_one, f"train-cp one process launches {single['train_launches']}")
    cp_losses, one_losses = ranks[0]["losses"], single["losses"]
    diffs = [abs(a - b) / abs(b) for a, b in zip(cp_losses, one_losses)]
    print(f"[train-cp] losses CP {cp_losses}; one process {one_losses}; relative differences "
          + ", ".join(f"{d:.2e}" for d in diffs) + f" (tol {CP_LOSS_REL_TOL})")
    check(len(cp_losses) == len(one_losses) == CP_STEPS and all(math.isfinite(v) for v in cp_losses + one_losses),
          f"train-cp losses {cp_losses} {one_losses}")
    check(max(diffs) <= CP_LOSS_REL_TOL, f"train-cp losses differ: {diffs}")
    check(ranks[0]["done"] and ranks[0]["mesh_line"], "train-cp: no Done! or no mesh line in rank 0's log")
    print(f"[train-cp] {card}: {ranks[0]['period_ms'] / 1000:.6f} s per optimizer step start to start with "
          f"{CP_RANKS} gloo ranks sharing the card (rank 1 {ranks[1]['period_ms'] / 1000:.6f}), "
          f"{single['period_ms'] / 1000:.6f} s in one process ({MODEL}, batch {CP_BATCH} x {CP_SEQ}, band {BAND}, "
          f"bf16 stream, remat); wall {ranks[0]['wall_s']:.1f} s and {single['wall_s']:.1f} s for "
          f"{CP_STEPS} steps; the CP ranks' run took {cp_wall:.1f} s in all")
    print(f"[train-cp] {card}: the step's collectives alone on gloo (rank 0, host clock): the gradient sum "
          f"({ranks[0]['grad_mb']:.1f} MB f32) {ranks[0]['grad_all_reduce_s']:.4f} s, one block's k/v halo "
          f"exchange {ranks[0]['halo_exchange_s']:.4f} s (x 3 a block a step: forward, remat, backward; "
          f"x {depth} blocks)")
    train_tp_cp(ranks, single, depth, card)
    return {"banded_attention_ranged": ranks[0]["chain_launches"]["banded_attention_ranged"],
            **{k: ranks[0]["train_launches"][k] for k in ("banded_attention_ranged_fwd_lse",
                                                          "banded_attention_ranged_bwd_dq",
                                                          "banded_attention_ranged_bwd_dkv")}}


def phase_clock():
    """mark(label): prints the wall seconds since the last mark and since
    the first, as each phase ends (what the script's time limit is spent
    on)."""
    start = last = time.perf_counter()

    def mark(label):
        nonlocal last
        now = time.perf_counter()
        print(f"[clock] {label}: {now - last:.1f} s ({now - start:.1f} s in all)", flush=True)
        last = now

    return mark


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--cp-rank"]:  # one process of phase_context_parallel
        return cp_rank_main(sys.argv[2])
    if sys.argv[1:2] == ["--tp-rank"]:  # one process of phase_train_tp
        return tp_rank_main(sys.argv[2])
    if sys.argv[1:2] == ["--longrun-child"]:  # the child of phase_longrun
        return longrun_child_main(sys.argv[2])
    from osu_diffusion_tpu_torch.models.dit import DiT_models

    # the plain f32 versions and projections in full f32, as the JAX f32 path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    mark = phase_clock()
    card = phase_build()
    mark("build")
    measured = {"banded_attention": phase_attention(dev), "adaln_mlp": phase_mlp(dev)}
    measured.update(phase_attention_cp(dev))
    measured.update(phase_attention_train(dev))
    measured["adaln_mlp_train"] = phase_mlp_train(dev)
    mlp_bwd, mlp_bwd_ms = phase_mlp_bwd(dev)
    measured.update(mlp_bwd)
    measured.update(phase_quant(dev))
    mark("the DiT-B kernel phases")
    phase_attention_xl(dev)
    phase_mlp(dev, "mlp-xl", MLP_XL_CASES)
    phase_quant(dev, "quant-xl", QUANT_XL_CASES)
    phase_attention_train(dev, "attn-train-xl", ATTN_TRAIN_XL_CASES, XL_HEAD_DIM)
    phase_mlp_train(dev, "mlp-train-xl", MLP_TRAIN_XL_CASES)
    phase_attention_cp(dev, "attn-cp-xl", ATTN_CP_XL_CASES, XL_HEAD_DIM)
    phase_mlp_bwd(dev, "mlp-bwd-xl", MLP_BWD_XL_CASES)
    phase_mlp_tp(dev)
    phase_mlp_tp(dev, MLP_TP_RAGGED_CASES, "mlp-tp-ragged")
    mark("the XL and TP kernel phases")

    with tempfile.TemporaryDirectory() as tmp:
        model = DiT_models[MODEL](num_classes=NUM_CLASSES)
        sd = random_state_dict(model, torch.Generator().manual_seed(SEED))
        ckpt = os.path.join(tmp, "dit_b_random.pt")
        torch.save({"ema": sd}, ckpt)
        del model, sd
        launches, sampler, call_args, f32_step_ms = phase_slice(dev, ckpt, os.path.join(tmp, "results"))
        forward = phase_forward_vs_plain(dev, sampler, call_args)
        mark("[slice], [forward]")
        phase_serving(dev, tmp, ckpt, sampler, call_args, forward["cpu"])
        mark("[serving]")
        phase_toy(dev, ckpt)
        mark("[toy]")
        phase_unfuck(dev, ckpt)
        mark("[unfuck]")
        phase_longrun(tmp)
        mark("[longrun]")
        launches.update(phase_context_parallel(dev, tmp, ckpt, sampler, call_args, card))
        mark("the CP phase")
        phase_train_tp(dev, tmp, card)
        mark("[train-tp]")
        phase_train_tp_whole_mlp(dev, tmp, card)
        mark("[train-tp-whole-mlp]")
        quant_launches, qsampler, _, int8_step_ms = phase_slice(
            dev, ckpt, os.path.join(tmp, "results-int8"), quantize=True)
        turns = {name: sum(v) / len(v) for name, v in chains_in_turns(
            dev, "slice-int8", {"f32": sampler, "int8": qsampler}, call_args, rounds=2).items()}
        print(f"[slice-int8] int8 against f32 in this call: {int8_step_ms / 1000:.6f} against "
              f"{f32_step_ms / 1000:.6f} s per denoise step in the CLI samplers' replayed chains "
              f"({f32_step_ms / int8_step_ms:.3f}x), {turns['int8'] / 1000:.6f} against "
              f"{turns['f32'] / 1000:.6f} in turns ({turns['f32'] / turns['int8']:.3f}x)")
        phase_forward_vs_plain(dev, qsampler, call_args, "forward-int8", f32_model=sampler.model)
        mark("[slice-int8], [forward-int8]")
        phase_graph(dev, {"f32": sampler, "int8": qsampler}, call_args, card)
        mark("[graph]")
        launches.update({k: v for k, v in quant_launches.items() if k not in launches})
        del sampler, qsampler, call_args
        phase_xl(dev, tmp, card)
        mark("[slice-xl] and the XL phases")
        corpus = phase_loader(tmp)
        mark("[loader]")
        train_launches, default = phase_train(dev, tmp)
        mark("[train]")
        launches.update({k: v for k, v in train_launches.items() if k not in launches})
        phase_train_corpus(dev, tmp, corpus)
        mark("[train-corpus]")
        fused_launches, fused = phase_train(dev, tmp, "fused")
        mark("[train-fused]")
        launches.update({k: fused_launches[k] for k in ("adaln_mlp_bwd_prologue", "adaln_mlp_bwd_epilogue")})
        print(f"[train-fused] against the default run in this call: {fused['period_ms'] / 1000:.6f} against "
              f"{default['period_ms'] / 1000:.6f} s per optimizer step start to start, "
              f"{fused['step_ms'] / 1000:.6f} against {default['step_ms'] / 1000:.6f} s inside train_step, "
              f"device {fused['device_ms']:.2f} against {default['device_ms']:.2f} ms per step, busy "
              f"{fused['busy']:.1f}% against {default['busy']:.1f}%; the MLP backward alone (fused, plain) "
              f"{mlp_bwd_ms['fused']:.4f}, {mlp_bwd_ms['plain']:.4f} ms per block")
        phase_train_modes(dev, tmp, default["ckpt"])
        mark("[train-modes]")
        for mlp_bwd in ("xla", "fused"):
            phase_train_graph(dev, tmp, card, mlp_bwd)
            mark(f"[train-graph] --mlp-bwd {mlp_bwd}")
    phase_train_step_vs_plain(dev)
    phase_train_step_vs_plain(dev, "fused")
    mark("[step], [step-fused]")
    new_phases = {"bpd": phase_bpd(dev), "train-kl": phase_train_kl(dev), "sample-fixed-var": phase_sample_fixed_var(dev)}
    print(f"[modes] the diffusion's other parameterizations: {({k: round(v, 1) for k, v in new_phases.items()})} s, "
          f"{sum(new_phases.values()):.1f} s together")
    mark("[bpd], [train-kl], [sample-fixed-var]")
    phase_bench_tools()
    mark("[bench-tools]")

    attn_src = "osu_diffusion_tpu_torch/csrc/banded_attention.cu"
    bwd_src = "osu_diffusion_tpu_torch/csrc/banded_attention_bwd.cu"
    mlp_src = "osu_diffusion_tpu_torch/csrc/adaln_mlp.cu"
    mlp_bwd_src = "osu_diffusion_tpu_torch/csrc/adaln_mlp_bwd.cu"
    int8_src = "osu_diffusion_tpu_torch/csrc/int8_matmul.cu"
    attn_ref = "osu_diffusion_tpu/ops/pallas_attention.py"
    mlp_ref = "osu_diffusion_tpu/ops/pallas_mlp.py:53"
    quant_ref = "osu_diffusion_tpu/ops/pallas_quant.py"
    where = {
        "banded_attention": (attn_src, f"{attn_ref}:72"),
        "adaln_mlp": (mlp_src, mlp_ref),
        "banded_attention_fwd_lse": (attn_src, f"{attn_ref}:72"),
        "banded_attention_bwd_dq": (bwd_src, f"{attn_ref}:379"),
        "banded_attention_bwd_dkv": (bwd_src, f"{attn_ref}:461"),
        "adaln_mlp_train": (mlp_src, mlp_ref),
        "adaln_mlp_bwd_prologue": (mlp_bwd_src, "osu_diffusion_tpu/ops/pallas_mlp.py:315"),
        "adaln_mlp_bwd_epilogue": (mlp_bwd_src, "osu_diffusion_tpu/ops/pallas_mlp.py:390"),
        "adaln_mlp_quant": (mlp_src, "osu_diffusion_tpu/ops/pallas_mlp.py:184"),
        "int8_modulated_matmul": (mlp_src, f"{quant_ref}:95"),
        "int8_out_residual": (mlp_src, f"{quant_ref}:156"),
        "int8_matmul": (int8_src, f"{quant_ref}:221"),
        "banded_attention_ranged": (attn_src, f"{attn_ref}:249"),
        "banded_attention_ranged_fwd_lse": (attn_src, f"{attn_ref}:249"),
        "banded_attention_ranged_bwd_dq": (bwd_src, f"{attn_ref}:348"),
        "banded_attention_ranged_bwd_dkv": (bwd_src, f"{attn_ref}:360"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **{k: measured[name][k] for k in keys}}
               for name, (src, rep) in where.items()]
    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} was not launched on its main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
