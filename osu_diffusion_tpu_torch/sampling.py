"""The sampler (port of osu_diffusion_tpu/sampling.py): classifier-free
guidance or the plain forward, ancestral or DDIM steps, in-painting, an f32
or bf16 model stream, Δ-cache acceleration, context parallelism, and the
refine pass and animation frames of the sample CLI.

Length bucketing: sequences are padded to a multiple of `bucket` (default
128), and the real length rides along as a runtime `valid_len`, which masks
padded keys in every attention call; padded rows are sliced off the result.

One program per chain, as the JAX Sampler keeps one compiled XLA chain per
(N, T_pad, inpaint, use_cfg): the Sampler keeps a cache keyed by (N, T_pad,
inpaint, use_cfg, the step's kind, the stream's type), each entry a chain's
static buffers (x, t, the step's noise, o, c, y, known_x/known_mask and
`valid_len`, a 0-d int32 tensor) and its denoise step as a `StepProgram`
(diffusion/process.py). A call copies its padded inputs and its length
into the entry's buffers, then runs the step S times: each step's noise is
drawn outside the step into its buffer (by `noise_fn` or the generator, so
the bits are the eager chain's), and the step writes x in place. The
result is a copy of the slice of x (x is the entry's buffer).

- On a CUDA device (and `cuda_graph`, the default) the first step of each
  kind runs eagerly on a side stream (a warm-up: the kernels are built,
  their attributes set and the weight casts cached) and is then captured
  as a `torch.cuda.CUDAGraph` (graphs.py); every later step of that kind
  is a replay. Banded attention reads `valid_len` from its buffer when it
  runs, so one graph serves every length of its bucket, and nothing in the
  chain reads the card on the host. A capture or replay error raises: no
  chain falls back to the eager loop. Each replay adds the launches its
  capture recorded to the kernel wrappers' counters (the capture itself
  counts none), so `.launches` still counts the launches that ran on the
  card. An entry's graphs are captured again when the model's weights have
  moved or changed in place since (a load, an optimizer step), since a
  graph keeps the buffers it read (the MLP's bf16 weight copies among
  them).
- On the CPU, or with `cuda_graph=False`, the same step program runs
  eagerly: the tests' path, and the card's eager side of an A/B.
- The fixed-interval Δ-cache captures two steps over the same buffers, a
  "record" (every block, Δ copied into the entry's Δ buffer) and an
  "apply" (Δ added in place of the span's blocks), and replays them by the
  schedule the host fixes before the chain: a full step every
  `accel_interval`-th step and on the last one. `refine` (t = 0 steps)
  and `progressive` (every step's sample) use the same cache.
- The adaptive Δ-cache (`accel_tau`) skips while the model input's
  relative drift since the last full step, ||x - x_ref|| / ||x_ref|| (over
  the batch, or the largest of its rows' under
  `accel_drift="per_sample_max"`), stays at or below tau, at most
  `accel_max_skip` steps in a row, never on the first or the last step.
  As JAX decides inside its scan, the card decides (`adaptive_skip`, in
  f32): each step is one "adaptive" graph of a "decide" part, which writes
  two 0-d bool predicates, and the "record" and "apply" steps as bodies of
  conditional IF nodes on them (CUDA 12.4 or later; a card or build
  without them raises). The host reads the count of full steps once, at
  the chain's end. Eagerly the host reads the predicate once a step.

What stays eager, and why: context parallelism (`cp`, a
parallel/mesh.py `Mesh`). Its halo exchanges are gloo collectives, host
calls. The bucket is raised to a multiple of num_model * 128, each rank of
the CP group keeps its rows of z, o and c and runs the chain on them, the
per-step noise is drawn at the whole padded shape on every rank from the
same generator and sliced, so the chain is the one-device chain, and the
result is gathered from the ranks at the end. Every rank of the group
calls the sampler with the same inputs and generator seed. The Δ-cache
refuses CP.

The diffusion math runs in f32 whatever the model stream: x, o and c enter
the model in f32 (the first layer's sincos needs them), only the residual
stream runs in `compute_dtype`, and the model's head returns f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from osu_diffusion_tpu_torch.diffusion.process import (
    GaussianDiffusion,
    NoiseFn,
    StepProgram,
    draw_noise,
)
from osu_diffusion_tpu_torch.graphs import GraphedStep, launch_counters, warm_up  # noqa: F401
from osu_diffusion_tpu_torch.models.dit import DiT
from osu_diffusion_tpu_torch.parallel.context import BLOCK, gather_slots, shard_rows

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
ACCEL_DRIFTS = ("global", "per_sample_max")


def _bucketed(t: int, bucket: int) -> int:
    return max(bucket, -(-t // bucket) * bucket)


def _pad_time(a: torch.Tensor, t_pad: int) -> torch.Tensor:
    """Zero-pad axis 1 of (N, T, ...) to t_pad."""
    extra = t_pad - a.shape[1]
    if extra == 0:
        return a
    return F.pad(a, [0, 0] * (a.ndim - 2) + [0, extra])


def _shard_noise(noise_fn: NoiseFn | None, generator, like: torch.Tensor, t_pad: int,
                 rows: slice) -> NoiseFn:
    """Each step's noise drawn at the whole padded shape (by `noise_fn`, else
    from `generator` on like's device) and sliced to this rank's rows, so
    every rank's chain is its rows of the one-device chain."""
    def draw(k: int, shape) -> torch.Tensor:
        whole = (shape[0], t_pad, *shape[2:])
        if noise_fn is not None:
            return noise_fn(k, whole)[:, rows]
        return torch.randn(whole, generator=generator, device=like.device, dtype=like.dtype)[:, rows]

    return draw


def drift(x: torch.Tensor, x_ref: torch.Tensor, per_sample_max: bool) -> torch.Tensor:
    """Relative drift of x from x_ref, a 0-d tensor: over the whole batch,
    or the largest of the rows' (each norm divided by max(||x_ref||, 1e-6))."""
    if per_sample_max:
        diff = (x - x_ref).reshape(x.shape[0], -1)
        ref = x_ref.reshape(x.shape[0], -1)
        return (diff.norm(dim=1) / ref.norm(dim=1).clamp(min=1e-6)).max()
    return (x - x_ref).norm() / x_ref.norm().clamp(min=1e-6)


def adaptive_skip(x: torch.Tensor, x_ref: torch.Tensor, t: torch.Tensor, skips: torch.Tensor,
                  n_full: torch.Tensor, tau, max_skip: int, per_sample_max: bool) -> torch.Tensor:
    """The adaptive Δ-cache's decision for one step, a 0-d bool tensor on
    x's device, as JAX's scan body decides it: skip where the drift of x
    from x_ref is at most tau, compared in f32 (tau a float, or a 0-d f32
    tensor on x's device, as a graph needs it), fewer than max_skip steps
    in a row have skipped, the local timesteps t are not the last (t > 0)
    and a Δ has been recorded (n_full > 0). The drift is read through the
    module's `drift`."""
    tau = torch.as_tensor(tau, dtype=torch.float32, device=x.device)
    return ((drift(x, x_ref, per_sample_max) <= tau) & (skips < max_skip) & (t > 0).all()
            & (n_full > 0))


def _weights_key(model: torch.nn.Module) -> tuple:
    """Where each parameter and buffer lies and its in-place version: a
    captured graph is stale once this changes."""
    return tuple((a.data_ptr(), a._version) for a in (*model.parameters(), *model.buffers()))


class Chain:
    """One entry of the Sampler's cache: the static buffers of a chain at
    (N, T_pad, inpaint, use_cfg) and its step programs over them: "step"
    (one kind), or "record" and "apply" (the fixed Δ-cache), each a step
    kind of its own; or, for the adaptive Δ-cache, one step kind
    "adaptive" over "record" and "apply". Each step kind runs eagerly or,
    once warmed up, is replayed as a CUDA graph (`graphs`, by kind).
    `captures` counts the captures of each kind.

    The adaptive step is JAX's scan body over the buffers x, Δ, x_ref,
    skips and n_full: "decide" writes the 0-d bool predicates `skip`
    (`adaptive_skip`) and `full` (its negation) before either body runs;
    the record body (x_ref = x, the "record" program, skips = 0, n_full +=
    1) runs where `full` holds, the apply body (the "apply" program, skips
    += 1) where `skip` holds. In the graph each body sits under an IF node
    on its predicate; eagerly the host reads `full`."""

    def __init__(self, sampler: "Sampler", kind: str, z, o, c, y, inpaint: bool, use_cfg: bool):
        model, diffusion, dev = sampler.model, sampler.diffusion, z.device
        self.model = model
        self.graphed = sampler.cuda_graph and dev.type == "cuda"
        self.x = torch.zeros_like(z)
        self.o, self.c, self.y = (torch.zeros_like(a, device=dev) for a in (o, c, y))
        self.valid = torch.zeros((), dtype=torch.int32, device=dev)
        self.known_x = self.known_mask = None
        denoised_fn = None
        if inpaint:
            # known_mask True = free to generate, False = pinned to known_x;
            # pad rows are pinned (to the padded zeros)
            self.known_x = torch.zeros_like(self.x)
            self.known_mask = torch.zeros(z.shape, dtype=torch.bool, device=dev)

            def denoised_fn(x0):
                return torch.where(self.known_mask, x0, self.known_x)

        kwargs = dict(band=sampler.band, valid_len=self.valid, dtype=sampler.compute_dtype)

        def model_fn(x, t, **delta_kwargs):
            if use_cfg:
                return model.forward_with_cfg(x, t, self.o, self.c, self.y, sampler.cfg_scale,
                                              **kwargs, **delta_kwargs)
            return model.forward(x, t, self.o, self.c, self.y, **kwargs, **delta_kwargs)

        step = diffusion.ddim_sample if kind.startswith("ddim") else diffusion.p_sample
        common = dict(clip_denoised=sampler.clip_denoised, denoised_fn=denoised_fn)
        self.adaptive = kind.endswith("adaptive")
        if kind in ("ancestral", "ddim"):
            self.programs = {"step": StepProgram(step, model_fn, self.x, **common)}
        else:
            hidden = model.final_layer.linear.in_features
            self.delta = torch.zeros((*z.shape[:2], hidden), dtype=sampler.compute_dtype, device=dev)
            span = sampler.accel_span

            def record(x, t):
                out, delta = model_fn(x, t, delta_mode="record", delta_span=span)
                self.delta.copy_(delta)
                return out

            def apply(x, t):
                return model_fn(x, t, delta_mode="apply", delta_span=span, delta=self.delta)[0]

            first = StepProgram(step, record, self.x, **common)
            self.programs = {"record": first,
                             "apply": StepProgram(step, apply, self.x, first.t, first.noise, **common)}
        if self.adaptive:
            self.x_ref = torch.zeros_like(self.x)  # JAX's xref0
            self.skips, self.n_full = (torch.zeros((), dtype=torch.int32, device=dev) for _ in range(2))
            self.full, self.skip = (torch.zeros((), dtype=torch.bool, device=dev) for _ in range(2))
            self.tau = torch.tensor(sampler.accel_tau, dtype=torch.float32, device=dev)
            self.max_skip = sampler.accel_max_skip
            self.per_sample_max = sampler.accel_drift == "per_sample_max"
        self.graphs: dict[str, GraphedStep] = {}
        self.captures = dict.fromkeys(["adaptive"] if self.adaptive else self.programs, 0)
        self.weights = None

    def load(self, z, o, c, y, t_real: int, known_x=None, known_mask=None) -> None:
        """Copy one call's padded inputs and real length into the buffers
        (and reset the adaptive chain's state); drop the graphs if the
        model's weights changed since they were captured."""
        weights = _weights_key(self.model)
        if weights != self.weights:
            self.graphs.clear()
            self.weights = weights
        for buf, a in ((self.x, z), (self.o, o), (self.c, c), (self.y, y)):
            buf.copy_(a)
        if self.known_x is not None:
            self.known_x.copy_(known_x)
            self.known_mask.copy_(known_mask)
        self.valid.fill_(t_real)
        if self.adaptive:
            for buf in (self.x_ref, self.skips, self.n_full):
                buf.zero_()

    # -- the adaptive step's parts (class docstring) -------------------------

    def _decide(self) -> None:
        skip = adaptive_skip(self.x, self.x_ref, self.programs["record"].t, self.skips, self.n_full,
                             self.tau, self.max_skip, self.per_sample_max)
        self.skip.copy_(skip)
        torch.logical_not(skip, out=self.full)

    def _record(self) -> None:
        self.x_ref.copy_(self.x)
        self.programs["record"]()
        self.skips.zero_()
        self.n_full.add_(1)

    def _apply(self) -> None:
        self.programs["apply"]()
        self.skips.add_(1)

    def step(self, kind: str, k: int, i: int, generator, noise_fn) -> None:
        """Step k of the chain (local timestep i) of step kind `kind`: its
        noise drawn into the buffer, then the step run or replayed."""
        program = self.programs["record" if kind == "adaptive" else kind]
        program.set(i, draw_noise(k, self.x, generator, noise_fn))
        if not self.graphed:
            if kind != "adaptive":
                program()
                return
            self._decide()
            (self._record if self.full.item() else self._apply)()
        elif kind in self.graphs:
            self.graphs[kind].replay()
        else:
            self._capture(kind)

    def _capture(self, kind: str) -> None:
        """The first step of `kind` on the card: a warm-up on a side stream,
        then the capture. A plain kind's warm-up is the step itself. The
        adaptive step's runs "decide" and both bodies, putting the chain's
        state back after each (the first step always records, so the apply
        body has not run; a capture cannot build a kernel, set an attribute
        or fill a weight cast lazily), and its graph then replays for the
        step."""
        device = self.x.device
        if kind != "adaptive":
            warm_up(self.programs[kind], device)
            self.graphs[kind] = GraphedStep(device, self.programs[kind])
        else:
            state = (self.x, self.delta, self.x_ref, self.skips, self.n_full)

            def warm():
                saved = [a.clone() for a in state]
                self._decide()
                for body in (self._record, self._apply):
                    body()
                    for a, s in zip(state, saved):
                        a.copy_(s)

            warm_up(warm, device)
            self.graphs[kind] = GraphedStep(device, self._decide,
                                            [(self.full, self._record), (self.skip, self._apply)])
            self.graphs[kind].replay()
        self.captures[kind] += 1

    def full_steps(self, steps: int) -> int:
        """The adaptive chain's full steps, n_full read once at its end (the
        chain's one read of the card). A graphed chain replayed the
        adaptive graph every step: its bodies' launches are added to the
        counters here, n_full record bodies and steps - n_full apply ones."""
        n_full = int(self.n_full)
        if "adaptive" in self.graphs:
            self.graphs["adaptive"].count_bodies((n_full, steps - n_full))
        return n_full


class Sampler:
    """With CFG (the default) the inputs are the doubled batch [cond |
    uncond] along axis 0 and the eps-only guidance happens inside
    DiT.forward_with_cfg; `use_cfg=False` runs the plain forward (the toy
    evals' null-class protocol), any batch size."""

    def __init__(self, model: DiT, diffusion: GaussianDiffusion, cfg_scale: float = 1.0,
                 band: int | None = None, bucket: int = 128, cp=None, clip_denoised: bool = True,
                 method: str = "ancestral", compute_dtype: torch.dtype = torch.float32,
                 accel_interval: int = 1, accel_span: tuple[int, int] | None = None,
                 accel_tau: float | None = None, accel_max_skip: int = 7,
                 accel_drift: str = "global", cuda_graph: bool = True):
        """`cp`: the mesh of context parallelism (needs a band); the bucket
        is rounded up to a multiple of num_model * 128, so every padded
        length splits evenly over the shards. `method`: "ancestral" or
        "ddim" (eta 0). `compute_dtype`: the model stream, float32 or
        bfloat16 (not with int8 blocks). `accel_*`: the Δ-cache (module
        docstring); `accel_span` defaults to (depth // 6, depth - depth //
        6), and interval 1 with no tau is the exact chain. After an
        accelerated call `last_full_model_steps` holds the number of steps
        that ran every block. `cuda_graph`: on a CUDA device, replay each
        chain's captured steps (the default); False runs the same step
        programs eagerly (the card's A/B)."""
        if method not in ("ancestral", "ddim"):
            raise ValueError(f"unknown sampling method: {method}")
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
        if model.quant and compute_dtype != torch.float32:
            raise ValueError("int8 blocks take the f32 stream only: the bf16 stream under "
                             "--quantize-weights is still to port (ROADMAP.md Queue 1, "
                             "'int8 under the bf16 stream')")
        if accel_drift not in ACCEL_DRIFTS:
            raise ValueError(f"unknown accel_drift: {accel_drift}")
        self.model = model
        self.diffusion = diffusion
        self.cfg_scale = float(cfg_scale)
        self.band = band
        self.cp = cp
        if cp is not None:
            if band is None:
                raise ValueError("context parallelism needs a band")
            step = cp.num_model * BLOCK
            bucket = -(-max(bucket, 1) // step) * step
        self.bucket = bucket
        self.clip_denoised = clip_denoised
        self.method = method
        self.compute_dtype = compute_dtype
        self.accel_interval = int(accel_interval)
        self.accel_tau = None if accel_tau is None else float(accel_tau)
        self.accel_max_skip = int(accel_max_skip)
        self.accel_drift = accel_drift
        self.accel = self.accel_interval > 1 or self.accel_tau is not None
        self.last_full_model_steps = None
        self.cuda_graph = bool(cuda_graph)
        self._cache: dict[tuple, Chain] = {}
        if self.accel:
            if cp is not None:
                raise ValueError("Δ-cache sampling is not supported with context parallelism "
                                 "(the Δ carry is per-device state)")
            depth = len(model.blocks)
            if accel_span is None:
                accel_span = (depth // 6, depth - depth // 6)
            lo, hi = accel_span
            if not 0 <= lo < hi <= depth:
                raise ValueError(f"accel_span {accel_span} outside depth {depth}")
        self.accel_span = accel_span

    # -- the step-program chains (module docstring) --------------------------

    def _chain(self, kind: str, z, o, c, y, known_x, known_mask, use_cfg: bool) -> tuple[Chain, int]:
        """The cache entry of `kind` ("ancestral", "ddim", with "-delta"
        the fixed Δ-cache's pair, with "-adaptive" the adaptive Δ-cache's
        step) at the call's key, its buffers loaded with the call's padded
        inputs; and the real length."""
        t_real = z.shape[1]
        t_pad = _bucketed(t_real, self.bucket)
        if not 1 <= t_real <= t_pad:
            raise ValueError(f"sequence length {t_real} outside [1, {t_pad}]")
        inpaint = known_x is not None
        zp, op, cpad = (_pad_time(a, t_pad) for a in (z, o, c))
        key = (z.shape[0], t_pad, inpaint, use_cfg, kind, self.compute_dtype)
        chain = self._cache.get(key)
        if chain is None:
            chain = self._cache[key] = Chain(self, kind, zp, op, cpad, y, inpaint, use_cfg)
        known = (_pad_time(known_x, t_pad), _pad_time(known_mask.to(torch.bool), t_pad)) if inpaint else ()
        chain.load(zp, op, cpad, y, t_real, *known)
        return chain, t_real

    def _steps(self):
        """(k, i) of each step: step index k, local timestep i = S-1-k."""
        return enumerate(range(self.diffusion.num_timesteps - 1, -1, -1))

    # -- the eager chain: context parallelism ---------------------------------

    def _setup(self, z, o, c, y, known_x, known_mask, use_cfg, generator, noise_fn):
        """Pad to the bucket (and shard under CP): (x_T, model_fn(x, t,
        **delta_kwargs), denoised_fn, noise_fn, finish(out) -> (N, T, 2))."""
        t_real = z.shape[1]
        t_pad = _bucketed(t_real, self.bucket)
        zp, op, cpad = (_pad_time(a, t_pad) for a in (z, o, c))
        denoised_fn = None
        if known_x is not None:
            # known_mask True = free to generate, False = pinned to known_x;
            # pad rows are pinned (to the padded zeros)
            kx, km = _pad_time(known_x, t_pad), _pad_time(known_mask.to(torch.bool), t_pad)
        if self.cp is not None:
            rows = shard_rows(t_pad, self.cp)
            zp, op, cpad = zp[:, rows], op[:, rows], cpad[:, rows]
            if known_x is not None:
                kx, km = kx[:, rows], km[:, rows]
            noise_fn = _shard_noise(noise_fn, generator, z, t_pad, rows)
        if known_x is not None:
            def denoised_fn(x0):
                return torch.where(km, x0, kx)

        kwargs = dict(band=self.band, valid_len=t_real, cp=self.cp, dtype=self.compute_dtype)

        def model_fn(x, t, **delta_kwargs):
            if use_cfg:
                return self.model.forward_with_cfg(x, t, op, cpad, y, self.cfg_scale, **kwargs,
                                                   **delta_kwargs)
            return self.model.forward(x, t, op, cpad, y, **kwargs, **delta_kwargs)

        def finish(out):
            if self.cp is not None:
                out = torch.cat(gather_slots(out, self.cp).unbind(), dim=-2)
            return out[..., :t_real, :]

        return zp, model_fn, denoised_fn, noise_fn, finish

    @torch.no_grad()
    def __call__(self, z, o, c, y, generator: torch.Generator | None = None,
                 noise_fn: NoiseFn | None = None, known_x: torch.Tensor | None = None,
                 known_mask: torch.Tensor | None = None, use_cfg: bool = True) -> torch.Tensor:
        """z: (N, T, 2) initial noise; o: (N, T); c: (N, T, 144); y: (N,).
        With CFG, N is even ([cond | uncond]). Per-step noise comes from
        `generator` on z's device, or from `noise_fn(step_index,
        padded_shape)`. In-painting: `known_x` (N, T, 2) and `known_mask`
        (N, T, 2), True where the sampler generates and False where each x0
        prediction is replaced by known_x. Returns (N, T, 2)."""
        if self.cp is not None:  # the eager chain (module docstring)
            zp, model_fn, denoised_fn, noise_fn, finish = self._setup(
                z, o, c, y, known_x, known_mask, use_cfg, generator, noise_fn)
            loop = (self.diffusion.ddim_sample_loop if self.method == "ddim"
                    else self.diffusion.p_sample_loop)
            return finish(loop(model_fn, zp, generator=generator, noise_fn=noise_fn,
                               clip_denoised=self.clip_denoised, denoised_fn=denoised_fn))
        adaptive = self.accel_tau is not None
        kind = self.method + ("-adaptive" if adaptive else "-delta" if self.accel else "")
        chain, t_real = self._chain(kind, z, o, c, y, known_x, known_mask, use_cfg)
        s = self.diffusion.num_timesteps
        n_full = 0
        for k, i in self._steps():
            if adaptive:
                step = "adaptive"
            elif self.accel:
                # fixed Δ-cache: full every accel_interval-th step and on the last one
                full = k % self.accel_interval == 0 or k == s - 1
                n_full += full
                step = "record" if full else "apply"
            else:
                step = "step"
            chain.step(step, k, i, generator, noise_fn)
        if self.accel:
            self.last_full_model_steps = chain.full_steps(s) if adaptive else n_full
        return chain.x[:, :t_real].clone()

    @torch.no_grad()
    def progressive(self, z, o, c, y, generator: torch.Generator | None = None,
                    noise_fn: NoiseFn | None = None) -> torch.Tensor:
        """Every step's sample of the CFG ancestral chain, (S, N, T, 2): the
        frames of the denoising animation (as the JAX CLI, ancestral steps
        and every block whatever the method and Δ-cache)."""
        if self.cp is not None:
            zp, model_fn, _, noise_fn, finish = self._setup(
                z, o, c, y, None, None, True, generator, noise_fn)
            return finish(self.diffusion.p_sample_loop_progressive(
                model_fn, zp, generator=generator, noise_fn=noise_fn,
                clip_denoised=self.clip_denoised))
        chain, t_real = self._chain("ancestral", z, o, c, y, None, None, True)
        frames = []
        for k, i in self._steps():
            chain.step("step", k, i, generator, noise_fn)
            frames.append(chain.x[:, :t_real].clone())
        return torch.stack(frames)

    @torch.no_grad()
    def refine(self, x, o, c, y, iters: int, generator: torch.Generator | None = None,
               noise_fn: NoiseFn | None = None, known_mask: torch.Tensor | None = None,
               use_cfg: bool = True) -> torch.Tensor:
        """The refine pass: `iters` ancestral steps at t = 0 from the
        samples x (N, T, 2), every block (a refine model is trained on t = 0
        only), CFG unless `use_cfg=False`. With `known_mask` (N, T, 2), the
        rows where it is False are pinned to x in every x0 prediction (the
        pattern repair of evals/unfuck.py). At t = 0 a step adds no noise;
        each still draws its own, by the noise contract."""
        known_x = None if known_mask is None else x
        if self.cp is not None:
            xp, model_fn, denoised_fn, noise_fn, finish = self._setup(
                x, o, c, y, known_x, known_mask, use_cfg, generator, noise_fn)
            t0 = torch.zeros((x.shape[0],), dtype=torch.long, device=x.device)
            for k in range(iters):
                xp = self.diffusion.p_sample(model_fn, xp, t0, draw_noise(k, xp, generator, noise_fn),
                                             clip_denoised=self.clip_denoised,
                                             denoised_fn=denoised_fn)["sample"]
            return finish(xp)
        chain, t_real = self._chain("ancestral", x, o, c, y, known_x, known_mask, use_cfg)
        for k in range(iters):
            chain.step("step", k, 0, generator, noise_fn)
        return chain.x[:, :t_real].clone()


def prepare_cfg_inputs(seq_o: torch.Tensor, seq_c: torch.Tensor, class_labels: list[int],
                       num_classes: int, generator: torch.Generator | None = None):
    """CFG-doubled sampling inputs from one processed sequence: n variants
    of fresh noise (drawn on seq_o's device), the context repeated, labels
    [given | null class]. Returns (z, o, c, y)."""
    n = len(class_labels)
    t = seq_o.shape[-1]
    device = seq_o.device
    z = torch.randn((n, t, 2), generator=generator, device=device, dtype=torch.float32)
    o = seq_o.reshape(1, t).expand(n, t)
    c = seq_c.reshape(1, t, -1).expand(n, t, seq_c.shape[-1])
    y = torch.tensor(list(class_labels) + [num_classes] * n, dtype=torch.long, device=device)
    return torch.cat([z, z]), torch.cat([o, o]), torch.cat([c, c]), y
