"""Gaussian diffusion (port of osu_diffusion_tpu/diffusion/process.py):
the sampling chains, guidance, the training losses and the likelihood.

- Coefficient tables are computed in float64 numpy and stored as float32
  tensors on the process's device.
- Respacing is data: `timestep_map[t]` is gathered before the model call,
  which also takes `model_kwargs`.
- The chains (`p_sample_loop`, `p_sample_loop_progressive`,
  `ddim_sample_loop`) and `calc_bpd_loop` are Python loops over t = S-1 ..
  0. Each step's noise comes from an explicit `torch.Generator`, or from
  `noise_fn(step_index, shape)` so a test can feed in another framework's
  draws (DDIM steps draw theirs too, scaled by eta). The chains run each
  step as a `StepProgram`: one step over static buffers (x, t, the step's
  noise) that writes x in place, the form the Sampler captures as a CUDA
  graph (sampling.py); the noise is drawn outside the step, into its
  buffer, so a captured chain draws the eager chain's bits. `calc_bpd_loop`
  runs each step as a `BpdProgram` over the same kind of buffers and, on
  the card, captures and replays it itself (graphs.py). `denoised_fn`
  (in-painting) edits each x0 prediction before the clamp; `cond_fn(x, t,
  **model_kwargs)` guides the mean (ancestral steps) or the score (DDIM).
- Channel layout is (N, T, C); the eps/variance split is over the last axis.

The model predicts eps, x0 or x_{t-1} (`model_mean_type`), with a learned
(2C output channels) or a fixed (C channels) variance (`model_var_type`).
Quirks kept from the reference: the x0 clamp to [-1, 2] under
`clip_denoised` (the playfield-normalized range; the sampler clips, the
VLB term never does), the learned_range variance interpolated in log space
between the posterior and beta, the VLB computed on a detached mean
prediction, the rescaled losses' VLB scaled by num_timesteps / 1000 (and
the rescaled KL by num_timesteps), and the discretized decoder likelihood
with 1/255 bins and a tanh CDF.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from osu_diffusion_tpu_torch.diffusion import schedule as sched
from osu_diffusion_tpu_torch.graphs import GraphedStep, warm_up

ModelFn = Callable[..., torch.Tensor]  # model(x, t, **model_kwargs) -> (N, T, C')
NoiseFn = Callable[[int, tuple], torch.Tensor]


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL divergence between two gaussians, broadcasting."""
    return 0.5 * (
        -1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x):
    """tanh approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * torch.pow(x, 3))))


def continuous_gaussian_log_likelihood(x, *, means, log_scales):
    """Log density of x under N(means, exp(log_scales)^2), up to the
    reference's form (-0.5 (z^2 + log 2pi), no log-scale term)."""
    normalized_x = (x - means) * torch.exp(-log_scales)
    return -0.5 * (normalized_x ** 2 + np.log(2.0 * np.pi))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of data discretized to 1/255 bins, the outer bins
    open-ended at -0.999 and 0.999."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(
        x < -0.999, log_cdf_plus, torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta)
    )


def draw_noise(k: int, x: torch.Tensor, generator: torch.Generator | None,
               noise_fn: NoiseFn | None) -> torch.Tensor:
    """Step k's noise at x's shape: `noise_fn(k, shape)` when given, else a
    draw from `generator` on x's device."""
    if noise_fn is not None:
        return noise_fn(k, tuple(x.shape))
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)


def _extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients, (N,) -> (N, 1, ...) of `ndim` axes."""
    out = arr[t].to(torch.float32)
    return out.reshape(out.shape + (1,) * (ndim - 1))


class StepProgram:
    """One denoise step as a program over static buffers: a call reads x_t
    from `x`, the local timesteps from `t` (N,) and the step's noise from
    `noise`, runs `step` (p_sample or ddim_sample) with `model_fn` and the
    chain's constants (`step_kwargs`), and writes x_{t-1} into `x` in
    place. `set` fills t and the noise before each call, outside the
    program. Programs may share their buffers (the Δ-cache's "record" and
    "apply" steps do). The chains run it eagerly; the Sampler also captures
    a call as a CUDA graph and replays it, each replay a step."""

    def __init__(self, step: Callable, model_fn: ModelFn, x: torch.Tensor,
                 t: torch.Tensor | None = None, noise: torch.Tensor | None = None, **step_kwargs):
        self.step, self.model_fn, self.step_kwargs = step, model_fn, step_kwargs
        self.x = x
        self.t = torch.zeros((x.shape[0],), dtype=torch.long, device=x.device) if t is None else t
        self.noise = torch.zeros_like(x) if noise is None else noise

    def set(self, i: int, noise: torch.Tensor) -> None:
        """The next step's local timestep i and noise (copied in)."""
        self.t.fill_(i)
        self.noise.copy_(noise)

    def __call__(self) -> None:
        out = self.step(self.model_fn, self.x, self.t, self.noise, **self.step_kwargs)
        self.x.copy_(out["sample"])


class BpdProgram:
    """One step of `calc_bpd_loop` as a program over static buffers: a call
    reads x_start, the local timesteps from `t` (N,) and the step's noise
    from `noise`, and writes the step's vb, xstart_mse and mse, each (N,),
    into the rows of `out` (3, N). `set` fills t and the noise before each
    call, outside the program."""

    def __init__(self, diffusion: "GaussianDiffusion", model_fn: ModelFn, x_start: torch.Tensor,
                 clip_denoised: bool = True, model_kwargs: dict | None = None):
        self.diffusion, self.model_fn, self.x_start = diffusion, model_fn, x_start
        self.clip_denoised, self.model_kwargs = clip_denoised, model_kwargs
        self.t = torch.zeros((x_start.shape[0],), dtype=torch.long, device=x_start.device)
        self.noise = torch.zeros_like(x_start)
        self.out = x_start.new_zeros((3, x_start.shape[0]))

    def set(self, i: int, noise: torch.Tensor) -> None:
        """The next step's local timestep i and noise (copied in)."""
        self.t.fill_(i)
        self.noise.copy_(noise)

    def __call__(self) -> None:
        d, x_start, t, noise = self.diffusion, self.x_start, self.t, self.noise
        x_t = d.q_sample(x_start, t, noise)
        out = d._vb_terms_bpd(self.model_fn, x_start, x_t, t, clip_denoised=self.clip_denoised,
                              model_kwargs=self.model_kwargs)
        eps = d._predict_eps_from_xstart(x_t, t, out["pred_xstart"])
        self.out[0].copy_(out["output"])
        self.out[1].copy_(mean_flat((out["pred_xstart"] - x_start) ** 2))
        self.out[2].copy_(mean_flat((eps - noise) ** 2))


@dataclass(frozen=True)
class GaussianDiffusion:
    """Float32 coefficient tables of shape (S,), S = retained timesteps."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    log_betas: torch.Tensor
    fixed_large_variance: torch.Tensor
    log_fixed_large_variance: torch.Tensor
    timestep_map: torch.Tensor  # int64 (S,): local step -> original timestep
    num_timesteps: int
    original_num_steps: int
    model_mean_type: str = "epsilon"  # "epsilon" | "xstart" | "xprev"
    model_var_type: str = "learned_range"  # "learned" | "learned_range" | "fixed_small" | "fixed_large"
    loss_type: str = "mse"  # "mse" | "l1" | "rescaled_mse" | "rescaled_l1" | "kl" | "rescaled_kl"

    # -- q distributions ----------------------------------------------------

    def q_mean_variance(self, x_start, t):
        """q(x_t | x_0): (mean, variance, log variance)."""
        nd = x_start.ndim
        return (
            _extract(self.sqrt_alphas_cumprod, t, nd) * x_start,
            _extract(1.0 - self.alphas_cumprod, t, nd),
            _extract(self.log_one_minus_alphas_cumprod, t, nd),
        )

    def q_sample(self, x_start, t, noise):
        """Sample q(x_t | x_0) with the given noise."""
        nd = x_start.ndim
        return (
            _extract(self.sqrt_alphas_cumprod, t, nd) * x_start
            + _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise
        )

    def q_posterior_mean(self, x_start, x_t, t):
        """Mean of q(x_{t-1} | x_t, x_0)."""
        nd = x_t.ndim
        return (
            _extract(self.posterior_mean_coef1, t, nd) * x_start
            + _extract(self.posterior_mean_coef2, t, nd) * x_t
        )

    def q_posterior_mean_variance(self, x_start, x_t, t):
        """q(x_{t-1} | x_t, x_0): (mean, variance, clipped log variance)."""
        nd = x_t.ndim
        return (
            self.q_posterior_mean(x_start, x_t, t),
            _extract(self.posterior_variance, t, nd),
            _extract(self.posterior_log_variance_clipped, t, nd),
        )

    # -- the model's output -------------------------------------------------

    def _call_model(self, model_fn: ModelFn, x, t, model_kwargs: dict | None):
        """The model at the original process's timesteps of local steps t."""
        return model_fn(x, self.timestep_map[t], **(model_kwargs or {}))

    def _predict_xstart_from_eps(self, x_t, t, eps):
        nd = x_t.ndim
        return (
            _extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - _extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * eps
        )

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        nd = x_t.ndim
        return (
            _extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart
        ) / _extract(self.sqrt_recipm1_alphas_cumprod, t, nd)

    def _predict_xstart_from_xprev(self, x_t, t, xprev):
        nd = x_t.ndim
        coef1 = _extract(self.posterior_mean_coef1, t, nd)
        return xprev / coef1 - _extract(self.posterior_mean_coef2, t, nd) / coef1 * x_t

    def _variance(self, x, t, model_output):
        """(mean part of the output, variance, log variance): a learned
        variance splits the (..., 2C) output (learned_range interpolates
        between the posterior's and beta's log variance); a fixed one is
        the table's, (N, 1, ...)."""
        nd = x.ndim
        if self.model_var_type in ("learned", "learned_range"):
            c = x.shape[-1]
            model_output, var_values = model_output[..., :c], model_output[..., c:]
            if self.model_var_type == "learned":
                log_variance = var_values
            else:
                min_log = _extract(self.posterior_log_variance_clipped, t, nd)
                max_log = _extract(self.log_betas, t, nd)
                frac = (var_values + 1) / 2
                log_variance = frac * max_log + (1 - frac) * min_log
            return model_output, torch.exp(log_variance), log_variance
        if self.model_var_type == "fixed_large":
            return (model_output, _extract(self.fixed_large_variance, t, nd),
                    _extract(self.log_fixed_large_variance, t, nd))
        return (model_output, _extract(self.posterior_variance, t, nd),
                _extract(self.posterior_log_variance_clipped, t, nd))

    def p_mean_variance(self, model_fn: ModelFn, x, t, clip_denoised: bool = True,
                        denoised_fn: Callable | None = None,
                        model_kwargs: dict | None = None) -> dict[str, torch.Tensor]:
        """p(x_{t-1} | x_t) and the x_0 prediction: `denoised_fn` applied to
        it first, then the clamp to [-1, 2] under `clip_denoised`. Returns
        {mean, variance, log_variance, pred_xstart}."""
        model_output = self._call_model(model_fn, x, t, model_kwargs)
        model_output, variance, log_variance = self._variance(x, t, model_output)
        if self.model_mean_type == "xstart":
            pred_xstart = model_output
        elif self.model_mean_type == "xprev":
            pred_xstart = self._predict_xstart_from_xprev(x, t, model_output)
        else:
            pred_xstart = self._predict_xstart_from_eps(x, t, model_output)
        if denoised_fn is not None:
            pred_xstart = denoised_fn(pred_xstart)
        if clip_denoised:  # playfield-normalized clamp, as the reference does
            pred_xstart = pred_xstart.clamp(-1.0, 2.0)
        return {
            "mean": self.q_posterior_mean(pred_xstart, x, t),
            "variance": variance,
            "log_variance": log_variance,
            "pred_xstart": pred_xstart,
        }

    # -- guidance -----------------------------------------------------------

    def condition_mean(self, cond_fn: Callable, p_mean_var, x, t, model_kwargs=None):
        """The mean shifted by variance * grad log p(y | x_t) (Sohl-Dickstein
        et al.), the gradient `cond_fn(x, mapped t, **model_kwargs)`."""
        gradient = cond_fn(x, self.timestep_map[t], **(model_kwargs or {}))
        return p_mean_var["mean"] + p_mean_var["variance"] * gradient

    def condition_score(self, cond_fn: Callable, p_mean_var, x, t, model_kwargs=None):
        """Score conditioning (Song et al.): eps less sqrt(1 - alpha_bar) *
        cond_fn's gradient, and x0 and the mean recomputed from it."""
        alpha_bar = _extract(self.alphas_cumprod, t, x.ndim)
        eps = self._predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, self.timestep_map[t],
                                                       **(model_kwargs or {}))
        out = dict(p_mean_var)
        out["pred_xstart"] = self._predict_xstart_from_eps(x, t, eps)
        out["mean"] = self.q_posterior_mean(out["pred_xstart"], x, t)
        return out

    # -- the steps and the chains -------------------------------------------

    def p_sample(self, model_fn: ModelFn, x, t, noise: torch.Tensor, clip_denoised: bool = True,
                 denoised_fn: Callable | None = None, cond_fn: Callable | None = None,
                 model_kwargs: dict | None = None) -> dict[str, torch.Tensor]:
        """One ancestral step x_t -> x_{t-1}, with the step's noise given."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn, model_kwargs)
        if cond_fn is not None:
            out["mean"] = self.condition_mean(cond_fn, out, x, t, model_kwargs)
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample(self, model_fn: ModelFn, x, t, noise: torch.Tensor, clip_denoised: bool = True,
                    denoised_fn: Callable | None = None, cond_fn: Callable | None = None,
                    model_kwargs: dict | None = None,
                    eta: float = 0.0) -> dict[str, torch.Tensor]:
        """One DDIM step x_t -> x_{t-1}; `eta` scales the step's noise (0:
        the deterministic ODE step)."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn, model_kwargs)
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t, model_kwargs)
        nd = x.ndim
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = _extract(self.alphas_cumprod, t, nd)
        alpha_bar_prev = _extract(self.alphas_cumprod_prev, t, nd)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                     + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (nd - 1))
        return {"sample": mean_pred + nonzero * sigma * noise, "pred_xstart": out["pred_xstart"]}

    def ddim_reverse_sample(self, model_fn: ModelFn, x, t, clip_denoised: bool = True,
                            denoised_fn: Callable | None = None, cond_fn: Callable | None = None,
                            model_kwargs: dict | None = None,
                            eta: float = 0.0) -> dict[str, torch.Tensor]:
        """One reverse DDIM step x_t -> x_{t+1} (the deterministic ODE only)."""
        if eta != 0.0:
            raise ValueError("the reverse ODE is deterministic: eta must be 0")
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn, model_kwargs)
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t, model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar_next = _extract(self.alphas_cumprod_next, t, x.ndim)
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_next)
                     + torch.sqrt(1 - alpha_bar_next) * eps)
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}

    def _loop(self, step: Callable, model_fn: ModelFn, noise: torch.Tensor, generator, noise_fn,
              progressive: bool, **step_kwargs):
        """Run `step` over t = S-1 .. 0 from x_T = `noise` as a
        `StepProgram`; step k draws its noise by `draw_noise`. The last
        sample, or every sample stacked (S, ...) when `progressive`."""
        program = StepProgram(step, model_fn, noise.clone(), **step_kwargs)
        frames = []
        for k, i in enumerate(range(self.num_timesteps - 1, -1, -1)):
            program.set(i, draw_noise(k, program.x, generator, noise_fn))
            program()
            if progressive:
                frames.append(program.x.clone())
        return torch.stack(frames) if progressive else program.x

    def p_sample_loop(self, model_fn: ModelFn, noise: torch.Tensor,
                      generator: torch.Generator | None = None, noise_fn: NoiseFn | None = None,
                      clip_denoised: bool = True, denoised_fn: Callable | None = None,
                      cond_fn: Callable | None = None,
                      model_kwargs: dict | None = None) -> torch.Tensor:
        """Full ancestral chain from x_T = `noise`, over t = S-1 .. 0.

        Step k (t = S-1-k) draws its noise from `noise_fn(k, shape)` when
        given, else from `generator` on the noise's device."""
        return self._loop(self.p_sample, model_fn, noise, generator, noise_fn, False,
                          clip_denoised=clip_denoised, denoised_fn=denoised_fn, cond_fn=cond_fn,
                          model_kwargs=model_kwargs)

    def p_sample_loop_progressive(self, model_fn: ModelFn, noise: torch.Tensor,
                                  generator: torch.Generator | None = None,
                                  noise_fn: NoiseFn | None = None, clip_denoised: bool = True,
                                  denoised_fn: Callable | None = None,
                                  cond_fn: Callable | None = None,
                                  model_kwargs: dict | None = None) -> torch.Tensor:
        """`p_sample_loop`, returning every step's sample stacked (S, ...)
        (the frames of a denoising animation)."""
        return self._loop(self.p_sample, model_fn, noise, generator, noise_fn, True,
                          clip_denoised=clip_denoised, denoised_fn=denoised_fn, cond_fn=cond_fn,
                          model_kwargs=model_kwargs)

    def ddim_sample_loop(self, model_fn: ModelFn, noise: torch.Tensor,
                         generator: torch.Generator | None = None, noise_fn: NoiseFn | None = None,
                         clip_denoised: bool = True, denoised_fn: Callable | None = None,
                         cond_fn: Callable | None = None, model_kwargs: dict | None = None,
                         eta: float = 0.0) -> torch.Tensor:
        """Full DDIM chain from x_T = `noise`, with the noise contract of
        `p_sample_loop` (each step draws its noise, scaled by eta)."""
        return self._loop(self.ddim_sample, model_fn, noise, generator, noise_fn, False,
                          clip_denoised=clip_denoised, denoised_fn=denoised_fn, cond_fn=cond_fn,
                          model_kwargs=model_kwargs, eta=eta)

    # -- the training losses and the likelihood -----------------------------

    def _vb_terms_bpd(self, model_fn: ModelFn, x_start, x_t, t, clip_denoised: bool = True,
                      model_kwargs: dict | None = None) -> dict[str, torch.Tensor]:
        """Variational-bound term in bits per dim: KL(q || p) for t > 0, the
        discretized decoder NLL at t = 0."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t, clip_denoised=clip_denoised,
                                   model_kwargs=model_kwargs)
        kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
        kl = mean_flat(kl) / np.log(2.0)
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"]
        )
        decoder_nll = mean_flat(decoder_nll) / np.log(2.0)
        return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": out["pred_xstart"]}

    def training_losses(self, model_fn: ModelFn, x_start, t, noise,
                        model_kwargs: dict | None = None) -> dict[str, torch.Tensor]:
        """Per-sample training loss at local timesteps t with the given
        noise. Under "kl"/"rescaled_kl" only {"loss"}, the VLB (x
        num_timesteps when rescaled); else {"loss", "l1" or "mse"} against
        the mean type's target, plus "vb" when the variance is learned: the
        VLB through a detached mean prediction (x num_timesteps / 1000 under
        the rescaled losses)."""
        x_t = self.q_sample(x_start, t, noise)
        if self.loss_type in ("kl", "rescaled_kl"):
            loss = self._vb_terms_bpd(model_fn, x_start, x_t, t, clip_denoised=False,
                                      model_kwargs=model_kwargs)["output"]
            return {"loss": loss * self.num_timesteps if self.loss_type == "rescaled_kl" else loss}

        model_output = self._call_model(model_fn, x_t, t, model_kwargs)
        terms = {}
        if self.model_var_type in ("learned", "learned_range"):
            c = x_t.shape[-1]
            model_output, var_values = model_output[..., :c], model_output[..., c:]
            frozen_out = torch.cat([model_output.detach(), var_values], dim=-1)
            terms["vb"] = self._vb_terms_bpd(lambda *_, **__: frozen_out, x_start, x_t, t,
                                             clip_denoised=False)["output"]
            if self.loss_type in ("rescaled_mse", "rescaled_l1"):
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)

        if self.model_mean_type == "xprev":
            target = self.q_posterior_mean(x_start, x_t, t)
        elif self.model_mean_type == "xstart":
            target = x_start
        else:
            target = noise
        if self.loss_type in ("l1", "rescaled_l1"):
            key, err = "l1", (target - model_output).abs()
        else:
            key, err = "mse", (target - model_output) ** 2
        terms[key] = mean_flat(err)
        terms["loss"] = terms[key] + terms["vb"] if "vb" in terms else terms[key]
        return terms

    def _prior_bpd(self, x_start) -> torch.Tensor:
        """KL(q(x_T | x_0) || N(0, 1)) in bits per dim, (N,)."""
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.long,
                       device=x_start.device)
        qt_mean, _, qt_log_variance = self.q_mean_variance(x_start, t)
        zero = qt_mean.new_zeros(())
        return mean_flat(normal_kl(qt_mean, qt_log_variance, zero, zero)) / np.log(2.0)

    @torch.no_grad()
    def calc_bpd_loop(self, model_fn: ModelFn, x_start, generator: torch.Generator | None = None,
                      noise_fn: NoiseFn | None = None, clip_denoised: bool = True,
                      model_kwargs: dict | None = None,
                      cuda_graph: bool = True) -> dict[str, torch.Tensor]:
        """The whole variational bound of x_start, a step for each t = S-1
        .. 0; step k (t = S-1-k) draws its noise as the chains do. Returns
        {total_bpd (N,), prior_bpd (N,), vb, xstart_mse, mse}, the last
        three (N, S) with column k for t = S-1-k (descending t).

        Each step is a `BpdProgram`, its noise drawn into the program's
        buffer outside it and its three outputs copied into column k on the
        device. On a CUDA device with `cuda_graph` (the default) the first
        step runs eagerly on a side stream, is captured as a CUDA graph, and
        every later step replays it (a capture error raises); on the CPU, or
        with `cuda_graph=False`, every step runs eagerly: the same bits."""
        s = self.num_timesteps
        program = BpdProgram(self, model_fn, x_start, clip_denoised=clip_denoised,
                             model_kwargs=model_kwargs)
        columns = x_start.new_empty((3, x_start.shape[0], s))
        graphed = cuda_graph and x_start.device.type == "cuda"
        graph = None
        for k, i in enumerate(range(s - 1, -1, -1)):
            program.set(i, draw_noise(k, x_start, generator, noise_fn))
            if not graphed:
                program()
            elif graph is not None:
                graph.replay()
            else:
                warm_up(program, x_start.device)  # the warm-up is step 0 itself
                graph = GraphedStep(x_start.device, program)
            columns[:, :, k].copy_(program.out)
        vb, xstart_mse, mse = columns.unbind()
        prior_bpd = self._prior_bpd(x_start)
        return {"total_bpd": vb.sum(dim=1) + prior_bpd, "prior_bpd": prior_bpd, "vb": vb,
                "xstart_mse": xstart_mse, "mse": mse}


def _build(betas: np.ndarray, timestep_map: np.ndarray, original_num_steps: int, device,
           model_mean_type: str = "epsilon", model_var_type: str = "learned_range",
           loss_type: str = "mse") -> GaussianDiffusion:
    betas = np.asarray(betas, dtype=np.float64)
    if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be a 1-D array in (0, 1]")
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    if len(posterior_variance) > 1:
        posterior_log_variance_clipped = np.log(
            np.append(posterior_variance[1], posterior_variance[1:])
        )
        fixed_large_variance = np.append(posterior_variance[1], betas[1:])
    else:
        # a 1-step chain has no index 1 to borrow the clipped value from
        posterior_log_variance_clipped = np.log(betas)
        fixed_large_variance = betas.copy()

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return GaussianDiffusion(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        alphas_cumprod_next=f32(alphas_cumprod_next),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        log_betas=f32(np.log(betas)),
        fixed_large_variance=f32(fixed_large_variance),
        log_fixed_large_variance=f32(np.log(fixed_large_variance)),
        timestep_map=torch.as_tensor(np.asarray(timestep_map, dtype=np.int64), device=device),
        num_timesteps=int(betas.shape[0]),
        original_num_steps=int(original_num_steps),
        model_mean_type=model_mean_type,
        model_var_type=model_var_type,
        loss_type=loss_type,
    )


def create_diffusion(
    timestep_respacing: str | list | None = "",
    noise_schedule: str = "linear",
    use_kl: bool = False,
    sigma_small: bool = False,
    predict_xstart: bool = False,
    learn_sigma: bool = True,
    rescale_learned_sigmas: bool = False,
    diffusion_steps: int = 1000,
    use_l1: bool = False,
    device="cpu",
) -> GaussianDiffusion:
    """The JAX factory's flags, mapped as it maps them, the tables on
    `device`: `use_kl` -> the rescaled KL loss, else `rescale_learned_sigmas`
    -> rescaled L1 (`use_l1`) or MSE, else plain L1 or MSE;
    `predict_xstart` -> the model predicts x0, else eps; `learn_sigma` ->
    the learned-range variance, else the fixed posterior variance
    (`sigma_small`) or the fixed large one."""
    betas = sched.get_named_beta_schedule(noise_schedule, diffusion_steps)
    if use_kl:
        loss_type = "rescaled_kl"
    elif rescale_learned_sigmas:
        loss_type = "rescaled_l1" if use_l1 else "rescaled_mse"
    else:
        loss_type = "l1" if use_l1 else "mse"
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    use_timesteps = sched.space_timesteps(diffusion_steps, timestep_respacing)
    new_betas, timestep_map = sched.respace_betas(betas, use_timesteps)
    return _build(
        new_betas, timestep_map, original_num_steps=diffusion_steps, device=device,
        model_mean_type="xstart" if predict_xstart else "epsilon",
        model_var_type=("learned_range" if learn_sigma
                        else "fixed_small" if sigma_small else "fixed_large"),
        loss_type=loss_type,
    )
