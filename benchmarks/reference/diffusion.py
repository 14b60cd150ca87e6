"""Gaussian diffusion in plain PyTorch (Ho et al. 2020; Nichol & Dhariwal
2021, the improved-DDPM code that DiT and osu-diffusion train with): the
squaredcos_cap_v2 schedule, respacing to S evenly spaced steps, the learned
range variance, ancestral steps with the x0 clamp to the playfield's
[-1, 2], and the L1 + VLB training loss (the VLB through a detached mean,
in bits, the discretized decoder likelihood at t = 0).

Tables are computed in float64 and used in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

T_ORIGINAL = 1000
X0_CLAMP = (-1.0, 2.0)


def cosine_betas(n: int = T_ORIGINAL, max_beta: float = 0.999) -> np.ndarray:
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    return np.array([min(1 - alpha_bar((i + 1) / n) / alpha_bar(i / n), max_beta) for i in range(n)])


def spaced_steps(n: int, count: int) -> list[int]:
    """`count` timesteps of n, evenly spaced from 0 to n - 1, rounded."""
    if count <= 1:
        return [0]
    stride = (n - 1) / (count - 1)
    return [round(k * stride) for k in range(count)]


class Diffusion:
    def __init__(self, steps: int, device):
        base = np.cumprod(1.0 - cosine_betas())
        keep = spaced_steps(T_ORIGINAL, steps)
        abar = base[keep]
        abar_prev = np.append(1.0, abar[:-1])
        betas = 1.0 - abar / abar_prev
        post_var = betas * (1.0 - abar_prev) / (1.0 - abar)
        post_logvar = np.log(np.append(post_var[1], post_var[1:]) if len(betas) > 1 else betas)

        def f32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

        self.steps = len(betas)
        self.timestep_map = torch.as_tensor(keep, dtype=torch.int64, device=device)
        self.sqrt_abar, self.sqrt_1m_abar = f32(np.sqrt(abar)), f32(np.sqrt(1.0 - abar))
        self.sqrt_recip, self.sqrt_recipm1 = f32(np.sqrt(1.0 / abar)), f32(np.sqrt(1.0 / abar - 1))
        self.coef1 = f32(betas * np.sqrt(abar_prev) / (1.0 - abar))
        self.coef2 = f32((1.0 - abar_prev) * np.sqrt(1.0 - betas) / (1.0 - abar))
        self.post_logvar, self.log_betas = f32(post_logvar), f32(np.log(betas))

    @staticmethod
    def _at(table, t, ndim):
        return table[t].reshape((-1,) + (1,) * (ndim - 1))

    def mean_logvar(self, out, x, t, clip: bool):
        """(mean, log variance, x0) of p(x_{t-1} | x_t) from the model's
        (eps, variance values) output."""
        nd, ch = x.ndim, x.shape[-1]
        eps, v = out[..., :ch], out[..., ch:]
        frac = (v + 1) / 2
        logvar = frac * self._at(self.log_betas, t, nd) + (1 - frac) * self._at(self.post_logvar, t, nd)
        x0 = self._at(self.sqrt_recip, t, nd) * x - self._at(self.sqrt_recipm1, t, nd) * eps
        if clip:
            x0 = x0.clamp(*X0_CLAMP)
        mean = self._at(self.coef1, t, nd) * x0 + self._at(self.coef2, t, nd) * x
        return mean, logvar, x0

    def p_sample(self, out, x, t, noise):
        """One ancestral step from the model output at local steps t."""
        mean, logvar, _ = self.mean_logvar(out, x, t, clip=True)
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        return mean + nonzero * torch.exp(0.5 * logvar) * noise

    def q_sample(self, x0, t, noise):
        nd = x0.ndim
        return self._at(self.sqrt_abar, t, nd) * x0 + self._at(self.sqrt_1m_abar, t, nd) * noise

    def l1_vlb(self, out, x0, x_t, t, noise):
        """Per-sample (loss, l1, vb): the L1 of the eps prediction plus the
        VLB term of the variance through the detached eps."""
        nd, ch = x_t.ndim, x_t.shape[-1]
        eps, v = out[..., :ch], out[..., ch:]
        frozen = torch.cat([eps.detach(), v], dim=-1)
        mean, logvar, _ = self.mean_logvar(frozen, x_t, t, clip=False)
        true_mean = self._at(self.coef1, t, nd) * x0 + self._at(self.coef2, t, nd) * x_t
        true_logvar = self._at(self.post_logvar, t, nd)
        kl = 0.5 * (-1.0 + logvar - true_logvar + torch.exp(true_logvar - logvar)
                    + (true_mean - mean) ** 2 * torch.exp(-logvar))
        kl = kl.mean(dim=tuple(range(1, nd))) / math.log(2.0)
        nll = -discretized_log_likelihood(x0, mean, 0.5 * logvar).mean(dim=tuple(range(1, nd))) / math.log(2.0)
        vb = torch.where(t == 0, nll, kl)
        l1 = (noise - eps).abs().mean(dim=tuple(range(1, nd)))
        return l1 + vb, l1, vb


def _cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_log_likelihood(x, means, log_scales):
    """Log-likelihood of x in 1/255-wide bins (outer bins open past 0.999)."""
    centered = x - means
    inv = torch.exp(-log_scales)
    cdf_plus, cdf_min = _cdf(inv * (centered + 1.0 / 255.0)), _cdf(inv * (centered - 1.0 / 255.0))
    log_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_plus, torch.where(x > 0.999, log_one_minus_min, log_delta))
