"""The train step in plain PyTorch: the raw windows featurized for the step
(flips, distances, offsets), the L1 + VLB loss's gradient summed over
blocks of rows, AdamW (lr 1e-4, betas (0.9, 0.999), eps 1e-8, no weight
decay) and the EMA, over f32 master weights.
"""
from __future__ import annotations

import torch

from benchmarks.reference.diffusion import T_ORIGINAL, Diffusion
from benchmarks.reference.model import FIRST_FREQ, PLAYFIELD, Precision, Reference, sinusoid

MAX_TIME_OFFSET = 100000.0
BETAS, EPS = (0.9, 0.999), 1e-8


def draw(n: int, t_len: int, steps: int, drop_prob: float, generator: torch.Generator, device):
    """One step's draws, in the train step's order from its generator:
    flip bits (x, y), the window's time offset in [0, 1), timesteps, noise,
    label drops."""
    u = torch.rand((2, n), generator=generator, device=device)
    offset01 = torch.rand((n, 1), generator=generator, device=device)
    t = torch.randint(0, steps, (n,), generator=generator, device=device)
    noise = torch.randn((n, t_len, 2), generator=generator, device=device)
    drop = torch.rand((n,), generator=generator, device=device) < drop_prob
    return {"flip_x": u[0] < 0.5, "flip_y": u[1] < 0.5, "offset01": offset01, "t": t,
            "noise": noise, "drop": drop}


def featurize(raw: torch.Tensor, prev_xy: torch.Tensor, dr: dict):
    """Raw windows (N, T, 19) and the point before each -> (x0 (N, T, 2) in
    playfield units, flipped; o (N, T) ms from the window's first point
    plus the offset; c (N, T, 144): the 128-wide sinusoid of the distance
    from the previous point, unflipped, and the 16 type one-hots)."""
    xy = raw[..., :2]
    prev = torch.cat([prev_xy[:, None, :], xy[:, :-1]], dim=1)
    dist = torch.sqrt(((xy - prev) ** 2).sum(dim=-1))
    x = torch.where(dr["flip_x"][:, None], PLAYFIELD[0] - xy[..., 0], xy[..., 0])
    y = torch.where(dr["flip_y"][:, None], PLAYFIELD[1] - xy[..., 1], xy[..., 1])
    x0 = torch.stack([x / PLAYFIELD[0], y / PLAYFIELD[1]], dim=-1)
    o = raw[..., 2] - raw[..., :1, 2] + dr["offset01"] * MAX_TIME_OFFSET
    c = torch.cat([sinusoid(dist, FIRST_FREQ), raw[..., 3:]], dim=-1)
    return x0, o, c


class TrainReference:
    """The model's f32 state, AdamW's moments and the EMA, stepped by
    `step(batch, draws)`; `params` are leaves that require grad."""

    def __init__(self, cfg: dict, state: dict, band: int, prec: Precision = Precision(),
                 lr: float = 1e-4, ema_decay: float = 0.9999, rows: int = 32, half_batch: bool = False):
        self.cfg, self.band, self.prec, self.lr, self.decay, self.rows = cfg, band, prec, lr, ema_decay, rows
        self.half_batch = half_batch  # a fault: the loss over the first half of the rows alone
        self.params = {k: v.detach().clone().float().requires_grad_(k != "xoc_embedder.playfield_size")
                       for k, v in state.items()}
        self.ema = {k: v.detach().clone().float() for k, v in state.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.diffusion = Diffusion(T_ORIGINAL, next(iter(state.values())).device)
        self.first_grad: dict | None = None  # each leaf's gradient at step 1

    def loss_and_grad(self, batch, dr) -> tuple[float, float, dict]:
        raw, prev_xy, y = batch
        n = raw.shape[0] // 2 if self.half_batch else raw.shape[0]
        x0, o, c = featurize(raw.float(), prev_xy.float(), dr)
        model = Reference(self.cfg, self.params, self.prec)
        grads = {k: torch.zeros_like(v) for k, v in self.params.items() if v.requires_grad}
        total = l1_total = 0.0
        for s in range(0, n, self.rows):
            r = slice(s, min(s + self.rows, n))
            t = dr["t"][r]
            x_t = self.diffusion.q_sample(x0[r], t, dr["noise"][r])
            out = model.forward(x_t, self.diffusion.timestep_map[t], o[r], c[r], y[r], self.band,
                                drop=dr["drop"][r])
            loss, l1, _ = self.diffusion.l1_vlb(out, x0[r], x_t, t, dr["noise"][r])
            loss = loss.sum() / n
            leaves = [k for k in grads]
            got = torch.autograd.grad(loss, [self.params[k] for k in leaves], allow_unused=True)
            for k, g in zip(leaves, got):
                if g is not None:
                    grads[k] += g
            total += float(loss.detach())
            l1_total += float(l1.detach().sum()) / n
        return total, l1_total, grads

    @torch.no_grad()
    def step(self, batch, dr) -> tuple[float, float]:
        """One optimizer step; returns the step's mean loss and mean L1 term."""
        with torch.enable_grad():
            loss, l1, grads = self.loss_and_grad(batch, dr)
        self.count += 1
        b1, b2 = BETAS
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for k, g in grads.items():
            p, m, v = self.params[k], self.m[k], self.v[k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr / bc1 * m / (v.sqrt() / bc2 ** 0.5 + EPS))
        for k, p in self.params.items():
            self.ema[k].mul_(self.decay).add_(p.detach(), alpha=1 - self.decay)
        if self.first_grad is None:
            self.first_grad = grads
        return loss, l1
