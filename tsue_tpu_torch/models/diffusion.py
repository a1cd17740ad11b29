"""DDPM trajectory generator with classifier-free guidance and EMA.

Counterpart of ``tsue_tpu/models/diffusion.py`` (ref
modify_scripts/capstone_project.py):

- ``ConditionalUNet`` (:1043-1122): a 1-D conv UNet over (B, 2, T), three
  encoder blocks, a middle conv and three decoder blocks with skip
  concatenation, 64 channels; the condition enters by 1-head
  cross-attention at the bottleneck (the port's ``MHA``: 18 queries over
  one condition token, D = 64, the flash kernel on the card).  CFG is in
  the forward: the batch is [uncond half || cond half], the output
  [uncond, uncond + scale * (cond - uncond)];
- the beta schedules and ``DDPMSchedule`` (:1125-1135), numpy in float64,
  copied from the JAX package so both compute the same bits; ``_extract``
  gathers them as fp32;
- ``q_sample`` (:1210-1215), ``p_mean_variance`` with the x0 clamp and the
  reference's DDIM-style mean (:1311-1336), kept verbatim;
- ``p_sample_loop``: the reverse chain as a Python loop on the device, one
  UNet forward a step, every draw from one generator;
- ``ema_update`` (decay 0.9999, :1023-1040) and the CFG train step
  (:1229-1256).

The convs run channel-first (``nn.Conv1d``, padding 1 for Flax's "SAME" at
k = 3); the Flax (3, C_in, C_out) kernels map to (C_out, C_in, 3) in
``convert.load_flax_params``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tsue_tpu_torch.models.layers import MHA, Dense


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _conv(c_in: int, c_out: int) -> nn.Conv1d:
    return nn.Conv1d(c_in, c_out, 3, padding=1)


class ConvBlock(nn.Module):
    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.conv1 = _conv(c_in, features)
        self.conv2 = _conv(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:     # (B, C, T)
        return torch.relu(self.conv2(torch.relu(self.conv1(x))))


class ConditionalUNet(nn.Module):
    def __init__(self, in_channels: int = 2, cond_dim: int = 128,
                 base_channels: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        C = base_channels
        for i in range(n_layers):
            self.add_module(f"enc_{i}", ConvBlock(in_channels if i == 0
                                                  else C, C))
        self.mid = _conv(C, C)
        self.cond_proj = Dense(cond_dim, C)
        self.cross_attn = MHA(C, 1)
        for i in range(n_layers):
            self.add_module(f"dec_{i}", ConvBlock(2 * C, C))
        self.out_conv = _conv(C, in_channels)

    def single(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """The noise prediction of every row: x (B, C_in, T), cond (B,
        cond_dim)."""
        feats, h = [], x
        for i in range(self.n_layers):
            h = self.get_submodule(f"enc_{i}")(h)
            feats.append(h)
        h = torch.relu(self.mid(h))
        # bottleneck cross-attention: queries = time steps, kv = 1 cond token
        c = self.cond_proj(cond)[:, None, :]
        h = h + self.cross_attn(h.transpose(1, 2), c).transpose(1, 2)
        for i in range(self.n_layers):
            h = self.get_submodule(f"dec_{i}")(
                torch.cat([h, feats[-(i + 1)]], dim=1))
        return self.out_conv(h)

    def forward(self, x: torch.Tensor, cond_emb: torch.Tensor,
                cfg_scale: float = 3.0) -> torch.Tensor:
        """x (B, 2, T) with B = [uncond half || cond half]; returns the
        CFG-combined noise prediction in the same layout (ref :1086-1122)."""
        out = self.single(x, cond_emb)
        uncond, cond = out.chunk(2, dim=0)
        return torch.cat([uncond, uncond + cfg_scale * (cond - uncond)], 0)


# ---------------------------------------------------------------------------
# Schedule + sampling
# ---------------------------------------------------------------------------

def make_beta_schedule(schedule_type: str = "cosine", n_timestep: int = 1000,
                       start: float = 1e-4, end: float = 0.02) -> np.ndarray:
    if schedule_type == "linear":
        return np.linspace(start, end, n_timestep, dtype=np.float64)
    if schedule_type == "cosine":
        steps = np.arange(n_timestep + 1, dtype=np.float64)
        ac = np.cos(((steps / n_timestep) + 0.008) / 1.008 * np.pi * 0.5) ** 2
        ac = ac / ac[0]
        # clip like Nichol & Dhariwal; the unclipped tail reaches beta>=1
        # which breaks the posterior variance (the reference leaves this
        # latent hazard in, ref :1130-1133)
        return np.clip(1 - (ac[1:] / ac[:-1]), 0.0, 0.999)
    raise ValueError(f"unknown schedule {schedule_type!r}")


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    betas: np.ndarray
    alphas_cum: np.ndarray
    alphas_cum_prev: np.ndarray
    sqrt_alphas_cum: np.ndarray
    sqrt_one_minus_alphas_cum: np.ndarray
    posterior_var: np.ndarray
    # each coefficient as an fp32 tensor, by (name, device): made once, so
    # the reverse chain's steps copy nothing from the host
    _tables: Dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @staticmethod
    def create(schedule_type: str = "cosine",
               n_timestep: int = 1000) -> "DDPMSchedule":
        betas = make_beta_schedule(schedule_type, n_timestep)
        ac = np.cumprod(1.0 - betas)
        ac_prev = np.append(1.0, ac[:-1])
        return DDPMSchedule(
            betas=betas, alphas_cum=ac, alphas_cum_prev=ac_prev,
            sqrt_alphas_cum=np.sqrt(ac),
            sqrt_one_minus_alphas_cum=np.sqrt(1 - ac),
            posterior_var=betas * (1 - ac_prev) / (1 - ac))

    @property
    def n_timestep(self):
        return len(self.betas)

    def table(self, name: str, device) -> torch.Tensor:
        key = (name, torch.device(device))
        if key not in self._tables:
            self._tables[key] = torch.tensor(
                getattr(self, name).astype(np.float32), device=device)
        return self._tables[key]


def _extract(sched: DDPMSchedule, name: str, t: torch.Tensor,
             ndim: int) -> torch.Tensor:
    """The schedule's coefficient ``name`` at t (fp32), shaped to
    broadcast over an ``ndim``-dim tensor."""
    vals = sched.table(name, t.device)[t]
    return vals.reshape(vals.shape + (1,) * (ndim - 1))


def q_sample(sched: DDPMSchedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward noising (ref :1210-1215)."""
    return (_extract(sched, "sqrt_alphas_cum", t, x0.dim()) * x0 +
            _extract(sched, "sqrt_one_minus_alphas_cum", t, x0.dim())
            * noise)


def p_mean_variance(sched: DDPMSchedule, noise_pred: torch.Tensor,
                    x_t: torch.Tensor, t: torch.Tensor):
    """Reference formula incl. x0 clamp and DDIM-style mean (ref :1311-1336)."""
    n = x_t.dim()
    sqrt_oma = _extract(sched, "sqrt_one_minus_alphas_cum", t, n)
    sqrt_ac = _extract(sched, "sqrt_alphas_cum", t, n)
    x0_pred = (x_t - noise_pred * sqrt_oma) / (sqrt_ac + 1e-7)
    x0_pred = x0_pred.clamp(-1.0, 1.0)
    ac_prev = _extract(sched, "alphas_cum_prev", t, n)
    var = _extract(sched, "posterior_var", t, n)
    mean = torch.sqrt(ac_prev) * x0_pred + torch.sqrt(1 - ac_prev) * noise_pred
    return mean, var


def p_sample_step(model: ConditionalUNet, sched: DDPMSchedule,
                  x: torch.Tensor, t: int, cond_emb: torch.Tensor,
                  z: torch.Tensor, cfg_scale: float = 3.0) -> torch.Tensor:
    """One reverse step from x_t with the noise ``z`` (unused at t = 0)."""
    tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
    mean, var = p_mean_variance(sched, model(x, cond_emb, cfg_scale), x, tb)
    return mean + torch.sqrt(var) * z if t > 0 else mean


@torch.no_grad()
def p_sample_loop(model: ConditionalUNet, sched: DDPMSchedule,
                  shape: Tuple, cond_emb: torch.Tensor,
                  generator: torch.Generator,
                  cfg_scale: float = 3.0) -> torch.Tensor:
    """The full reverse process: x_T from ``generator``, then one step a
    timestep from T - 1 down to 0, each drawing its z from ``generator``.
    ``shape`` = (B, C, T) with B = 2 * half ([uncond || cond] halves, like
    the training batch); returns the final x (same layout).  The same
    generator state gives the same chain bit for bit."""
    dev = cond_emb.device
    x = torch.randn(shape, generator=generator, device=dev)
    for t in range(sched.n_timestep - 1, -1, -1):
        z = torch.randn(shape, generator=generator, device=dev)
        x = p_sample_step(model, sched, x, t, cond_emb, z, cfg_scale)
    return x


# ---------------------------------------------------------------------------
# EMA + train step
# ---------------------------------------------------------------------------

@torch.no_grad()
def ema_update(shadow: nn.Module, model: nn.Module,
               decay: float = 0.9999) -> None:
    """shadow <- decay * shadow + (1 - decay) * params, in place (ref
    :1023-1040)."""
    for s, p in zip(shadow.parameters(), model.parameters()):
        s.copy_(decay * s + (1 - decay) * p)


def diffusion_loss(model: ConditionalUNet, sched: DDPMSchedule,
                   x0: torch.Tensor, cond: torch.Tensor,
                   uncond: torch.Tensor, t: torch.Tensor,
                   noise: torch.Tensor, cfg_scale: float = 3.0
                   ) -> torch.Tensor:
    """The CFG training loss given its draws (ref :1229-1256): the batch
    duplicated into [uncond || cond] halves (``uncond``: the
    unconditional half's condition, (B, cond_dim)), noised at ``t`` (2B,)
    with ``noise`` (2B, 2, T), the MSE of the noise prediction."""
    full_cond = torch.cat([uncond, cond], dim=0)
    x_t = q_sample(sched, torch.cat([x0, x0], dim=0), t, noise)
    return torch.mean((model(x_t, full_cond, cfg_scale) - noise) ** 2)


def make_diffusion_train_step(model: ConditionalUNet, sched: DDPMSchedule,
                              optimizer: torch.optim.Optimizer,
                              ema_model: Optional[nn.Module] = None,
                              cfg_scale: float = 3.0,
                              uncond_scale: float = 0.05) -> Callable:
    """Returns ``step(x0, cond, generator) -> {"loss"}``: the draws (the
    unconditional condition ``uncond_scale * N(0, 1)``, t uniform in [0,
    n_timestep), the noise) from ``generator``, ``diffusion_loss``, one
    optimizer step and, with ``ema_model``, ``ema_update`` after it."""
    def step(x0: torch.Tensor, cond: torch.Tensor,
             generator: torch.Generator) -> Dict:
        dev = x0.device
        uncond = uncond_scale * torch.randn(cond.shape, generator=generator,
                                            device=dev)
        t = torch.randint(0, sched.n_timestep, (2 * x0.shape[0],),
                          generator=generator, device=dev)
        noise = torch.randn((2 * x0.shape[0],) + tuple(x0.shape[1:]),
                            generator=generator, device=dev)
        loss = diffusion_loss(model, sched, x0, cond, uncond, t, noise,
                              cfg_scale)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        if ema_model is not None:
            ema_update(ema_model, model)
        return {"loss": loss.detach()}

    return step
