"""Noise schedule and solver steps for the denoise loop.

Counterpart of ``stabletriton_tpu/runtime/scheduler.py``: the schedule and
the Euler, Euler-Ancestral, Heun and DPM-Solver++(2M) steps. The schedule
tables are numpy, computed on the host exactly as in the JAX package.
Semantics match diffusers' EulerDiscreteScheduler as SDXL configures it
(scaled-linear betas 0.00085 -> 0.012 over 1000 train steps, "leading"
spacing, steps_offset 1, epsilon prediction). A v-prediction model (SD2.x
768-v) is served by converting its output to eps once per evaluation
(:func:`v_to_eps`), before any solver sees it, so the steps below are
epsilon steps only.

The step functions run on tensors; every scalar of a step (a sigma
difference, sigma_down / sigma_up, DPM++'s h, r0 and expm1(-h)) is a
constant of the schedule, computed on the host in float32 as JAX computes
it on its float32 sigmas inside the scan, and the collapses at
``sigma_next == 0`` and DPM++'s first step are Python branches: a step
launches the same kernels at every call, so the loop stays capturable.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PREDICTION_TYPES = ("epsilon", "v_prediction")


@dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    timestep_spacing: str = "leading"
    steps_offset: int = 1
    use_karras_sigmas: bool = False
    # what the UNet predicts: "epsilon" (the noise) or "v_prediction"
    # (v = alpha_t eps - sigma_t x0, Salimans & Ho 2022)
    prediction_type: str = "epsilon"

    def __post_init__(self):
        if self.prediction_type not in PREDICTION_TYPES:
            raise ValueError(f"unknown prediction_type {self.prediction_type!r}; "
                             f"one of {PREDICTION_TYPES}")


@dataclass(frozen=True)
class Schedule:
    timesteps: np.ndarray  # (steps,) float32, descending
    sigmas: np.ndarray     # (steps + 1,) float32, final entry 0.0
    init_noise_sigma: float


def _training_sigmas(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5,
                            cfg.num_train_timesteps, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps,
                            dtype=np.float64)
    else:
        raise ValueError(f"unknown beta_schedule {cfg.beta_schedule!r}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    return np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)


def make_schedule(cfg: SchedulerConfig, num_steps: int) -> Schedule:
    train_sigmas = _training_sigmas(cfg)
    n = cfg.num_train_timesteps
    if cfg.timestep_spacing == "leading":
        ratio = n // num_steps
        timesteps = (np.arange(num_steps) * ratio).round()[::-1].astype(np.float64)
        timesteps += cfg.steps_offset
    elif cfg.timestep_spacing == "linspace":
        timesteps = np.linspace(0, n - 1, num_steps, dtype=np.float64)[::-1]
    elif cfg.timestep_spacing == "trailing":
        ratio = n / num_steps
        timesteps = (np.arange(n, 0, -ratio)).round().astype(np.float64) - 1
    else:
        raise ValueError(f"unknown timestep_spacing {cfg.timestep_spacing!r}")

    sigmas = np.interp(timesteps, np.arange(n), train_sigmas)
    if cfg.use_karras_sigmas:
        rho = 7.0
        smin, smax = sigmas[-1], sigmas[0]
        ramp = np.linspace(0, 1, num_steps)
        sigmas = (smax ** (1 / rho) + ramp * (smin ** (1 / rho) - smax ** (1 / rho))) ** rho
        timesteps = np.interp(np.log(sigmas), np.log(train_sigmas),
                              np.arange(n, dtype=np.float64))
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    init_noise_sigma = float(np.sqrt(sigmas.max() ** 2 + 1))
    return Schedule(timesteps=timesteps.astype(np.float32), sigmas=sigmas,
                    init_noise_sigma=init_noise_sigma)


def scale_model_input(sample: torch.Tensor, sigma: float) -> torch.Tensor:
    """Euler pre-scaling: sample / sqrt(sigma^2 + 1)."""
    denom = np.sqrt(np.float32(sigma) ** 2 + np.float32(1.0))
    return (sample.float() / float(denom)).to(sample.dtype)


def v_to_eps(sample: torch.Tensor, v: torch.Tensor, sigma: float) -> torch.Tensor:
    """eps for a v-prediction output ``v`` at the unscaled ``sample`` and
    ``sigma``: eps = x sigma / (sigma^2 + 1) + v / sqrt(sigma^2 + 1), the
    map of diffusers' pred_x0 = x / (sigma^2 + 1) - v sigma / sqrt(sigma^2 +
    1) with eps = (x - pred_x0) / sigma, written without the division by
    sigma. The two scalars are float32 host constants; the arithmetic is in
    float32, rounded to the sample's dtype."""
    s = np.float32(sigma)
    var = s * s + np.float32(1.0)
    c_x, c_v = s / var, np.float32(1.0) / np.sqrt(var)
    return (sample.float() * float(c_x) + v.float() * float(c_v)).to(sample.dtype)


def euler_step(sample: torch.Tensor, eps: torch.Tensor, sigma: float,
               sigma_next: float) -> torch.Tensor:
    """One Euler step under epsilon prediction: sample + eps * (sigma_next - sigma)."""
    dt = np.float32(sigma_next) - np.float32(sigma)
    return (sample + eps.float() * float(dt)).to(sample.dtype)


def ancestral_sigmas(sigma: float, sigma_next: float) -> tuple[np.float32, np.float32]:
    """(sigma_down, sigma_up) of an ancestral step (k-diffusion
    ``get_ancestral_step``, eta=1), in float32: the deterministic part steps
    to sigma_down and fresh noise at sigma_up restores the marginal at
    sigma_next (sigma_down^2 + sigma_up^2 == sigma_next^2)."""
    s, sn = np.float32(sigma), np.float32(sigma_next)
    zero = np.float32(0.0)
    var_up = sn * sn * (s * s - sn * sn) / np.maximum(s * s, np.float32(1e-20))
    sigma_up = np.sqrt(np.maximum(var_up, zero))
    sigma_down = np.sqrt(np.maximum(sn * sn - sigma_up * sigma_up, zero))
    return sigma_down, sigma_up


def euler_ancestral_step(sample: torch.Tensor, eps: torch.Tensor, sigma: float,
                         sigma_next: float, noise: torch.Tensor) -> torch.Tensor:
    """One Euler-Ancestral step (epsilon prediction, eta=1): the Euler step
    to sigma_down, then fresh gaussian ``noise`` scaled by sigma_up. At
    ``sigma_next == 0`` both vanish and the step lands on pred_x0."""
    sigma_down, sigma_up = ancestral_sigmas(sigma, sigma_next)
    x = sample.float() + eps.float() * float(sigma_down - np.float32(sigma))
    x = x + noise.float() * float(sigma_up)
    return x.to(sample.dtype)


def heun_step(sample: torch.Tensor, eps: torch.Tensor, eps_next: torch.Tensor | None,
              sigma: float, sigma_next: float) -> torch.Tensor:
    """One Heun (2nd order) step under epsilon prediction: ``eps`` is the
    derivative at sigma, ``eps_next`` the one at the Euler proposal at
    sigma_next (k-diffusion ``sample_heun``). At ``sigma_next == 0`` the
    trapezoid is skipped and the step is the Euler step (pred_x0), so
    ``eps_next`` is not read there and may be None."""
    if np.float32(sigma_next) == 0:
        return euler_step(sample, eps, sigma, sigma_next)
    dt = float(np.float32(sigma_next) - np.float32(sigma))
    x = sample.float() + 0.5 * (eps.float() + eps_next.float()) * dt
    return x.to(sample.dtype)


def dpmpp_2m_coefficients(sigma: float, sigma_next: float, sigma_prev: float
                          ) -> tuple[np.float32, ...]:
    """DPM-Solver++(2M)'s scalars in float32, as JAX's ``dpmpp_2m_step``
    computes them, with its floors (1e-10 on each sigma, on h and on r0):
    (s_next / s_cur, expm1(-h), 1 + 1 / (2 r0), 1 / (2 r0)), where
    lambda(s) = -log(s), h = lambda(s_next) - lambda(s_cur) and
    r0 = (lambda(s_cur) - lambda(s_prev)) / h."""
    floor = np.float32(1e-10)
    s_cur, s_next, s_prev = (np.maximum(np.float32(v), floor)
                             for v in (sigma, sigma_next, sigma_prev))
    h = -np.log(s_next) - -np.log(s_cur)
    h_prev = -np.log(s_cur) - -np.log(s_prev)
    r0 = h_prev / np.maximum(h, floor)
    half_r = np.float32(1.0) / (np.float32(2.0) * np.maximum(r0, floor))
    return s_next / s_cur, np.expm1(-h), np.float32(1.0) + half_r, half_r


def dpmpp_2m_step(sample: torch.Tensor, eps: torch.Tensor, sigma: float, sigma_next: float,
                  prev_x0: torch.Tensor, have_prev: bool, sigma_prev: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One DPM-Solver++(2M) step (epsilon prediction, deterministic), the
    k-diffusion ``sample_dpmpp_2m`` update in sigma-space:

        x' = (s_next / s_cur) * x - expm1(-h) * D

    with D = pred_x0 on the first step (``have_prev`` False) and the 2M
    extrapolation of this and the previous pred_x0 (``prev_x0``, float32)
    after. At ``sigma_next == 0`` it is pred_x0. Returns (new sample,
    pred_x0 in float32), the multistep state of the next step."""
    x = sample.float()
    x0 = x - eps.float() * float(np.float32(sigma))
    if np.float32(sigma_next) == 0:
        return x0.to(sample.dtype), x0
    ratio, expm1_h, c_cur, c_prev = dpmpp_2m_coefficients(sigma, sigma_next, sigma_prev)
    d = x0 * float(c_cur) - prev_x0 * float(c_prev) if have_prev else x0
    return (x * float(ratio) - d * float(expm1_h)).to(sample.dtype), x0
