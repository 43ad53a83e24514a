"""DDIM, Euler, DPM-Solver++ (2M) and the rectified-flow Euler sampler for
the PyTorch port.

Counterpart of distrifuser_tpu/schedulers/scheduling.py (``_per_row``,
``BaseScheduler``, ``DDIMScheduler``, ``EulerDiscreteScheduler``,
``DPMSolverMultistepScheduler``, ``FlowMatchEulerScheduler``,
``get_scheduler``): the reference CLI's ``--scheduler {ddim,euler,
dpm-solver}`` and the SD3 family's ``flow-euler``.  Numerics follow diffusers 0.24
with the SD/SDXL defaults: scaled_linear betas in [0.00085, 0.012], 1000
train steps, epsilon or v prediction, "leading" spacing, steps_offset=1.
The coefficient tables are computed in numpy at ``set_timesteps`` and held
as float32 tensors, so ``step`` runs the same float32 arithmetic as the
JAX version.  DPM++ 2M carries the previous step's x0 and lambda in the
state ``init_state`` returns.  ``add_noise`` is the img2img entry: a clean
latent noised to the schedule point of a step, in alphas_cumprod space
(DDIM, DPM++ 2M) or in Euler's sigma space, ``x0 + sigma * eps``, which is
not scaled again by ``init_noise_sigma``.  The schedulers run eagerly, outside any
captured UNet graph: Euler's ``scale_model_input`` is applied to the
latent before it is copied into the graph's static input.
``FlowMatchEulerScheduler`` ("flow-euler") integrates a rectified-flow
velocity over shifted sigmas (the SD3 family, ``prediction_type ==
"flow"``); its ``add_noise`` is the flow interpolant.

``step`` and ``scale_model_input`` take a scalar ``step_index`` or, for
the packed cohort step of the serve plane (serve/executors.py
``step_run``), a sequence or 1-D tensor of one index per batch row.  A
row's coefficients are then computed exactly as the scalar path computes
them for its own index, stacked into a ``[B, 1, ..., 1]`` tensor, and
applied by the same elementwise operation, so each row of a packed step is
bit for bit the row of its solo step.  Where the scalar path divides a
CUDA tensor by a CPU scalar (which PyTorch carries out as a multiplication
by the scalar's float32 reciprocal), the per-row path multiplies by the
rows' reciprocals on the card and divides on the CPU, as the scalar path
does there.  DPM++ 2M's per-row state holds one ``lambda_prev`` a row.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch


def _per_row(coef, ref):
    """A coefficient shaped against a batch-major sample: a scalar as it
    is, a ``[B]`` vector as ``[B, 1, ..., 1]`` so that row j takes its own
    coefficient."""
    coef = torch.as_tensor(coef)
    if coef.dim() == 0:
        return coef
    return coef.reshape(coef.shape + (1,) * (ref.dim() - 1))


def _rows(step_index):
    """The per-row step indices of a packed step (a list of ints), or
    None for a scalar index."""
    if isinstance(step_index, (list, tuple)):
        return [int(i) for i in step_index]
    if isinstance(step_index, torch.Tensor) and step_index.dim() > 0:
        return [int(i) for i in step_index.tolist()]
    return None


def _stack_rows(fn, rows, ref):
    """``[B, 1, ..., 1]`` on the CPU of ``fn(i)`` (a 0-dim tensor, the
    scalar path's own arithmetic) for each row's index ``i``."""
    return _per_row(torch.stack([torch.as_tensor(fn(i)) for i in rows]), ref)


def _div_rows(x, coef):
    """``x / coef`` for a per-row CPU ``coef`` as the scalar path divides
    by a CPU scalar: on the card a multiplication by the float32
    reciprocal (PyTorch's CUDA division by a CPU scalar), on the CPU a
    true division."""
    if x.is_cuda:
        return x * (1.0 / coef).to(x.device)
    return x / coef


def _make_alphas_cumprod(
    num_train_timesteps: int, beta_start: float, beta_end: float, beta_schedule: str
) -> np.ndarray:
    if beta_schedule == "scaled_linear":
        betas = (
            np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps) ** 2
        )
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps)
    else:
        raise ValueError(f"unsupported beta_schedule {beta_schedule!r}")
    return np.cumprod(1.0 - betas, axis=0)


def _leading_timesteps(num_train_timesteps: int, n: int, steps_offset: int) -> np.ndarray:
    step_ratio = num_train_timesteps // n
    return (np.arange(n) * step_ratio).round()[::-1].astype(np.int64) + steps_offset


@dataclasses.dataclass
class BaseScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    prediction_type: str = "epsilon"

    def __post_init__(self):
        if self.prediction_type not in ("epsilon", "v_prediction"):
            raise NotImplementedError(
                "prediction_type must be 'epsilon' or 'v_prediction'"
            )
        self._alphas_cumprod = _make_alphas_cumprod(
            self.num_train_timesteps, self.beta_start, self.beta_end, self.beta_schedule
        )
        self.num_inference_steps = None

    def _to_epsilon(self, sample, model_output, alpha_cumprod_t):
        """Model output as an epsilon prediction (v = alpha*eps - sigma*x0
        for v-prediction checkpoints)."""
        if self.prediction_type == "epsilon":
            return model_output
        a = torch.sqrt(alpha_cumprod_t)
        s = torch.sqrt(1.0 - alpha_cumprod_t)
        return a * model_output + s * sample.float()

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def scale_model_input(self, sample, step_index):
        return sample

    def init_state(self, latent_shape) -> Dict[str, Any]:
        return {}

    def timesteps(self) -> torch.Tensor:
        assert self.num_inference_steps is not None, "call set_timesteps first"
        return self._timesteps

    def add_noise(self, original, noise, step_index):
        """``original`` noised to the schedule point ``step_index``:
        sqrt(ac_t) x0 + sqrt(1 - ac_t) eps at t = timesteps()[step_index]
        (diffusers ``add_noise``), computed in float32."""
        t = int(self.timesteps()[step_index])
        ac = torch.tensor(self._alphas_cumprod[t], dtype=torch.float32,
                          device=original.device)
        out = torch.sqrt(ac) * original.float() + torch.sqrt(1.0 - ac) * noise.float()
        return out.to(original.dtype)

    def step(self, sample, model_output, step_index, state):
        raise NotImplementedError


class DDIMScheduler(BaseScheduler):
    """Deterministic DDIM (eta=0), set_alpha_to_one=False as for SD/SDXL."""

    def set_timesteps(self, n: int):
        self.num_inference_steps = n
        ts = _leading_timesteps(self.num_train_timesteps, n, self.steps_offset)
        prev_ts = ts - self.num_train_timesteps // n
        ac = self._alphas_cumprod
        final_alpha = ac[0]
        alpha_t = ac[ts]
        alpha_prev = np.where(prev_ts >= 0, ac[np.clip(prev_ts, 0, None)], final_alpha)
        self._timesteps = torch.from_numpy(ts.copy())
        self._alpha_t = torch.tensor(alpha_t, dtype=torch.float32)
        self._alpha_prev = torch.tensor(alpha_prev, dtype=torch.float32)
        return self

    def step(self, sample, model_output, step_index, state):
        dev = sample.device
        rows = _rows(step_index)
        if rows is None:
            a_t = self._alpha_t[step_index].to(dev)
            a_prev = self._alpha_prev[step_index].to(dev)
        else:
            a_t = _per_row(self._alpha_t[rows], sample).to(dev)
            a_prev = _per_row(self._alpha_prev[rows], sample).to(dev)
        x = sample.float()
        eps = self._to_epsilon(sample, model_output.float(), a_t)
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        x_prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
        return x_prev.to(sample.dtype), state


class EulerDiscreteScheduler(BaseScheduler):
    """diffusers EulerDiscreteScheduler (no churn): the latent lives in
    sigma space, x = x0 + sigma * eps."""

    def set_timesteps(self, n: int):
        self.num_inference_steps = n
        ts = _leading_timesteps(self.num_train_timesteps, n, self.steps_offset)
        ac = self._alphas_cumprod
        sigmas = (((1.0 - ac) / ac) ** 0.5)[ts]
        self._timesteps = torch.from_numpy(ts.copy())
        self._sigmas = torch.tensor(np.append(sigmas, 0.0), dtype=torch.float32)
        self._init_noise_sigma = float((sigmas.max() ** 2 + 1) ** 0.5)
        return self

    @property
    def init_noise_sigma(self) -> float:
        return self._init_noise_sigma

    def scale_model_input(self, sample, step_index):
        rows = _rows(step_index)
        if rows is None:
            sigma = self._sigmas[step_index]
            return (sample / torch.sqrt(sigma**2 + 1.0)).to(sample.dtype)
        den = _stack_rows(lambda i: torch.sqrt(self._sigmas[i]**2 + 1.0), rows, sample)
        return _div_rows(sample, den).to(sample.dtype)

    def add_noise(self, original, noise, step_index):
        """Euler's sigma-space latent x = x0 + sigma * eps."""
        sigma = self._sigmas[step_index].to(original.device)
        return (original.float() + sigma * noise.float()).to(original.dtype)

    def step(self, sample, model_output, step_index, state):
        x = sample.float()
        rows = _rows(step_index)
        if rows is None:
            sigma, sigma_next = self._sigmas[step_index], self._sigmas[step_index + 1]
            ac_t = 1.0 / (sigma**2 + 1.0)  # alpha_cumprod of this sigma
            eps = self._to_epsilon(x * torch.sqrt(ac_t), model_output.float(), ac_t)
            x_next = x + (sigma_next - sigma) * eps
            return x_next.to(sample.dtype), state
        sig = self._sigmas
        dev = sample.device
        ac_t = _stack_rows(lambda i: 1.0 / (sig[i]**2 + 1.0), rows, x).to(dev)
        sq = _stack_rows(lambda i: torch.sqrt(1.0 / (sig[i]**2 + 1.0)), rows, x).to(dev)
        eps = self._to_epsilon(x * sq, model_output.float(), ac_t)
        dsig = _stack_rows(lambda i: sig[i + 1] - sig[i], rows, x).to(dev)
        x_next = x + dsig * eps
        return x_next.to(sample.dtype), state


class DPMSolverMultistepScheduler(BaseScheduler):
    """DPM-Solver++ 2M (diffusers algorithm_type="dpmsolver++",
    solver_order=2, lower_order_final): first order at the first step,
    which has no history, and at the last, where sigma reaches 0."""

    def set_timesteps(self, n: int):
        self.num_inference_steps = n
        ts = _leading_timesteps(self.num_train_timesteps, n, self.steps_offset)
        ac = self._alphas_cumprod
        alpha = np.sqrt(ac[ts])
        sigma = np.sqrt(1.0 - ac[ts])
        lam = np.log(alpha) - np.log(sigma)
        # past the last step: sigma 0, lambda +inf, and the update returns x0
        self._timesteps = torch.from_numpy(ts.copy())
        self._alpha = torch.tensor(np.append(alpha, 1.0), dtype=torch.float32)
        self._sigma = torch.tensor(np.append(sigma, 0.0), dtype=torch.float32)
        self._lambda = torch.tensor(np.append(lam, np.inf), dtype=torch.float32)
        return self

    def init_state(self, latent_shape) -> Dict[str, Any]:
        """The previous step's x0 and lambda; None before the first step."""
        return {"x0_prev": None, "lambda_prev": None}

    def step(self, sample, model_output, step_index, state):
        rows = _rows(step_index)
        if rows is not None:
            return self._step_rows(sample, model_output, rows, state)
        i = step_index
        a_t, s_t, lam_t = self._alpha[i], self._sigma[i], self._lambda[i]
        a_n, s_n, lam_n = self._alpha[i + 1], self._sigma[i + 1], self._lambda[i + 1]
        x = sample.float()
        eps = self._to_epsilon(sample, model_output.float(), a_t**2)
        x0 = (x - s_t * eps) / a_t
        h = lam_n - lam_t
        d = x0
        if state["x0_prev"] is not None and i < self.num_inference_steps - 1:
            r = torch.clamp((lam_t - state["lambda_prev"]) / torch.clamp(h, min=1e-12),
                            min=1e-12)
            d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * state["x0_prev"]
        # x_next = (s_n / s_t) x - a_n (e^-h - 1) D; at the last step s_n = 0
        # and h = inf, so it is a_n D = D
        x_next = (s_n / s_t) * x - a_n * torch.expm1(-h) * d
        return x_next.to(sample.dtype), {"x0_prev": x0, "lambda_prev": lam_t}

    def _step_rows(self, sample, model_output, rows, state):
        """``step`` with one index a row: every coefficient the scalar
        path's own 0-dim arithmetic for the row's index, the state's
        ``lambda_prev`` one entry a row (a 0-dim one serves every row).
        Rows whose state has no history, or at the last step, take the
        first-order update, as the scalar path does."""
        al, sg, lm = self._alpha, self._sigma, self._lambda
        dev = sample.device
        x = sample.float()
        col = lambda fn: _stack_rows(fn, rows, x)  # noqa: E731
        a_t = col(lambda i: al[i])
        eps = self._to_epsilon(sample, model_output.float(), (a_t**2).to(dev))
        x0 = _div_rows(x - col(lambda i: sg[i]).to(dev) * eps, a_t)
        d = x0
        if state["x0_prev"] is not None:
            lp = state["lambda_prev"]
            lp_of = (lambda r: lp) if lp.dim() == 0 else (lambda r: lp[r])

            def inv2r(r):
                i = rows[r]
                h = lm[i + 1] - lm[i]
                ratio = torch.clamp((lm[i] - lp_of(r)) / torch.clamp(h, min=1e-12),
                                    min=1e-12)
                return 1.0 / (2.0 * ratio)

            k = _stack_rows(inv2r, range(len(rows)), x)
            corr = (1.0 + k).to(dev) * x0 - k.to(dev) * state["x0_prev"]
            last = torch.tensor([i >= self.num_inference_steps - 1 for i in rows])
            d = torch.where(_per_row(last, x).to(dev), x0, corr)
        c_x = col(lambda i: sg[i + 1] / sg[i]).to(dev)
        c_d = col(lambda i: al[i + 1] * torch.expm1(-(lm[i + 1] - lm[i]))).to(dev)
        x_next = c_x * x - c_d * d
        lam = torch.stack([lm[i] for i in rows])
        return x_next.to(sample.dtype), {"x0_prev": x0, "lambda_prev": lam}


@dataclasses.dataclass
class FlowMatchEulerScheduler(BaseScheduler):
    """Euler sampler of rectified-flow models (the SD3 family): x_t = (1 -
    sigma) x0 + sigma noise, the model predicts the velocity noise - x0,
    and a step integrates dx = v dsigma from 1 towards 0 over the shifted
    grid sigma' = shift s / (1 + (shift - 1) s) (SD3-medium: shift 3).  The
    model's "timestep" is sigma * num_train_timesteps.  No beta tables and
    an empty state."""

    shift: float = 3.0

    def __post_init__(self):
        # one prediction convention; the inherited default is epsilon
        self.prediction_type = "flow"
        self.num_inference_steps = None

    def set_timesteps(self, n: int):
        self.num_inference_steps = n
        lin = np.linspace(1.0, 1.0 / n, n)
        sig = self.shift * lin / (1.0 + (self.shift - 1.0) * lin)
        self._sigmas = torch.tensor(np.append(sig, 0.0), dtype=torch.float32)
        self._timesteps = torch.tensor(sig * self.num_train_timesteps,
                                       dtype=torch.float32)
        return self

    def add_noise(self, original, noise, step_index):
        """The flow interpolant (1 - sigma) x0 + sigma noise at the step's
        sigma (img2img's entry; per row for a ``[B]`` step vector)."""
        s = _per_row(self._sigmas[step_index], original).to(original.device)
        out = (1.0 - s) * original.float() + s * noise.float()
        return out.to(original.dtype)

    def step(self, sample, model_output, step_index, state):
        """One Euler step of the velocity ``model_output``, in float32."""
        rows = _rows(step_index)
        if rows is not None:
            step_index = torch.tensor(rows)
        s = _per_row(self._sigmas[step_index], sample).to(sample.device)
        s_next = _per_row(self._sigmas[step_index + 1], sample).to(sample.device)
        x = sample.float() + (s_next - s) * model_output.float()
        return x.to(sample.dtype), state


SCHEDULERS = {"ddim": DDIMScheduler, "euler": EulerDiscreteScheduler,
              "dpm-solver": DPMSolverMultistepScheduler,
              "flow-euler": FlowMatchEulerScheduler}


def get_scheduler(name: str, **kwargs) -> BaseScheduler:
    """The scheduler of a CLI name (the reference's run_sdxl.py choices and
    the SD3 family's "flow-euler")."""
    if name not in SCHEDULERS:
        raise ValueError(f"scheduler must be one of {sorted(SCHEDULERS)}, got {name!r}")
    return SCHEDULERS[name](**kwargs)
