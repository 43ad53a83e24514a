"""DDIM for the PyTorch port.

Counterpart of distrifuser_tpu/schedulers/scheduling.py (``BaseScheduler``,
``DDIMScheduler``, ``get_scheduler``).  Numerics follow diffusers 0.24 with
the SD/SDXL defaults: scaled_linear betas in [0.00085, 0.012], 1000 train
steps, epsilon or v prediction, "leading" spacing, steps_offset=1.  The
coefficient tables are computed in numpy at ``set_timesteps`` and held as
float32 tensors, so ``step`` runs the same float32 arithmetic as the JAX
version.  Euler, DPM++ 2M and flow-Euler are ROADMAP queue 1 item 2.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch


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
        a_t = self._alpha_t[step_index].to(dev)
        a_prev = self._alpha_prev[step_index].to(dev)
        x = sample.float()
        eps = self._to_epsilon(sample, model_output.float(), a_t)
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        x_prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
        return x_prev.to(sample.dtype), state


SCHEDULERS = {"ddim": DDIMScheduler}


def get_scheduler(name: str, **kwargs) -> BaseScheduler:
    if name not in SCHEDULERS:
        raise ValueError(
            f"scheduler must be one of {sorted(SCHEDULERS)} in the PyTorch port "
            f"(others are ROADMAP queue 1 item 2), got {name!r}"
        )
    return SCHEDULERS[name](**kwargs)
