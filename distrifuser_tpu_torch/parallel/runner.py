"""The denoising loop, single device.

Counterpart of distrifuser_tpu/parallel/runner.py (``DenoiseRunner``,
``_make_step``, ``generate``, ``make_runner``).  At one device every
parallelism of the JAX package runs the dense UNet, so this runner is the
eager Python loop over one dense step: CFG branches folded into the batch,
the text KV of every cross-attention computed once per generation, the
guided output stepped by the scheduler in float32.  The patch path, CUDA
graphs and the stepwise carry API are ROADMAP queue 1 items 7 and 11.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.unet import DenseDispatch, UNetConfig, precompute_text_kv, unet_forward
from ..schedulers import BaseScheduler
from ..utils.config import DistriConfig
from .guidance import branch_select, combine_guidance


class DenoiseRunner:
    """Runs the denoising loop for one (config, UNet, scheduler)."""

    def __init__(self, distri_config: DistriConfig, unet_config: UNetConfig,
                 params, scheduler: BaseScheduler):
        if distri_config.parallelism == "pipefusion":
            raise ValueError(
                "pipefusion is a DiT strategy; the UNet's heterogeneous stages "
                "cannot pipeline — use parallelism='patch' here"
            )
        self.cfg = distri_config
        self.ucfg = unet_config
        self.params = params
        self.scheduler = scheduler

    def _make_step(self):
        sched = self.scheduler

        def step(i, x, sstate, my_enc, my_added, text_kv, gs):
            cfg = self.cfg
            batch = x.shape[0]
            t = sched.timesteps()[i].to(x.device)
            x_in = sched.scale_model_input(x, i)
            if cfg.do_classifier_free_guidance:
                x_in = torch.cat([x_in, x_in], dim=0)
            out = unet_forward(
                self.params, self.ucfg, x_in, t, my_enc,
                dispatch=DenseDispatch(text_kv=text_kv), added_cond=my_added,
            )
            guided = combine_guidance(cfg, out, gs, batch)
            return sched.step(x, guided.float(), i, sstate)

        return step

    @torch.inference_mode()
    def generate(self, latents, prompt_embeds, *, guidance_scale: float = 5.0,
                 num_inference_steps: int = 50,
                 added_cond: Optional[Dict[str, Any]] = None, callback=None):
        """Run the loop.  ``latents``: [B, H/8, W/8, C] initial noise already
        scaled by ``scheduler.init_noise_sigma``; ``prompt_embeds``:
        [n_branches, B, L, C], branch 0 unconditional.  ``callback(i, t, x)``
        runs after every step.  Returns the denoised latent, float32."""
        cfg = self.cfg
        dev = cfg.device
        self.scheduler.set_timesteps(num_inference_steps)
        prompt_embeds = torch.as_tensor(prompt_embeds).to(dev, cfg.dtype)
        added = None
        if added_cond is not None:
            added = {k: torch.as_tensor(v).to(dev) for k, v in added_cond.items()}
            if "text_embeds" in added:
                added["text_embeds"] = added["text_embeds"].to(cfg.dtype)
            if "time_ids" in added:
                added["time_ids"] = added["time_ids"].float()
        my_enc, my_added, _ = branch_select(cfg, prompt_embeds, added)
        text_kv = precompute_text_kv(self.params, my_enc)
        gs = torch.tensor(guidance_scale, dtype=torch.float32, device=dev)
        x = torch.as_tensor(latents).to(dev, torch.float32)
        sstate = self.scheduler.init_state(x.shape)
        step = self._make_step()
        for i in range(num_inference_steps):
            x, sstate = step(i, x, sstate, my_enc, my_added, text_kv, gs)
            if callback is not None:
                callback(i, self.scheduler.timesteps()[i], x)
        return x


def make_runner(distri_config: DistriConfig, unet_config: UNetConfig, params,
                scheduler: BaseScheduler) -> DenoiseRunner:
    """At one device every parallelism degenerates to the dense runner."""
    return DenoiseRunner(distri_config, unet_config, params, scheduler)
