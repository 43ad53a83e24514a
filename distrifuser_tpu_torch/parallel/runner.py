"""The denoising loop: one device, or one rank of displaced patch parallelism.

Counterpart of distrifuser_tpu/parallel/runner.py (``_check_geometry``,
``DenoiseRunner._unet_local``, ``_make_step``, ``_device_loop``,
``generate``, ``comm_volume_report``, ``make_runner``).  The JAX package
compiles the whole loop into one program; here it is an eager Python loop,
the same on every rank:

* every rank holds the whole latent, runs the replicated scheduler in
  float32 and computes the text KV of every cross-attention once per
  generation;
* at one rank (or a CFG split with one patch per branch) the UNet runs
  dense (``DenseDispatch``);
* under displaced patch parallelism it runs on this rank's rows
  (``PatchDispatch``): steps 0..``warmup_steps`` are synchronous (fresh
  activations, blocking exchanges) and seed the per-layer buffers; the
  steps after them are stale (``mode``): each layer uses the previous
  step's peer activations and refreshes them asynchronously.
  ``full_sync`` runs every step synchronously.  The rows are gathered over
  the ``batch_group`` after every step;
* the CFG branches fold into the batch, or under ``cfg_split`` each rank
  runs its branch and the guided output gathers them over the
  ``split_group``.

CUDA graphs and the stepwise carry API are ROADMAP queue 1 items 7c and 11.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.unet import (DenseDispatch, PatchDispatch, UNetConfig,
                           precompute_text_kv, unet_forward)
from ..schedulers import BaseScheduler
from ..utils.config import DistriConfig
from .collectives import gather_rows
from .context import PHASE_STALE, PHASE_SYNC, PatchContext
from .guidance import branch_select, combine_guidance


def _check_geometry(cfg: DistriConfig, ucfg: UNetConfig) -> None:
    """Row patches must stay whole rows down to the deepest UNet level."""
    if not cfg.is_sp:
        return
    depth = len(ucfg.block_out_channels) - 1  # number of downsamples
    n = cfg.n_device_per_batch
    if cfg.latent_height % (n * (1 << depth)):
        raise ValueError(
            f"latent height {cfg.latent_height} must be divisible by "
            f"n_devices*2^depth = {n * (1 << depth)} for row patching"
        )


class DenoiseRunner:
    """Runs the denoising loop for one (config, UNet, scheduler).

    After ``generate``, ``phase_counts`` holds how many steps ran in each
    phase and ``comm_volume_report()`` the elements of this rank's
    per-layer buffers."""

    def __init__(self, distri_config: DistriConfig, unet_config: UNetConfig,
                 params, scheduler: BaseScheduler):
        if distri_config.parallelism == "pipefusion":
            raise ValueError(
                "pipefusion is a DiT strategy; the UNet's heterogeneous stages "
                "cannot pipeline — use parallelism='patch' here"
            )
        _check_geometry(distri_config, unet_config)
        self.cfg = distri_config
        self.ucfg = unet_config
        self.params = params
        self.scheduler = scheduler
        self.phase_counts: Dict[str, int] = {}
        self._buffer_kinds: Dict[str, str] = {}
        self._buffer_numel: Dict[str, int] = {}

    def _unet_local(self, x_in, t, my_enc, my_added, text_kv, phase, state):
        """One UNet evaluation on this rank: (the whole output of this
        rank's branch batch, the next step's buffers)."""
        cfg = self.cfg
        if not cfg.is_sp:
            out = unet_forward(self.params, self.ucfg, x_in, t, my_enc,
                               dispatch=DenseDispatch(text_kv=text_kv),
                               added_cond=my_added)
            return out, state
        ctx = PatchContext(n=cfg.n_device_per_batch, mode=cfg.mode, phase=phase,
                           group=cfg.batch_group, split_idx=cfg.split_idx(),
                           state_in=state, text_kv=text_kv)
        out_local = unet_forward(self.params, self.ucfg, x_in, t, my_enc,
                                 dispatch=PatchDispatch(ctx), added_cond=my_added)
        state = ctx.finish()
        if phase == PHASE_SYNC:
            self._buffer_kinds = dict(ctx.kinds)
            self._buffer_numel = {k: v.numel() for k, v in state.items()}
        return gather_rows(out_local, cfg.batch_group), state

    def _step(self, i, x, sstate, state, my_enc, my_added, text_kv, gs, phase):
        cfg, sched = self.cfg, self.scheduler
        batch = x.shape[0]
        t = sched.timesteps()[i].to(x.device)
        x_in = sched.scale_model_input(x, i)
        if cfg.do_classifier_free_guidance and not cfg.cfg_split:
            x_in = torch.cat([x_in, x_in], dim=0)
        out, state = self._unet_local(x_in, t, my_enc, my_added, text_kv, phase, state)
        guided = combine_guidance(cfg, out, gs, batch)
        x, sstate = sched.step(x, guided.float(), i, sstate)
        return x, sstate, state

    def _sync_steps(self, num_inference_steps: int) -> int:
        """How many leading steps run synchronously: all of them at one
        patch or under ``full_sync``, else steps 0..warmup_steps (the
        reference counts ``counter <= warmup_steps`` as synchronous)."""
        cfg = self.cfg
        if not cfg.is_sp or cfg.mode == "full_sync":
            return num_inference_steps
        return min(cfg.warmup_steps + 1, num_inference_steps)

    @torch.inference_mode()
    def generate(self, latents, prompt_embeds, *, guidance_scale: float = 5.0,
                 num_inference_steps: int = 50,
                 added_cond: Optional[Dict[str, Any]] = None, callback=None):
        """Run the loop.  ``latents``: [B, H/8, W/8, C] initial noise already
        scaled by ``scheduler.init_noise_sigma``; ``prompt_embeds``:
        [n_branches, B, L, C], branch 0 unconditional; every rank passes the
        same.  ``callback(i, t, x)`` runs after every step.  Returns the
        denoised latent, float32, the same on every rank."""
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
        n_sync = self._sync_steps(num_inference_steps)
        self.phase_counts = {PHASE_SYNC: 0, PHASE_STALE: 0}
        state = None
        for i in range(num_inference_steps):
            phase = PHASE_SYNC if i < n_sync else PHASE_STALE
            x, sstate, state = self._step(i, x, sstate, state, my_enc, my_added,
                                          text_kv, gs, phase)
            self.phase_counts[phase] += 1
            if callback is not None:
                callback(i, self.scheduler.timesteps()[i], x)
        return x

    def comm_volume_report(self) -> Dict[str, int]:
        """Elements of this rank's per-layer stale buffers by layer kind
        ("conv2d" halos, "attn" gathered KV, "gn" gathered moments), as the
        JAX package's ``comm_volume_report`` counts them; read from the
        buffers the last ``generate`` seeded.  Empty when the image is not
        split."""
        if not self.cfg.is_sp:
            return {}
        if not self._buffer_numel:
            raise RuntimeError("comm_volume_report reads the buffers of the last "
                               "generate(); call generate() first")
        report: Dict[str, int] = {}
        for name, numel in self._buffer_numel.items():
            kind = self._buffer_kinds[name]
            report[kind] = report.get(kind, 0) + numel
        return report


def make_runner(distri_config: DistriConfig, unet_config: UNetConfig, params,
                scheduler: BaseScheduler) -> DenoiseRunner:
    """The runner for ``distri_config.parallelism``: at one rank every
    parallelism runs the dense UNet; across ranks the config admits only
    displaced patch parallelism."""
    return DenoiseRunner(distri_config, unet_config, params, scheduler)
