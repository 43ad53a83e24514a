"""Displaced patch parallelism for the DiT: DistriFusion's method on
PixArt-α's transformer, one rank of it (or one device).

Counterpart of distrifuser_tpu/parallel/dit_sp.py (``DiTDenoiseRunner``
with ``attn_impl`` "gather" and "ring", its ``comm_report`` and
``generate``).  LayerNorm, the MLP and the caption cross-attention act per
token, so the self-attention is the only op that crosses patches: each
rank holds a contiguous range of N/n tokens (a horizontal band of the
image) and exchanges only the blocks' self-attention KV.

* Synchronous steps (the first ``warmup_steps + 1``, or every step under
  ``full_sync`` or without patches): "gather" all-gathers every block's
  fresh KV over the patch group and attends over it, exactly; "ring"
  streams the peers' fresh chunks through ops/ring_attention.py.
* Stale steps: "gather" attends over the previous step's gathered KV with
  this rank's slot overwritten fresh and issues the all-gather of its
  fresh KV asynchronously, which the next step consumes
  (ops/attention.py ``displaced_kv``); "ring" rotates each peer's
  previous-step chunk from the block's buffer, and the next buffer is the
  own fresh chunk, so it has no refresh collective.  ``no_sync`` keeps the
  warmup's buffers for good.  The buffers are a dict keyed by block
  (``blocks.<i>``) that parallel/context.py's ``PatchContext`` hands from
  step to step, as the UNet runner's.
* After the blocks, ``final_layer``'s rows all-gather over the patch group
  into the whole epsilon; the CFG branches fold into the batch or split
  over ranks (parallel/guidance.py); under ``dp_degree`` each image group
  evaluates its share of the batch and the guided outputs gather before
  the replicated float32 scheduler step, as the UNet runner does.

Under ``use_cuda_graph`` each phase's evaluation is captured once and
replayed (parallel/graphs.py): the token input, timestep and step are
copied into the graph's static inputs before each replay, the caption KV
and mask once per generation, and the stale graph's buffers are copied
back after each replay.

The knobs of later work raise ``NotImplementedError`` naming their ROADMAP
item: the DiT's step cache, ``comm_compress`` and ``refresh_fraction`` < 1
(item 13b'), ulysses and usp (13c, refused by ``DistriConfig``) and
PipeFusion (13d).  What the JAX runner refuses (``comm_batch``, a token
count the patch count does not divide, an image size other than the
config's) the port refuses with the same exception type.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..models import dit as dit_mod
from ..models.dit import DiTConfig
from ..ops.attention import displaced_kv
from ..ops.ring_attention import ring_attend
from ..schedulers import BaseScheduler
from ..utils.config import DistriConfig
from .collectives import gather_rows
from .context import PHASE_STALE, PHASE_SYNC, PatchContext
from .graphs import StepGraphs
from .guidance import branch_select
from .runner import StepLoop, check_graph_transport


def check_dit_config(cfg: DistriConfig, dcfg: DiTConfig) -> None:
    """The JAX runner's refusals (ValueError), then the knobs of later
    ROADMAP items (NotImplementedError)."""
    if cfg.comm_batch:
        raise ValueError("comm_batch applies to the UNet's per-layer halo/moment "
                         "exchanges; the DiT path has one collective kind already")
    if cfg.comm_compress != "none" and cfg.attn_impl != "gather":
        raise ValueError(
            f"comm_compress compresses the displaced KV refresh gathers of "
            f"attn_impl='gather'; {cfg.attn_impl!r} has no refresh collective to "
            "compress (ring carries the local chunk)")
    if cfg.refresh_fraction < 1.0 and cfg.attn_impl != "gather":
        raise ValueError(
            "refresh_fraction < 1 (PCPP) thins the displaced KV refresh gathers of "
            f"attn_impl='gather'; {cfg.attn_impl!r} has no refresh collective to thin")
    n = cfg.n_device_per_batch
    if dcfg.num_tokens % n:
        raise ValueError(f"token count {dcfg.num_tokens} must be divisible by the sp "
                         f"degree {n}")
    if cfg.step_cache_enabled and not 1 <= cfg.step_cache_depth < dcfg.depth:
        raise ValueError(
            f"step_cache_depth={cfg.step_cache_depth} must be in [1, {dcfg.depth - 1}] "
            f"for this {dcfg.depth}-block DiT (at least one block must stay shallow)")
    if cfg.height // 8 != dcfg.sample_size or cfg.width // 8 != dcfg.sample_size:
        raise ValueError(
            f"DistriConfig {cfg.height}x{cfg.width} implies latent {cfg.latent_height}, "
            f"but DiTConfig.sample_size is {dcfg.sample_size}")
    if cfg.parallelism == "pipefusion":
        raise NotImplementedError(
            "parallelism='pipefusion' (PipeFusion's patch pipeline over the DiT's "
            "blocks) is ROADMAP queue 1 item 13d; use parallelism='patch'")
    if cfg.parallelism != "patch":
        raise ValueError(f"the DiT runs displaced patch parallelism (parallelism="
                         f"'patch'), not {cfg.parallelism!r}")
    for on, knob in ((cfg.step_cache_enabled, "the DiT step cache (step_cache_interval/"
                      "step_cache_depth)"),
                     (cfg.comm_compress != "none", f"comm_compress={cfg.comm_compress!r}"),
                     (cfg.refresh_fraction < 1.0,
                      f"refresh_fraction={cfg.refresh_fraction}")):
        if on:
            raise NotImplementedError(
                f"{knob} on the DiT is ROADMAP queue 1 item 13b' (the DiT's step "
                "cache, refresh compression and partial refresh)")


class DiTDenoiseRunner(StepLoop):
    """The denoising loop of one (config, DiT, scheduler) on this rank.

    After ``generate``, ``phase_counts`` holds how many steps ran in each
    phase.  Replacing ``params`` drops the captured graphs."""

    def __init__(self, distri_config: DistriConfig, dit_config: DiTConfig, params,
                 scheduler: BaseScheduler):
        check_dit_config(distri_config, dit_config)
        check_graph_transport(distri_config)
        self.cfg = distri_config
        self.dcfg = dit_config
        self.scheduler = scheduler
        self.graphs = StepGraphs(distri_config.device)
        self.params = params
        self.phase_counts: Dict[str, int] = {}
        self._schedule: Dict[int, Any] = {}

    # -- one evaluation -----------------------------------------------------

    def _dit_local(self, x_in, t, cap_bias, cap_kv: List[torch.Tensor], phase, state):
        """One DiT evaluation on this rank's token rows of ``x_in`` [Bl, N,
        D] (scaled, the CFG branches folded): (the whole epsilon [Bl, N,
        D_out], the next step's buffers)."""
        cfg, dcfg, params = self.cfg, self.dcfg, self.params
        dtype = params["proj_in"]["kernel"].dtype
        n = cfg.n_device_per_batch if cfg.is_sp else 1
        chunk = dcfg.num_tokens // n
        offset = (cfg.split_idx() if n > 1 else 0) * chunk
        rows = x_in[:, offset:offset + chunk].to(dtype)
        pos = dit_mod.pos_embed_table(dcfg, dtype, x_in.device)[offset:offset + chunk]
        h = dit_mod.embed_tokens(params, dcfg, rows, pos)
        temb = dit_mod.t_embed(params, dcfg, t)
        c6 = dit_mod.adaln_table(params, dcfg, temb)
        if n == 1:
            for bp, kv in zip(params["blocks"], cap_kv):
                h, _ = dit_mod.dit_block(bp, dcfg, h, c6, kv, cap_bias=cap_bias)
            return dit_mod.final_layer(params, dcfg, h, temb), state
        ctx = PatchContext(n=n, mode=cfg.mode, phase=phase, group=cfg.batch_group,
                           split_idx=cfg.split_idx(), attn_impl=cfg.attn_impl,
                           state_in=state)
        heads = dcfg.num_heads
        for i, (bp, kv) in enumerate(zip(params["blocks"], cap_kv)):
            name = f"blocks.{i}"
            if cfg.attn_impl == "ring":
                hook = {"attn_core": lambda q, kv_, name=name: ring_attend(
                    q, kv_, ctx, name, heads=heads)}
            else:
                hook = {"kv_assemble": lambda kv_, name=name: displaced_kv(kv_, ctx, name)}
            h, _ = dit_mod.dit_block(bp, dcfg, h, c6, kv, cap_bias=cap_bias, **hook)
        eps_rows = dit_mod.final_layer(params, dcfg, h, temb)
        state = ctx.finish()
        return gather_rows(eps_rows, cfg.batch_group), state

    def _evaluate(self, phase, inputs, state):
        """``_dit_local`` on a graph's static inputs (``enc`` holds the
        caption bias, ``text_kv`` the blocks' caption KV)."""
        return self._dit_local(inputs.x_in, inputs.t, inputs.enc, inputs.text_kv,
                               phase, state)

    # -- the loop -----------------------------------------------------------

    def _phases(self, num_steps: int) -> List[str]:
        """Each step's evaluation: the first ``warmup_steps + 1`` synchronous,
        the rest stale; every step synchronous under ``full_sync`` or without
        patches."""
        cfg = self.cfg
        if cfg.mode == "full_sync" or not cfg.is_sp:
            return [PHASE_SYNC] * num_steps
        n_sync = min(cfg.warmup_steps + 1, num_steps)
        return [PHASE_SYNC] * n_sync + [PHASE_STALE] * (num_steps - n_sync)

    def _conditioning(self, enc, cap_mask):
        """(this rank's caption bias [Bl, 1, 1, Lt], the blocks' caption KV)
        from branch-major ``enc`` [n_br, B, Lt, caption_dim] and
        ``cap_mask`` [n_br, B, Lt] (None: every token real)."""
        cfg = self.cfg
        dev = cfg.device
        enc = torch.as_tensor(enc).to(dev)
        mask = (torch.ones(enc.shape[:3], device=dev) if cap_mask is None
                else torch.as_tensor(cap_mask).to(dev).float())
        my_enc, _, _ = branch_select(cfg, self._my_images(enc, dim=1))
        my_mask, _, _ = branch_select(cfg, self._my_images(mask, dim=1))
        cap_kv = dit_mod.precompute_caption_kv(self.params, self.dcfg, my_enc)
        return dit_mod.caption_mask_bias(my_mask), cap_kv

    def _begin_graphs(self, x, cap_bias, cap_kv, phases) -> None:
        check_graph_transport(self.cfg)
        timesteps, steps = self._step_tensors(self.scheduler.num_inference_steps)
        stateful = [PHASE_STALE] if PHASE_STALE in phases else []
        self.graphs.begin(tuple(x.shape), self._model_input(x, 0), timesteps[0], cap_bias,
                          None, cap_kv, list(dict.fromkeys(phases)), stateful,
                          self._evaluate, step=steps[0])

    def _inputs(self, latents, enc, cap_mask):
        """(the latent's tokens float32 [B, N, D], caption bias, caption KV)."""
        dev = self.cfg.device
        x = dit_mod.patchify(self.dcfg, torch.as_tensor(latents).to(dev, torch.float32))
        return x, *self._conditioning(enc, cap_mask)

    @torch.inference_mode()
    def prepare(self, latents, enc, *, num_inference_steps: int = 20,
                cap_mask=None) -> None:
        """Capture, ahead of the first call, the graphs a generation of these
        shapes and ``num_inference_steps`` steps replays; the input values do
        not matter.  Nothing to do without ``use_cuda_graph``."""
        if not self.cfg.use_compiled_step:
            return
        self.scheduler.set_timesteps(num_inference_steps)
        x, cap_bias, cap_kv = self._inputs(latents, enc, cap_mask)
        self._begin_graphs(x, cap_bias, cap_kv, self._phases(num_inference_steps))

    @torch.inference_mode()
    def generate(self, latents, enc, guidance_scale: float = 5.0,
                 num_inference_steps: int = 20, cap_mask=None, callback=None):
        """Run the loop: ``latents`` [B, H/8, W/8, C] initial noise (scaled by
        ``init_noise_sigma``), ``enc`` [n_branches, B, Lt, caption_dim]
        branch 0 unconditional, ``cap_mask`` [n_branches, B, Lt] (1 = real
        caption token; None attends to all); every rank passes the same.
        ``callback(i, t, latents)`` runs after every step.  Returns the
        latent float32 [B, H/8, W/8, C], the same on every rank."""
        cfg, dcfg, sched = self.cfg, self.dcfg, self.scheduler
        sched.set_timesteps(num_inference_steps)
        x, cap_bias, cap_kv = self._inputs(latents, enc, cap_mask)
        gs = torch.tensor(guidance_scale, dtype=torch.float32, device=cfg.device)
        phases = self._phases(num_inference_steps)
        graphed = cfg.use_compiled_step
        if graphed:
            self._begin_graphs(x, cap_bias, cap_kv, phases)
        timesteps, steps = self._step_tensors(num_inference_steps)
        sstate = sched.init_state(x.shape)
        self.phase_counts = {PHASE_SYNC: 0, PHASE_STALE: 0}
        state = None
        for i, phase in enumerate(phases):
            x_in = self._model_input(x, i)
            if graphed:
                graph = self.graphs[phase]
                graph.inputs.set_step(x_in, timesteps[i], steps[i])
                if graph.stateful:
                    graph.load_state(state)
                eps, state = graph.replay(self._evaluate)
            else:
                eps, state = self._dit_local(x_in, timesteps[i], cap_bias, cap_kv, phase,
                                             state)
            x, sstate = self._guided_step(x, eps, i, sstate, gs)
            self.phase_counts[phase] += 1
            if callback is not None:
                callback(i, sched.timesteps()[i],
                         dit_mod.unpatchify(dcfg, x, dcfg.in_channels))
        return dit_mod.unpatchify(dcfg, x, dcfg.in_channels)

    def comm_report(self, batch_size: int = 1) -> Dict[str, Any]:
        """This rank's stale-state elements and per-step collective volumes
        of the configured layout, closed-form from the architecture, as the
        JAX runner's ``comm_report`` gives them (the same keys and numbers;
        the knobs of item 13b' are refused, so compressed and partial
        refreshes never appear)."""
        cfg, dcfg = self.cfg, self.dcfg
        if not cfg.is_sp:
            return {"layout": cfg.attn_impl, "kv_state_elems": 0,
                    "per_step_collective_elems": 0, "per_step_collective_bytes": 0,
                    "sync_step_collective_bytes": 0}
        n = cfg.n_device_per_batch
        b = batch_size * (1 if cfg.cfg_split or not cfg.do_classifier_free_guidance else 2)
        n_tok, hid, depth = dcfg.num_tokens, dcfg.hidden_size, dcfg.depth
        chunk = n_tok // n
        eps_gather = b * n_tok * dcfg.patch_size ** 2 * dcfg.out_channels
        if cfg.attn_impl == "gather":
            state = depth * 2 * b * n_tok * hid
            per_step = depth * 2 * b * n_tok * hid + eps_gather
        else:  # ring: (n - 1) hops of the own 2C chunk a block, in the step
            state = depth * b * chunk * 2 * hid
            per_step = depth * (n - 1) * b * chunk * 2 * hid + eps_gather
        itemsize = cfg.dtype.itemsize
        if cfg.attn_impl == "gather":
            refresh = depth * n * 2 * b * chunk * hid * itemsize
            stale_bytes = refresh + eps_gather * itemsize
        else:
            stale_bytes = per_step * itemsize
        return {"layout": cfg.attn_impl, "kv_state_elems": state,
                "per_step_collective_elems": per_step,
                "comm_compress": cfg.comm_compress,
                "refresh_fraction": cfg.refresh_fraction,
                "sync_step_collective_bytes": per_step * itemsize,
                "per_step_collective_bytes": stale_bytes,
                "full_refresh_per_step_collective_bytes": stale_bytes}
