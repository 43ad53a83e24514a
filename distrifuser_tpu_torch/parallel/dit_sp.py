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
item: the step cache, ``comm_compress`` and ``refresh_fraction`` < 1 (item
13b', the comm knobs of both transformer runners: this one and the MMDiT's
of parallel/mmdit_sp.py, ``refuse_transformer_knobs``), ulysses and usp
(13c, refused by ``DistriConfig``) and PipeFusion (13d).  What the JAX runner refuses (``comm_batch``, a token
count the patch count does not divide, an image size other than the
config's) the port refuses with the same exception type.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..models import dit as dit_mod
from ..models.dit import DiTConfig, unpatchify
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
    refuse_transformer_knobs(cfg, "DiT")


def refuse_transformer_knobs(cfg: DistriConfig, model: str) -> None:
    """The comm knobs that neither transformer runner (the DiT's, the
    MMDiT's) runs yet raise ``NotImplementedError`` naming ROADMAP item
    13b'."""
    for on, knob in ((cfg.step_cache_enabled, f"the {model} step cache "
                      "(step_cache_interval/step_cache_depth)"),
                     (cfg.comm_compress != "none", f"comm_compress={cfg.comm_compress!r}"),
                     (cfg.refresh_fraction < 1.0,
                      f"refresh_fraction={cfg.refresh_fraction}")):
        if on:
            raise NotImplementedError(
                f"{knob} on the {model} is ROADMAP queue 1 item 13b' (the comm knobs "
                "of both transformer runners, the DiT's and the MMDiT's: the step "
                "cache, refresh compression and partial refresh)")


class TransformerRunner(StepLoop):
    """The denoising loop both transformer runners share (the DiT's below,
    the MMDiT's of parallel/mmdit_sp.py): one model evaluation a step, the
    first ``warmup_steps + 1`` steps that run synchronous and the rest stale,
    each phase one CUDA graph under ``use_cuda_graph``, and ``comm_report``
    closed-form from the attention layers that exchange image KV.

    A subclass gives ``_local(x_in, t, cond, phase, state)``, one
    evaluation on this rank's token rows from its conditioning ``cond`` (the
    graphs' static ``enc``, ``added`` and ``text_kv``, None where unused),
    ``_inputs`` building the tokens and ``cond`` from its call's arguments,
    and ``n_attn``.  After ``generate``, ``phase_counts`` holds how many
    steps ran in each phase.  Replacing ``params`` drops the captured
    graphs."""

    def __init__(self, distri_config: DistriConfig, model_config, params,
                 scheduler: BaseScheduler):
        check_graph_transport(distri_config)
        self.cfg = distri_config
        self.mcfg = model_config
        self.scheduler = scheduler
        self.graphs = StepGraphs(distri_config.device)
        self.params = params
        self.phase_counts: Dict[str, int] = {}
        self._schedule: Dict[int, Any] = {}

    @property
    def n_attn(self) -> int:
        """Attention layers a step whose image KV crosses patches."""
        raise NotImplementedError

    def _evaluate(self, phase, inputs, state):
        """``_local`` on a graph's static inputs."""
        return self._local(inputs.x_in, inputs.t, (inputs.enc, inputs.added, inputs.text_kv),
                           phase, state)

    def _phases(self, end: int, start: int = 0) -> List[str]:
        """The evaluation of each step of ``start .. end - 1``: the first
        ``warmup_steps + 1`` run synchronous (counted from ``start``), the
        rest stale; every step synchronous under ``full_sync`` or without
        patches."""
        cfg = self.cfg
        n_exec = end - start
        if cfg.mode == "full_sync" or not cfg.is_sp:
            return [PHASE_SYNC] * n_exec
        n_sync = min(cfg.warmup_steps + 1, n_exec)
        return [PHASE_SYNC] * n_sync + [PHASE_STALE] * (n_exec - n_sync)

    def _begin_graphs(self, x, cond, phases, start=0) -> None:
        check_graph_transport(self.cfg)
        timesteps, steps = self._step_tensors(self.scheduler.num_inference_steps)
        stateful = [PHASE_STALE] if PHASE_STALE in phases else []
        self.graphs.begin(tuple(x.shape), self._model_input(x, start), timesteps[start],
                          *cond, list(dict.fromkeys(phases)), stateful, self._evaluate,
                          step=steps[start])

    def _prepare(self, num_inference_steps: int, *inputs) -> None:
        """``prepare`` of the subclass: capture, ahead of the first call, the
        graphs a generation of these shapes and ``num_inference_steps``
        steps replays from ``_inputs(*inputs)``; the input values do not
        matter.  Nothing to do without ``use_cuda_graph``."""
        if not self.cfg.use_compiled_step:
            return
        self.scheduler.set_timesteps(num_inference_steps)
        x, cond = self._inputs(*inputs)
        self._begin_graphs(x, cond, self._phases(num_inference_steps))

    def _generate(self, inputs, guidance_scale: float, num_inference_steps: int,
                  start_step: int = 0, end_step=None, callback=None):
        """Steps ``start_step .. end_step - 1`` of the schedule from
        ``_inputs(*inputs)``, ``callback(i, t, latents)`` after each: the
        latent float32 [B, H/8, W/8, C], the same on every rank."""
        cfg, mcfg, sched = self.cfg, self.mcfg, self.scheduler
        end = num_inference_steps if end_step is None else end_step
        if not 0 <= start_step < end <= num_inference_steps:
            raise ValueError(f"steps {start_step}..{end} outside a schedule of "
                             f"{num_inference_steps}")
        sched.set_timesteps(num_inference_steps)
        x, cond = self._inputs(*inputs)
        gs = torch.tensor(guidance_scale, dtype=torch.float32, device=cfg.device)
        phases = self._phases(end, start_step)
        graphed = cfg.use_compiled_step
        if graphed:
            self._begin_graphs(x, cond, phases, start_step)
        timesteps, steps = self._step_tensors(num_inference_steps)
        sstate = sched.init_state(x.shape)
        self.phase_counts = {PHASE_SYNC: 0, PHASE_STALE: 0}
        state = None
        for i, phase in enumerate(phases, start=start_step):
            x_in = self._model_input(x, i)
            if graphed:
                graph = self.graphs[phase]
                graph.inputs.set_step(x_in, timesteps[i], steps[i])
                if graph.stateful:
                    graph.load_state(state)
                out, state = graph.replay(self._evaluate)
            else:
                out, state = self._local(x_in, timesteps[i], cond, phase, state)
            x, sstate = self._guided_step(x, out, i, sstate, gs)
            self.phase_counts[phase] += 1
            if callback is not None:
                callback(i, sched.timesteps()[i], unpatchify(mcfg, x, mcfg.in_channels))
        return unpatchify(mcfg, x, mcfg.in_channels)

    def comm_report(self, batch_size: int = 1) -> Dict[str, Any]:
        """This rank's stale-state elements and per-step collective volumes
        of the configured layout, closed-form from the architecture, as the
        JAX runners' ``comm_report`` gives them (the same keys and numbers;
        the knobs of item 13b' are refused, so compressed and partial
        refreshes never appear)."""
        cfg, mcfg = self.cfg, self.mcfg
        if not cfg.is_sp:
            return {"layout": cfg.attn_impl, "kv_state_elems": 0,
                    "per_step_collective_elems": 0, "per_step_collective_bytes": 0,
                    "sync_step_collective_bytes": 0}
        n = cfg.n_device_per_batch
        b = batch_size * (1 if cfg.cfg_split or not cfg.do_classifier_free_guidance else 2)
        n_tok, hid, n_attn = mcfg.num_tokens, mcfg.hidden_size, self.n_attn
        chunk = n_tok // n
        out_gather = b * n_tok * mcfg.patch_size ** 2 * mcfg.out_channels
        if cfg.attn_impl == "gather":
            state = n_attn * 2 * b * n_tok * hid
            per_step = n_attn * 2 * b * n_tok * hid + out_gather
        else:  # ring: (n - 1) hops of the own 2C chunk a layer, in the step
            state = n_attn * b * chunk * 2 * hid
            per_step = n_attn * (n - 1) * b * chunk * 2 * hid + out_gather
        itemsize = cfg.dtype.itemsize
        if cfg.attn_impl == "gather":
            refresh = n_attn * n * 2 * b * chunk * hid * itemsize
            stale_bytes = refresh + out_gather * itemsize
        else:
            stale_bytes = per_step * itemsize
        return {"layout": cfg.attn_impl, "kv_state_elems": state,
                "per_step_collective_elems": per_step,
                "comm_compress": cfg.comm_compress,
                "refresh_fraction": cfg.refresh_fraction,
                "sync_step_collective_bytes": per_step * itemsize,
                "per_step_collective_bytes": stale_bytes,
                "full_refresh_per_step_collective_bytes": stale_bytes}


class DiTDenoiseRunner(TransformerRunner):
    """The denoising loop of one (config, DiT, scheduler) on this rank."""

    def __init__(self, distri_config: DistriConfig, dit_config: DiTConfig, params,
                 scheduler: BaseScheduler):
        check_dit_config(distri_config, dit_config)
        super().__init__(distri_config, dit_config, params, scheduler)

    @property
    def n_attn(self) -> int:
        return self.mcfg.depth

    def _local(self, x_in, t, cond, phase, state):
        """One DiT evaluation on this rank's token rows of ``x_in`` [Bl, N,
        D] (scaled, the CFG branches folded) from ``cond`` = (caption bias,
        None, the blocks' caption KV): (the whole epsilon [Bl, N, D_out],
        the next step's buffers)."""
        cfg, dcfg, params = self.cfg, self.mcfg, self.params
        cap_bias, _, cap_kv = cond
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

    def _inputs(self, latents, enc, cap_mask):
        """(the latent's tokens float32 [B, N, D], (this rank's caption bias
        [Bl, 1, 1, Lt], None, the blocks' caption KV)) from branch-major
        ``enc`` [n_br, B, Lt, caption_dim] and ``cap_mask`` [n_br, B, Lt]
        (None: every token real)."""
        cfg = self.cfg
        dev = cfg.device
        x = dit_mod.patchify(self.mcfg, torch.as_tensor(latents).to(dev, torch.float32))
        enc = torch.as_tensor(enc).to(dev)
        mask = (torch.ones(enc.shape[:3], device=dev) if cap_mask is None
                else torch.as_tensor(cap_mask).to(dev).float())
        my_enc, _, _ = branch_select(cfg, self._my_images(enc, dim=1))
        my_mask, _, _ = branch_select(cfg, self._my_images(mask, dim=1))
        cap_kv = dit_mod.precompute_caption_kv(self.params, self.mcfg, my_enc)
        return x, (dit_mod.caption_mask_bias(my_mask), None, cap_kv)

    @torch.inference_mode()
    def prepare(self, latents, enc, *, num_inference_steps: int = 20,
                cap_mask=None) -> None:
        """Capture, ahead of the first call, the graphs a generation of these
        shapes and ``num_inference_steps`` steps replays; the input values do
        not matter.  Nothing to do without ``use_cuda_graph``."""
        self._prepare(num_inference_steps, latents, enc, cap_mask)

    @torch.inference_mode()
    def generate(self, latents, enc, guidance_scale: float = 5.0,
                 num_inference_steps: int = 20, cap_mask=None, callback=None):
        """Run the loop: ``latents`` [B, H/8, W/8, C] initial noise (scaled by
        ``init_noise_sigma``), ``enc`` [n_branches, B, Lt, caption_dim]
        branch 0 unconditional, ``cap_mask`` [n_branches, B, Lt] (1 = real
        caption token; None attends to all); every rank passes the same.
        ``callback(i, t, latents)`` runs after every step.  Returns the
        latent float32 [B, H/8, W/8, C], the same on every rank."""
        return self._generate((latents, enc, cap_mask), guidance_scale,
                              num_inference_steps, callback=callback)
