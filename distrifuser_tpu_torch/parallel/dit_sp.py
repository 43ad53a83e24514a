"""Displaced patch parallelism for the DiT: DistriFusion's method on
PixArt-α's transformer, one rank of it (or one device).

Counterpart of distrifuser_tpu/parallel/dit_sp.py (``DiTDenoiseRunner``,
its ``comm_report`` and ``generate``).  LayerNorm, the MLP and the caption
cross-attention act per token, so the self-attention is the only op that
crosses patches: each rank holds a contiguous range of N/n tokens (a
horizontal band of the image) and exchanges only the blocks'
self-attention KV, in one of four layouts (``attn_impl``):

* "gather": synchronous steps (the first ``warmup_steps + 1``, or every
  step under ``full_sync`` or without patches) all-gather every block's
  fresh KV over the patch group and attend over it, exactly; stale steps
  attend over the previous step's gathered KV with this rank's slot
  overwritten fresh and issue the all-gather of its fresh KV
  asynchronously, which the next step consumes (ops/attention.py
  ``displaced_kv``).  The stale refresh takes the comm knobs: int8 / fp8
  payloads with one float32 scale per row of k and one per row of v
  (``comm_compress``, "int8_residual" coding the delta against the
  previous buffer) and one of k strided row groups a step
  (``refresh_fraction`` 1/k, rotating by the absolute step);
* "ring": the peers' chunks stream through ops/ring_attention.py, fresh in
  a synchronous step, the previous step's from the block's buffer in a
  stale one, and the next buffer is the own fresh chunk, so it has no
  refresh collective;
* "ulysses" and "usp": exact and stateless head sharding by all-to-all
  over the patch group, "usp" with an exact ring over the second factor of
  the group (ops/ulysses.py); their stale steps compute what the
  synchronous ones do.

``no_sync`` keeps the warmup's buffers for good.  The buffers are a dict
keyed by block (``blocks.<i>``) that parallel/context.py's
``PatchContext`` hands from step to step, as the UNet runner's.  Under the
step cache (parallel/stepcache.py) a full step also keeps the residual
that the deepest ``step_cache_depth`` blocks added to the image rows
(``STEPCACHE_KEY``), and a shallow step runs only the blocks before the cut
and adds it; the skipped blocks' buffers ride through untouched.  After
the blocks, ``final_layer``'s rows all-gather over the patch group into
the whole epsilon; the CFG branches fold into the batch or split over
ranks (parallel/guidance.py); under ``dp_degree`` each image group
evaluates its share of the batch and the guided outputs gather before the
replicated float32 scheduler step, as the UNet runner does.

Under ``use_cuda_graph`` each phase's evaluation ("sync", "stale",
"shallow") is captured once and replayed (parallel/graphs.py): the token
input, timestep and step are copied into the graph's static inputs before
each replay, the caption KV and mask once per generation, and the buffers
of a phase that reads them are copied back after each replay.

The explicit-carry stepwise API (``stepwise_carry_init`` /
``stepwise_carry_step`` / ``stepwise_carry_latent``; JAX
``parallel/dit_sp.py:680-808``) runs the same per-step evaluations one
step at a time on a carry ``(tokens, buffers, scheduler state)`` the
caller holds, and its rows variants (parallel/runner.py ``StepLoop``)
advance a carry whose rows belong to different requests: the serve
plane's step mode.  A packed step's per-row timesteps embed row by row at
the solo step's shapes (``_t_conditioning``), so each row keeps its bits.

PipeFusion (``parallelism="pipefusion"``) is parallel/pipefusion.py's
runner, which ``DistriPixArtPipeline`` picks; this one refuses it.  What
the JAX runner refuses
(``comm_batch``, a knob of the gather refresh in another layout, head or
token counts the groups do not divide, an image size other than the
config's) the port refuses with the same exception type.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..models import dit as dit_mod
from ..models.dit import DiTConfig, patchify, unpatchify
from ..ops.attention import displaced_kv
from ..ops.ring_attention import ring_attend
from ..ops.ulysses import ulysses_attend, usp_attend
from ..schedulers import BaseScheduler
from ..utils.config import DistriConfig
from .collectives import gather_rows
from .compress import refresh_period, wire_nbytes
from .context import PHASE_STALE, PHASE_SYNC, PatchContext
from .graphs import StepGraphs
from .guidance import branch_select
from .runner import PHASE_SHALLOW, StepLoop, check_graph_transport
from .stepcache import STEPCACHE_KEY


def check_refresh_knobs(cfg: DistriConfig, num_tokens: int, what: str) -> None:
    """The refusals both transformer runners share (ValueError, the JAX
    runners' own): ``comm_batch``, and ``comm_compress`` and
    ``refresh_fraction`` < 1 outside "gather" or on a token chunk that the
    period does not divide; ``what`` names the refreshed KV."""
    if cfg.comm_batch:
        raise ValueError("comm_batch applies to the UNet's per-layer halo/moment "
                         f"exchanges; the {what} path has one collective kind already")
    if cfg.comm_compress != "none" and cfg.attn_impl != "gather":
        raise ValueError(
            f"comm_compress compresses the displaced KV refresh gathers of "
            f"attn_impl='gather'; {cfg.attn_impl!r} has no refresh collective to "
            "compress (ring carries the local chunk; ulysses/usp are exact and "
            "stateless)")
    if cfg.refresh_fraction < 1.0 and cfg.attn_impl != "gather":
        raise ValueError(
            "refresh_fraction < 1 (PCPP) thins the displaced KV refresh gathers of "
            f"attn_impl='gather'; {cfg.attn_impl!r} has no refresh collective to thin")
    n = cfg.n_device_per_batch
    k = refresh_period(cfg.refresh_fraction)
    if k > 1 and num_tokens % n == 0 and (num_tokens // n) % k:
        raise ValueError(f"refresh_fraction=1/{k} needs the per-device token chunk "
                         f"({num_tokens // n}) divisible by {k}")
    if num_tokens % n:
        raise ValueError(f"token count {num_tokens} must be divisible by the sp "
                         f"degree {n}")


def check_dit_config(cfg: DistriConfig, dcfg: DiTConfig) -> None:
    """The JAX runner's refusals (ValueError), then a parallelism other than
    displaced patches (PipeFusion has its own runner)."""
    n = cfg.n_device_per_batch
    if cfg.attn_impl == "ulysses" and dcfg.num_heads % n:
        raise ValueError(f"ulysses needs num_heads ({dcfg.num_heads}) divisible by the "
                         f"sp degree ({n})")
    if cfg.attn_impl == "usp" and dcfg.num_heads % cfg.ulysses_degree:
        raise ValueError(f"usp needs num_heads ({dcfg.num_heads}) divisible by "
                         f"ulysses_degree ({cfg.ulysses_degree})")
    check_refresh_knobs(cfg, dcfg.num_tokens, "DiT")
    if cfg.step_cache_enabled and not 1 <= cfg.step_cache_depth < dcfg.depth:
        raise ValueError(
            f"step_cache_depth={cfg.step_cache_depth} must be in [1, {dcfg.depth - 1}] "
            f"for this {dcfg.depth}-block DiT (at least one block must stay shallow)")
    if cfg.height // 8 != dcfg.sample_size or cfg.width // 8 != dcfg.sample_size:
        raise ValueError(
            f"DistriConfig {cfg.height}x{cfg.width} implies latent {cfg.latent_height}, "
            f"but DiTConfig.sample_size is {dcfg.sample_size}")
    if cfg.parallelism == "pipefusion":
        raise ValueError(
            "parallelism='pipefusion' runs the DiT's blocks as pipeline stages in "
            "PipeFusionRunner (parallel/pipefusion.py), not this displaced patch runner")
    if cfg.parallelism != "patch":
        raise ValueError(f"the DiT runs displaced patch parallelism (parallelism="
                         f"'patch'), not {cfg.parallelism!r}")


class TransformerRunner(StepLoop):
    """The denoising loop both transformer runners share (the DiT's below,
    the MMDiT's of parallel/mmdit_sp.py): one model evaluation a step, the
    first ``warmup_steps + 1`` steps that run synchronous and the rest stale
    (or shallow, under the step cache's cadence), each phase one CUDA graph
    under ``use_cuda_graph``, the step cache's cut, and ``comm_report``
    closed-form from the attention layers that exchange image KV.

    A subclass gives ``_local(x_in, t, cond, phase, state, step)``, one
    evaluation on this rank's token rows from its conditioning ``cond`` (the
    graphs' static ``enc``, ``added`` and ``text_kv``, None where unused)
    at the absolute step index ``step``, ``_inputs`` building the tokens and
    ``cond`` from its call's arguments, ``n_attn`` and ``n_attn_shallow``.
    After ``generate``, ``phase_counts`` holds how many steps ran in each
    phase and ``refresh_wire`` the bytes each phase's last evaluation put on
    the wire by buffer (its stale refreshes).  Replacing ``params`` drops
    the captured graphs."""

    def __init__(self, distri_config: DistriConfig, model_config, params,
                 scheduler: BaseScheduler):
        check_graph_transport(distri_config)
        self.cfg = distri_config
        self.mcfg = model_config
        self.scheduler = scheduler
        self.graphs = StepGraphs(distri_config.device)
        self.params = params
        self.phase_counts: Dict[str, int] = {}
        self.refresh_wire: Dict[str, Dict[str, int]] = {}
        self._schedule: Dict[int, Any] = {}

    @property
    def n_attn(self) -> int:
        """Attention layers a step whose image KV crosses patches."""
        raise NotImplementedError

    @property
    def n_attn_shallow(self) -> int:
        """The same of a shallow step of the step cache."""
        raise NotImplementedError

    @property
    def d_keep(self) -> int:
        """Blocks a shallow step runs (every block without the cache)."""
        cfg = self.cfg
        return self.mcfg.depth - (cfg.step_cache_depth if cfg.step_cache_enabled else 0)

    def _context(self, phase, state, step) -> PatchContext:
        """The patch context of one evaluation of ``phase``: a shallow step
        runs the steady phase's body (stale, or sync where every step is
        synchronous)."""
        cfg = self.cfg
        n = cfg.n_device_per_batch if cfg.is_sp else 1
        if phase == PHASE_SHALLOW:
            phase = PHASE_SYNC if cfg.mode == "full_sync" or n == 1 else PHASE_STALE
        return PatchContext(n=n, mode=cfg.mode, phase=phase, group=cfg.batch_group,
                            split_idx=cfg.split_idx() if n > 1 else 0,
                            attn_impl=cfg.attn_impl, compress=cfg.comm_compress,
                            refresh_fraction=cfg.refresh_fraction, step=step,
                            state_in=state)

    def _run_blocks(self, ctx: PatchContext, phase, h, block):
        """``h`` [Bl, N/n, hidden] through ``block(i, h) -> h`` for every
        block, or under a shallow step the first ``d_keep`` plus the deep
        residual the last full step kept; a full step under the step cache
        keeps ``h_final - h_after_block(d_keep - 1)``, and every step passes
        on the buffers it did not refresh."""
        sc = self.cfg.step_cache_enabled
        shallow = phase == PHASE_SHALLOW
        h_mid = None
        for i in range(self.d_keep if shallow else self.mcfg.depth):
            h = block(i, h)
            if i == self.d_keep - 1:
                h_mid = h
        if shallow:
            h = h + ctx.stale(STEPCACHE_KEY)
        elif sc:
            ctx.emit(STEPCACHE_KEY, h - h_mid, "stepcache")
        if sc:
            ctx.carry_unconsumed()
        return h

    def _finish(self, ctx: PatchContext, phase, out_rows):
        """The end of an evaluation: the step's buffers, its refreshes'
        wire bytes recorded, and the rows gathered into the whole output."""
        state = ctx.finish()
        self.refresh_wire[phase] = dict(ctx.wire)
        if ctx.n == 1:
            return out_rows, state
        return gather_rows(out_rows, self.cfg.batch_group), state

    def _evaluate_at(self, x_in, t, cond, key, state, step):
        return self._local(x_in, t, cond, key, state, step)

    def _evaluate(self, phase, inputs, state):
        """``_local`` on a graph's static inputs."""
        return self._local(inputs.x_in, inputs.t, (inputs.enc, inputs.added, inputs.text_kv),
                           phase, state, inputs.step)

    def _phases(self, end: int, start: int = 0) -> List[str]:
        """The evaluation of each step of ``start .. end - 1``: the first
        ``warmup_steps + 1`` run synchronous (counted from ``start``), the
        rest stale, every step synchronous under ``full_sync`` or without
        patches; under the step cache the steps after the warmup follow the
        shallow-first cadence."""
        keys = []
        for i in range(start, end):
            phase, shallow = self._stepwise_phase(i, start, end)
            keys.append(PHASE_SHALLOW if shallow else phase)
        return keys

    def _reads_state(self, phase) -> bool:
        """Does an evaluation of ``phase`` read the previous step's buffers?
        A shallow one reads the deep residual; a stale one the KV of
        "gather" and "ring" (ulysses and usp keep none)."""
        return phase == PHASE_SHALLOW or (phase == PHASE_STALE
                                          and self.cfg.attn_impl in ("gather", "ring"))

    def _begin_graphs(self, x, cond, phases, start=0) -> None:
        check_graph_transport(self.cfg)
        timesteps, steps = self._step_tensors(self.scheduler.num_inference_steps)
        unique = list(dict.fromkeys(phases))
        self.graphs.begin(tuple(x.shape), self._model_input(x, start), timesteps[start],
                          *cond, unique, [p for p in unique if self._reads_state(p)],
                          self._evaluate, step=steps[start])

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
        sstate = sched.init_state(x.shape)
        self.phase_counts = {PHASE_SYNC: 0, PHASE_STALE: 0}
        if cfg.step_cache_enabled:
            self.phase_counts[PHASE_SHALLOW] = 0
        state = None
        for i, phase in enumerate(phases, start=start_step):
            x, state, sstate = self._advance(x, i, phase, state, sstate, cond, gs, graphed)
            self.phase_counts[phase] += 1
            if callback is not None:
                callback(i, sched.timesteps()[i], unpatchify(mcfg, x, mcfg.in_channels))
        return unpatchify(mcfg, x, mcfg.in_channels)

    def _advance(self, x, i, phase, state, sstate, cond, gs, graphed):
        """Step ``i``: the evaluation ``phase`` (a graph replay when
        ``graphed``), the guidance and the scheduler step: (x, buffers,
        scheduler state); a replay's buffers are the graph's own."""
        timesteps, steps = self._step_tensors(self.scheduler.num_inference_steps)
        x_in = self._model_input(x, i)
        if graphed:
            graph = self.graphs[phase]
            graph.inputs.set_step(x_in, timesteps[i], steps[i])
            if graph.stateful:
                graph.load_state(state)
            out, state = graph.replay(self._evaluate)
        else:
            out, state = self._local(x_in, timesteps[i], cond, phase, state, steps[i])
        x, sstate = self._guided_step(x, out, i, sstate, gs)
        return x, state, sstate

    # -- the explicit-carry stepwise API -----------------------------------

    def stepwise_carry_init(self, latents, num_steps: int):
        """Start a denoise whose carry the caller holds: ``(tokens
        float32 [B, N, D], buffers, scheduler state)``, what one step of
        ``generate`` hands to the next (JAX ``stepwise_carry_init``)."""
        self.scheduler.set_timesteps(num_steps)
        x = patchify(self.mcfg, torch.as_tensor(latents).to(self.cfg.device, torch.float32))
        return x, None, self.scheduler.init_state(x.shape)

    @torch.inference_mode()
    def stepwise_carry_step(self, carry, i: int, enc, extra, gs, num_steps: int):
        """Advance ``carry`` by exactly step ``i`` of a ``num_steps`` run and
        return the new carry (JAX ``stepwise_carry_step``): ``enc`` and
        ``extra`` (the DiT's caption mask, the MMDiT's pooled text) as
        ``generate`` takes them, ``gs`` the guidance scale.  The carry's
        buffers are consumed.  Under ``use_cuda_graph`` the step replays
        the run's graphs and the new carry owns copies of the graph's
        buffers."""
        x, state, sstate = carry
        sched = self.scheduler
        if sched.num_inference_steps != num_steps:
            sched.set_timesteps(num_steps)
        phase, shallow = self._stepwise_phase(i, 0, num_steps)
        key = PHASE_SHALLOW if shallow else phase
        cond = self._cond_of(enc, extra)
        gs = torch.as_tensor(gs, dtype=torch.float32).to(self.cfg.device)
        graphed = self.cfg.use_compiled_step
        if graphed:
            self._begin_graphs(x, cond, self._phases(num_steps), i)
        x, state, sstate = self._advance(x, i, key, state, sstate, cond, gs, graphed)
        if graphed and state is not None:
            state = {k: v.clone() for k, v in state.items()}
        return x, state, sstate

    def stepwise_carry_latent(self, carry):
        """The carry's current latent [B, H/8, W/8, C] (not consumed)."""
        return unpatchify(self.mcfg, carry[0], self.mcfg.in_channels)

    def comm_report(self, batch_size: int = 1) -> Dict[str, Any]:
        """This rank's stale-state elements and per-step collective volumes
        of the configured layout, closed-form from the architecture, as the
        JAX runners' ``comm_report`` gives them (the same keys and numbers):
        the stale refresh's wire bytes with its compression and partial
        refresh, and under the step cache a shallow step's elements."""
        cfg, mcfg = self.cfg, self.mcfg
        step_cache = None
        if cfg.step_cache_enabled:
            step_cache = {"interval": cfg.step_cache_interval,
                          "depth": cfg.step_cache_depth,
                          "shallow_per_step_collective_elems": 0}
        if not cfg.is_sp:
            report = {"layout": cfg.attn_impl, "kv_state_elems": 0,
                      "per_step_collective_elems": 0, "per_step_collective_bytes": 0,
                      "sync_step_collective_bytes": 0}
            if step_cache:
                report["step_cache"] = step_cache
            return report
        n = cfg.n_device_per_batch
        b = batch_size * (1 if cfg.cfg_split or not cfg.do_classifier_free_guidance else 2)
        n_tok, hid, n_attn = mcfg.num_tokens, mcfg.hidden_size, self.n_attn
        chunk = n_tok // n
        out_gather = b * n_tok * mcfg.patch_size ** 2 * mcfg.out_channels
        if cfg.attn_impl == "gather":
            state = n_attn * 2 * b * n_tok * hid
            per_step = n_attn * 2 * b * n_tok * hid + out_gather
        elif cfg.attn_impl == "ring":  # (n - 1) hops of the own 2C chunk a layer
            state = n_attn * b * chunk * 2 * hid
            per_step = n_attn * (n - 1) * b * chunk * 2 * hid + out_gather
        elif cfg.attn_impl == "ulysses":  # q, k, v out and the output back
            state = 0
            per_step = n_attn * b * chunk * hid * 4 + out_gather
        else:  # usp: the all-to-alls over sp_u, (r - 1) ring hops over sp_r
            u = cfg.ulysses_degree
            r = n // u
            state = 0
            a2a = n_attn * b * chunk * hid * 4 if u > 1 else 0
            per_step = (a2a + n_attn * (r - 1) * b * (chunk * u) * 2 * hid // u
                        + out_gather)
        itemsize = cfg.dtype.itemsize
        report = {"layout": cfg.attn_impl, "kv_state_elems": int(state),
                  "per_step_collective_elems": int(per_step),
                  "comm_compress": cfg.comm_compress,
                  "refresh_fraction": cfg.refresh_fraction,
                  "sync_step_collective_bytes": int(per_step) * itemsize}
        if cfg.attn_impl == "gather":
            k = refresh_period(cfg.refresh_fraction)
            refresh = n_attn * n * wire_nbytes((2, b, chunk // k, hid), itemsize,
                                               cfg.comm_compress)
            full = n_attn * n * wire_nbytes((2, b, chunk, hid), itemsize, cfg.comm_compress)
            report["per_step_collective_bytes"] = int(refresh + out_gather * itemsize)
            report["full_refresh_per_step_collective_bytes"] = int(
                full + out_gather * itemsize)
        else:
            report["per_step_collective_bytes"] = int(per_step) * itemsize
            report["full_refresh_per_step_collective_bytes"] = int(per_step) * itemsize
        if step_cache:
            step_cache["shallow_per_step_collective_elems"] = int(
                (per_step - out_gather) * self.n_attn_shallow // n_attn + out_gather)
            report["step_cache"] = step_cache
        return report


class DiTDenoiseRunner(TransformerRunner):
    """The denoising loop of one (config, DiT, scheduler) on this rank."""

    def __init__(self, distri_config: DistriConfig, dit_config: DiTConfig, params,
                 scheduler: BaseScheduler):
        check_dit_config(distri_config, dit_config)
        super().__init__(distri_config, dit_config, params, scheduler)

    @property
    def n_attn(self) -> int:
        return self.mcfg.depth

    @property
    def n_attn_shallow(self) -> int:
        return self.d_keep

    def _attn_hooks(self, ctx: PatchContext, name: str):
        """Block ``name``'s self-attention under the configured layout (at
        more than one rank)."""
        cfg, heads = self.cfg, self.mcfg.num_heads
        if cfg.attn_impl == "ring":
            return {"attn_core": lambda q, kv: ring_attend(q, kv, ctx, name, heads=heads)}
        if cfg.attn_impl == "ulysses":
            return {"attn_core": lambda q, kv: ulysses_attend(q, kv, cfg.batch_group,
                                                              heads=heads)}
        if cfg.attn_impl == "usp":
            u = cfg.ulysses_degree
            return {"attn_core": lambda q, kv: usp_attend(
                q, kv, cfg.sp_u_group, cfg.sp_r_group, u, ctx.n // u, heads=heads)}
        return {"kv_assemble": lambda kv: displaced_kv(kv, ctx, name, halves=2)}

    def _t_conditioning(self, t):
        """(timestep embedding, adaLN table) of ``t``: a scalar gives
        ([hidden], [6, hidden]); one timestep a row (a packed step) gives
        ([Bl, hidden], [Bl, 6, hidden]), each row embedded alone at the
        scalar's shapes, so its values are the solo step's bits."""
        dcfg, params = self.mcfg, self.params
        if t.dim() == 0:
            temb = dit_mod.t_embed(params, dcfg, t)
            return temb, dit_mod.adaln_table(params, dcfg, temb)
        rows = [dit_mod.t_embed(params, dcfg, tr) for tr in t]
        return (torch.stack(rows),
                torch.stack([dit_mod.adaln_table(params, dcfg, r) for r in rows]))

    def _local(self, x_in, t, cond, phase, state, step=None):
        """One DiT evaluation on this rank's token rows of ``x_in`` [Bl, N,
        D] (scaled, the CFG branches folded) from ``cond`` = (caption bias,
        None, the blocks' caption KV) at the absolute step ``step`` (which
        a partial refresh rotates by; ``t`` a scalar or one timestep a
        row): (the whole epsilon [Bl, N, D_out], the next step's
        buffers)."""
        dcfg, params = self.mcfg, self.params
        cap_bias, _, cap_kv = cond
        dtype = params["proj_in"]["kernel"].dtype
        ctx = self._context(phase, state, step)
        chunk = dcfg.num_tokens // ctx.n
        offset = ctx.split_idx * chunk
        rows = x_in[:, offset:offset + chunk].to(dtype)
        pos = dit_mod.pos_embed_table(dcfg, dtype, x_in.device)[offset:offset + chunk]
        h = dit_mod.embed_tokens(params, dcfg, rows, pos)
        temb, c6 = self._t_conditioning(t)

        def block(i, h):
            hooks = self._attn_hooks(ctx, f"blocks.{i}") if ctx.n > 1 else {}
            return dit_mod.dit_block(params["blocks"][i], dcfg, h, c6, cap_kv[i],
                                     cap_bias=cap_bias, **hooks)[0]

        h = self._run_blocks(ctx, phase, h, block)
        return self._finish(ctx, phase, dit_mod.final_layer(params, dcfg, h, temb))

    _family = "dit"

    def _inputs(self, latents, enc, cap_mask):
        """(the latent's tokens float32 [B, N, D], ``_cond_of``) from the
        latents, branch-major ``enc`` and ``cap_mask``."""
        dev = self.cfg.device
        x = dit_mod.patchify(self.mcfg, torch.as_tensor(latents).to(dev, torch.float32))
        return x, self._cond_of(enc, cap_mask)

    def _cond_of(self, enc, cap_mask):
        """(this rank's caption bias [Bl, 1, 1, Lt], None, the blocks'
        caption KV) from branch-major ``enc`` [n_br, B, Lt, caption_dim]
        and ``cap_mask`` [n_br, B, Lt] (None: every token real)."""
        cfg = self.cfg
        dev = cfg.device
        enc = torch.as_tensor(enc).to(dev)
        mask = (torch.ones(enc.shape[:3], device=dev) if cap_mask is None
                else torch.as_tensor(cap_mask).to(dev).float())
        my_enc, _, _ = branch_select(cfg, self._my_images(enc, dim=1))
        my_mask, _, _ = branch_select(cfg, self._my_images(mask, dim=1))
        cap_kv = dit_mod.precompute_caption_kv(self.params, self.mcfg, my_enc)
        return dit_mod.caption_mask_bias(my_mask), None, cap_kv

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
